"""Host ms a record inside the program's vic.step spans that the host
spends in CUDA runtime calls (host events named cuda*: launches,
allocations, copies, synchronisations), over the profiled window (model
step layer): the time it waits on the device and its allocator."""
from benchmark.program_spans import (intersect, length, per_record_ms,
                                     runtime_segments, step_segments)


def read(t):
    steps = step_segments(t)
    if steps is None or not t.profiled_records:
        return None
    return per_record_ms(t, length(intersect(steps, runtime_segments(t))))
