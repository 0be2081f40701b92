"""Host ms a record inside the program's vic.step spans and outside its
vic.kernel.* spans, over the profiled window (physics glue layer): the
Python and PyTorch work of the step around the kernel wrappers."""
from benchmark.program_spans import (intersect, kernel_segments, length,
                                     per_record_ms, step_segments)


def read(t):
    steps = step_segments(t)
    if steps is None or not t.profiled_records:
        return None
    ns = length(steps) - length(intersect(steps, kernel_segments(t)))
    return per_record_ms(t, ns)
