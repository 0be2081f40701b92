"""Host ms a record inside the program's vic.kernel.* spans, over the
profiled window (kernels layer): the wrappers' host side, checks, lane
tables, allocations, launches and votes."""
from benchmark.program_spans import (kernel_segments, length, per_record_ms,
                                     step_segments)


def read(t):
    if step_segments(t) is None or not t.profiled_records:
        return None
    return per_record_ms(t, length(kernel_segments(t)))
