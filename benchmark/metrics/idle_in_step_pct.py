"""Of the profiled window's device idle time, the share that lies inside
the program's vic.step spans, in % (device layer); the rest is the
caller's time between step calls. The idle time in which the host was in
the profiler's own work is left out of both, as device_idle_pct does."""
from benchmark.program_spans import (host_segments, idle_segments,
                                     intersect, length, step_segments)
from benchmark.timeline import PROFILER_HOST


def read(t):
    steps = step_segments(t)
    if steps is None:
        return None
    gaps, own = idle_segments(t)
    idle = length(gaps) - own
    if idle <= 0:
        return None
    in_step = intersect(gaps, steps)
    own_in_step = intersect(in_step, host_segments(
        t, lambda n: n in PROFILER_HOST))
    return 100.0 * (length(in_step) - length(own_in_step)) / idle
