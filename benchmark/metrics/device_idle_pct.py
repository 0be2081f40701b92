"""The share of the profiled window in which no operation ran on the
device, in % (device layer). Idle time in which the host was in the
profiler's own work (timeline.PROFILER_HOST) is left out of both the idle
time and the window."""
from benchmark.timeline import profiler_idle_ns, union_ns


def read(t):
    lo, hi = t.window_ns
    if hi <= lo or not t.ops:
        return None
    busy = union_ns([(o.start_ns, o.end_ns) for o in t.ops], lo, hi)
    own = profiler_idle_ns(t)
    return 100.0 * (1.0 - busy / (hi - lo - own))
