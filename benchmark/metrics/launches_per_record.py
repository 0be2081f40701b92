"""Device kernel launches a record under the profiler, copies and fills
left out (device layer)."""
from benchmark.timeline import is_copy


def read(t):
    if not t.profiled_records or not t.ops:
        return None
    return sum(not is_copy(o.name) for o in t.ops) / t.profiled_records
