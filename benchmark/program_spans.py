"""The program's own spans in a traced run, for the per-layer metrics that
read them: the host events vic_tpu_torch.trace opens (vic.step around each
step call, vic.kernel.<name> around each kernel wrapper's call), on the
profiler's clock. A program without them (an older checkout) has no
vic.step event, and each reader then returns None.

Device operations named vic.* are left out wherever device time is read:
the program's spans are function-scope records, which the profiler does
not mirror onto the device's timeline, and a mirror would not be device
work."""
from __future__ import annotations

import dataclasses

from benchmark.timeline import idle_gaps, merged, profiler_idle_ns

STEP = "vic.step"
KERNEL_PREFIX = "vic.kernel."
PROGRAM_PREFIX = "vic."
# host events of CUDA runtime calls (launches, allocations, copies,
# synchronisations)
RUNTIME_PREFIX = "cuda"


def host_segments(t, pred):
    """The union of the host events whose name `pred` accepts, clipped to
    the profiled window, as sorted disjoint (start, end) segments."""
    lo, hi = t.window_ns
    return merged([(e.start_ns, e.end_ns) for e in t.host if pred(e.name)],
                  lo, hi)


def step_segments(t):
    """The vic.step spans in the window, or None where there is none."""
    segs = host_segments(t, lambda n: n == STEP)
    return segs or None


def kernel_segments(t):
    return host_segments(t, lambda n: n.startswith(KERNEL_PREFIX))


def runtime_segments(t):
    return host_segments(t, lambda n: n.startswith(RUNTIME_PREFIX))


def intersect(a, b):
    """The intersection of two lists of sorted disjoint segments."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo < hi:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def length(segs) -> int:
    return sum(b - a for a, b in segs)


def device_only(t):
    """The trace with the device operations named vic.* left out."""
    return dataclasses.replace(t, ops=[o for o in t.ops if not
                                       o.name.startswith(PROGRAM_PREFIX)])


def idle_segments(t):
    """(the profiled window's device idle gaps, the profiler's own idle
    time in ns: gaps in which the host was in the profiler's work), device
    operations named vic.* left out."""
    t = device_only(t)
    lo, hi = t.window_ns
    gaps = idle_gaps([(o.start_ns, o.end_ns) for o in t.ops], lo, hi)
    return gaps, profiler_idle_ns(t)


def per_record_ms(t, ns):
    return ns / 1e6 / t.profiled_records
