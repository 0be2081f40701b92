"""Reading a traced run: the device's operations from torch.profiler's
timeline, the host's spans, and the arithmetic the per-layer metrics share
(interval union, idle gaps, a percentile over all records).

The functions below `events_of` take plain tuples, so the tests can drive
them with synthetic traces.
"""
from __future__ import annotations

import bisect
import math
import re
from dataclasses import dataclass, field
from pathlib import Path

SPAN_PREFIX = "bench."            # the harness's own spans
KERNEL_SPAN = "bench.kernel"      # around a counted kernel call
COPY_PREFIXES = ("Memcpy", "Memset")
# host events of the profiler's own work: it fetches buffers for its
# records while the program waits
PROFILER_HOST = ("Activity Buffer Request",)


@dataclass
class DeviceOp:
    name: str
    start_ns: int
    end_ns: int


@dataclass
class HostEvent:
    name: str
    start_ns: int
    end_ns: int


@dataclass
class Trace:
    """What a traced run hands the per-layer metrics' readers.

    records: records stepped in the spanned part of the window;
    step_host_s: host seconds inside each step call there; record_ms: each
    of those records' device interval (CUDA events after consecutive step
    calls, a block's first from the block's start); profiled_records:
    records stepped under the profiler; ops: the device operations of the
    profiled part; window_ns: its (start, end) on the profiler's clock;
    port_kernels: the names of the program's own kernel functions;
    roofline: (the bound seconds of the profiled part's countable kernel
    calls, the names of the program's kernels those calls launch), or
    None."""
    records: int = 0
    step_host_s: list = field(default_factory=list)
    record_ms: list = field(default_factory=list)
    profiled_records: int = 0
    ops: list = field(default_factory=list)
    host: list = field(default_factory=list)
    window_ns: tuple = (0, 0)
    port_kernels: frozenset = frozenset()
    roofline: tuple = None


def port_kernel_names(csrc: Path) -> frozenset:
    """The `__global__` function names of the program's CUDA sources."""
    names = set()
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*"
                     r"\)\s*)?(\w+)\s*\(", re.S)
    for p in sorted(csrc.glob("*.cu*")):
        names.update(pat.findall(p.read_text()))
    return frozenset(names)


def span_ops(ops, host, span: str):
    """The ops whose middle lies inside a host event named `span` (spans
    that wait for the device at both ends hold exactly their own ops)."""
    spans = merged([(e.start_ns, e.end_ns) for e in host if e.name == span])
    starts = [a for a, _ in spans]
    out = []
    for o in ops:
        mid = (o.start_ns + o.end_ns) // 2
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and mid < spans[i][1]:
            out.append(o)
    return out


def profiler_idle_ns(trace) -> int:
    """The idle time of the profiled window in which the host was in the
    profiler's own work (PROFILER_HOST): the profiler's cost, not the
    program's."""
    lo, hi = trace.window_ns
    own = merged([(e.start_ns, e.end_ns) for e in trace.host
                  if e.name in PROFILER_HOST], lo, hi)
    gaps = idle_gaps([(o.start_ns, o.end_ns) for o in trace.ops], lo, hi)
    total = 0
    for a, b in gaps:
        for c, d in own:
            total += max(0, min(b, d) - max(a, c))
    return total


def is_copy(name: str) -> bool:
    return name.startswith(COPY_PREFIXES)


def is_port_kernel(name: str, port: frozenset) -> bool:
    """Whether a device operation's name is one of the program's kernel
    functions (a demangled name such as `void lane_brent_kernel<...>(...)`
    holds the function's name as a whole word before its arguments)."""
    if is_copy(name):
        return False
    head = name.split("(", 1)[0]
    return any(re.search(rf"\b{re.escape(k)}\b", head) for k in port)


def events_of(prof):
    """(device ops, host events) of a finished torch.profiler session, on
    the profiler's clock in ns."""
    from torch.autograd import DeviceType
    ops, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
        dur = (e.duration_ns() if hasattr(e, "duration_ns")
               else e.duration_us() * 1000)
        if e.device_type() == DeviceType.CUDA:
            # the harness's own spans are mirrored on the device's
            # timeline as annotations: they are not device work
            if not e.name().startswith(SPAN_PREFIX):
                ops.append(DeviceOp(e.name(), start, start + dur))
        else:
            host.append(HostEvent(e.name(), start, start + dur))
    return ops, host


def union_ns(intervals, lo=None, hi=None) -> int:
    """Length of the union of [start, end) intervals, clipped to [lo, hi)."""
    segs = merged(intervals, lo, hi)
    return sum(b - a for a, b in segs)


def merged(intervals, lo=None, hi=None):
    """The union of [start, end) intervals as sorted disjoint segments,
    clipped to [lo, hi)."""
    out = []
    for a, b in sorted(intervals):
        if lo is not None:
            a = max(a, lo)
        if hi is not None:
            b = min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(s) for s in out]


def idle_gaps(intervals, lo, hi):
    """The gaps of [lo, hi) where no interval runs, as (start, end)."""
    gaps, at = [], lo
    for a, b in merged(intervals, lo, hi):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if hi > at:
        gaps.append((at, hi))
    return gaps


def percentile(values, q: float) -> float:
    """The q-th percentile of all the values by the nearest rank (the
    smallest value with at least q% of the values at or below it)."""
    vals = sorted(values)
    if not vals:
        raise ValueError("percentile of no values")
    rank = max(1, math.ceil(q / 100.0 * len(vals)))
    return vals[rank - 1]


def host_label(host, t_ns: int) -> str:
    """What the host was doing at t_ns: the innermost of the harness's
    spans and the innermost other host event covering it."""
    span = op = None
    for e in host:
        if e.start_ns <= t_ns < e.end_ns:
            if e.name.startswith(SPAN_PREFIX):
                if span is None or e.start_ns >= span.start_ns:
                    span = e
            elif op is None or e.start_ns >= op.start_ns:
                op = e
    parts = [x.name for x in (span, op) if x is not None]
    return " / ".join(parts) if parts else "outside every host event"


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took the most time (summed by name) and
    the longest idle gaps of the profiled window, each labelled with what
    the host was doing in its middle; seconds."""
    by_name = {}
    for op in trace.ops:
        by_name[op.name] = by_name.get(op.name, 0) + op.end_ns - op.start_ns
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    lo, hi = trace.window_ns
    gaps = sorted(idle_gaps([(o.start_ns, o.end_ns) for o in trace.ops],
                            lo, hi), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n[:200], ns / 1e9] for n, ns in ops],
            "idle_gaps": [[host_label(trace.host, (a + b) // 2)[:200],
                           (b - a) / 1e9] for a, b in gaps]}
