"""The frozen-soil surface solve on one NVIDIA GPU: one K7 call
(`kernels.fd_surface_brent`) and one K6 call (`kernels.node_sweep`), each
split into device time by kernel, host time of the wrapper and device idle
time between launches.

    cd <checkout> && python3 <path>/tools/profile_fd_surface.py
        [--cells 32768] [--heavy-cells 8192] [--reps 5] [--out FILE.json]

Like tools/time_node_sweep.py it builds and imports the kernels,
`vic_tpu_torch` and `chip_smoke` of the checkout it is run from, so two
trees are compared on one card by running it from each root in turn.
Cases, each on the arguments of the kernel's first call in that step
(`chip_smoke.capture_kernel_args`):

- K7 in frozen_exp's third record (10 EXP_TRANS nodes) and in frozen's
  third record (5 linear nodes), `--cells` cells;
- K6 in frozen_exp's third record (the profile at the surface root the
  step's energy terms take), `--cells` cells, and K6 as the lower probe of
  heavy_nolakes' first CLOSE_ENERGY pass in its fourth record,
  `--heavy-cells` cells.

For each: the wrapper's host time (call to return, no synchronize) and
the call's (call to synchronize), medians of `--reps` calls after a
warm-up, and CUDA-event milliseconds a call over `--reps` calls back to
back; then one call of each case in one torch.profiler session, each in a
range of its own: device time and count of every kernel, memset and copy
that a call in its range launched, their sum (busy), the span from the first device event's
start to the last one's end, and idle = span - busy (one stream, so
device events do not overlap). K7 also gives its Brent trips
and its profile solves (K6 calls on the old host loop, the count the
kernel returns on the cooperative one).

Prints the card's name and power limit and, as its last line, one JSON
object with every number (also written to --out).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.getcwd())


def _host_ms(fn, reps):
    import torch
    wrapper, call = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        wrapper.append((t1 - t0) * 1e3)
        call.append((t2 - t0) * 1e3)
    return statistics.median(wrapper), statistics.median(call)


def _event_ms(fn, reps):
    """CUDA-event milliseconds a call, over `reps` calls."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _profiled(calls):
    """One call of each of `calls` ({label: fn}) in one torch.profiler
    session, each inside a record_function range of its label and ending
    in a synchronize: ({label: result}, {label: device numbers}), the
    device events (kernels, memsets, copies) read from the exported trace
    and given to the range they start in."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, record_function
    outs = {}
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        for label, fn in calls.items():
            with record_function(label):
                outs[label] = fn()
                torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    ranges = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("ph") == "X" and e.get("name") in calls
              and e.get("cat") == "user_annotation"}
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in
           ("kernel", "gpu_memset", "gpu_memcpy")]
    # a device event belongs to the range of the host call that launched
    # it (same correlation id, from a runtime or a driver API call): the
    # device's and the host's clocks are not aligned closely enough to
    # place it by its own start. With one range, every device event of the
    # session is its (the session runs that call alone, between
    # synchronizations), whatever its launch was recorded as.
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("ph") == "X"
                and e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    only = next(iter(ranges.values()))[0] if len(ranges) == 1 else None

    def host_ts(e):
        ts = launched.get(e.get("args", {}).get("correlation"))
        if ts is None:
            ts = e["ts"] if only is None else only
        return ts

    numbers = {}
    for label in calls:
        lo, hi = ranges[label]
        mine = [e for e in dev if lo <= host_ts(e) <= hi]
        by_name = {}
        for e in mine:
            entry = by_name.setdefault(e["name"][:80], {"ms": 0.0,
                                                         "count": 0})
            entry["ms"] += e["dur"] / 1e3
            entry["count"] += 1
        busy = sum(v["ms"] for v in by_name.values())
        span = ((max(e["ts"] + e["dur"] for e in mine)
                 - min(e["ts"] for e in mine)) / 1e3 if mine else 0.0)
        numbers[label] = {
            "device_events": len(mine), "device_busy_ms": busy,
            "device_span_ms": span, "device_idle_ms": span - busy,
            "by_kernel": dict(sorted(by_name.items(),
                                     key=lambda kv: -kv[1]["ms"]))}
    return outs, numbers


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", type=int, default=32768)
    ap.add_argument("--heavy-cells", type=int, default=8192)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import chip_smoke
    from vic_tpu_torch import kernels

    device = chip_smoke.device_phase()
    chip_smoke.build_phase()
    cases = (("fd_surface_brent", "frozen_exp", chip_smoke.FROZEN_RECORD,
              args.cells),
             ("fd_surface_brent", "frozen", chip_smoke.FROZEN_RECORD,
              args.cells),
             ("node_sweep", "frozen_exp", chip_smoke.FROZEN_RECORD,
              args.cells),
             ("node_sweep", "heavy_nolakes", chip_smoke.HEAVY_RECORD,
              args.heavy_cells))
    result = {"card": chip_smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]}
    calls = {}
    for name, config, record, cells in cases:
        (a, kw), = chip_smoke.capture_kernel_args(
            config, (name,), device, record=record, cells=cells).values()
        fn = getattr(kernels, name)

        def call(fn=fn, a=a, kw=kw):
            return fn(*a, **kw)

        call()
        wrapper_ms, call_ms = _host_ms(call, args.reps)
        label = f"{name}/{config}"
        calls[label] = call
        result[label] = {"cells": cells, "wrapper_host_ms": wrapper_ms,
                         "call_ms": call_ms,
                         "cuda_event_ms": _event_ms(call, args.reps)}
    sweeps_before = kernels.launches["node_sweep"]
    outs, prof = _profiled(calls)
    for label, out in outs.items():
        case = result[label]
        case.update(prof[label])
        if label.startswith("fd_surface_brent"):
            solves = getattr(out, "solves", None)
            case["brent_trips"] = int(out.iterations)
            # the old host loop's solves were K6 calls (its only ones in
            # the profiled session)
            case["profile_solves"] = (
                int(solves) if solves is not None
                else kernels.launches["node_sweep"] - sweeps_before)
        else:
            case["sweeps"] = int(out.iterations)
        print(f"  {label}: wrapper {case['wrapper_host_ms']:.4f} ms on the "
              f"host, call {case['call_ms']:.4f} ms, CUDA events "
              f"{case['cuda_event_ms']:.4f} ms, device busy "
              f"{case['device_busy_ms']:.4f} ms in {case['device_events']} "
              f"events, idle {case['device_idle_ms']:.4f} ms", flush=True)
    text = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
