"""The cost of the program's span sites with no profiler recording: each
form of vic_tpu_torch.trace's off path timed over many calls on the host's
clock, less an empty loop's, in microseconds a call.

    python3 tools/time_span_off.py [--calls 200000] [--repeats 5]

Forms: a `with trace.span(..)`, a `with trace.phases()` context, a phase
cursor's call, a call through a `trace.kernel` wrapper less the bare call,
and `trace.count` (the host counter, always on). Prints one JSON object:
the median over the repeats of each form.
"""
import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.getcwd())

from vic_tpu_torch import trace  # noqa: E402


def per_call_us(body, calls):
    t0 = time.perf_counter()
    body(calls)
    return (time.perf_counter() - t0) / calls * 1e6


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=200000)
    ap.add_argument("--repeats", type=int, default=5)
    a = ap.parse_args()
    assert not trace._profiler._is_profiler_enabled

    def bare():
        return None
    wrapped = trace.kernel("time_span_off")(bare)
    ph = trace.phases()

    def empty(n):
        for _ in range(n):
            pass

    def span(n):
        for _ in range(n):
            with trace.span("vic.step"):
                pass

    def phases(n):
        for _ in range(n):
            with trace.phases():
                pass

    def phase_call(n):
        for _ in range(n):
            ph("vic.step.forcing")

    def kernel_call(n):
        for _ in range(n):
            wrapped()

    def bare_call(n):
        for _ in range(n):
            bare()

    def count(n):
        for _ in range(n):
            trace.count("records", 0)

    forms = dict(span=span, phases=phases, phase_call=phase_call,
                 kernel_call=kernel_call, count=count)
    runs = {k: [] for k in forms}
    for _ in range(a.repeats):
        base = per_call_us(empty, a.calls)
        base_call = per_call_us(bare_call, a.calls)
        for k, body in forms.items():
            less = base_call if k == "kernel_call" else base
            runs[k].append(per_call_us(body, a.calls) - less)
    print(json.dumps({k: statistics.median(v) for k, v in runs.items()}))


if __name__ == "__main__":
    main()
