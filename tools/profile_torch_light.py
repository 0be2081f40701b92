"""Where the host and the device spend a record of the port's step, phase
by phase, from the program's own spans (vic_tpu_torch.trace).

    python tools/profile_torch_light.py [--config NAME] [--cells 32768]
                                        [--workload CELL] [--seed 1]
                                        [--records 2] [--stub-spans]
                                        [--device cuda|cpu] [--out FILE.json]

NAME is any name of vic_tpu_torch.entry.CONFIGS (light by default), run
at --cells cells after one warm-up record; or CELL, a cell of the
benchmark (BENCHMARK.json's workloads), its domain and forcing made from
--seed as benchmark/run.py makes them, after one warm-up block, from its
initial state. Then `--records` records run in one torch.profiler session
(host and device activity), one step call a record as the driver makes
them. For each span name (vic.step, its phases vic.step.*, the column's
phases, vic.kernel.<name>) and a record, it reports: the calls; host ms
inside the span and its self ms (less its child spans); the host ms of
the CUDA runtime calls whose innermost span it is, by call name
(cudaLaunchKernel, cudaMalloc, cudaMemcpyAsync, ...); and the device
operations those calls launched (tied by the profiler's correlation ids):
their count (copies and fills apart) and device ms. Runtime calls outside
every span are reported under "outside". Also the host ms of each step
call on the host's clock, which holds the spans' own cost, and the change
of each of the program's counters (trace.counters(): records,
close_energy_passes, K7's Brent trips, profile solves and sweeps, K6's own
sweeps, the launches of each kernel) over the profiled records, a record.

--stub-spans replaces the program's record (trace._Record) with the no-op
span for the session, so the step's host ms can be compared with the
spans recording and without; the per-span rows are then empty.

Prints one JSON object (also written to --out) with the card's name and
power limit. Runs on the CUDA device and refuses to run without one;
`--device cpu` runs the plain path on the CPU (host rows only, not the
card's times). Imports the `vic_tpu_torch` of the directory it is run from,
so two checkouts compare on one card when it is run from each root.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.getcwd())

from vic_tpu_torch import trace  # noqa: E402
from vic_tpu_torch.entry import CONFIGS  # noqa: E402
from vic_tpu_torch.model import make_step  # noqa: E402

PROGRAM = "vic."
RUNTIME = "cuda"
COPIES = ("Memcpy", "Memset")


def record(stack, i):
    return {k: v[i] for k, v in stack.items()}


def from_config(config, n_cell, n_rec, device):
    """(step, state, the forcing of each record to profile)."""
    gp, params, stack, state, extras = CONFIGS[config](n_cell, n_rec + 1,
                                                       device)
    step = make_step(params, gp, **extras)
    state, _ = step(state, record(stack, 0))
    return step, state, [record(stack, i) for i in range(1, n_rec + 1)]


def from_workload(name, seed, n_rec, device):
    """As from_config, for a cell of the benchmark."""
    from benchmark import gen, harness
    _, _, cfg, traffic = harness.cell_spec(name)
    cell = harness.Cell(cfg, traffic, gen.cell_domain(cfg, traffic, seed),
                        gen.cell_forcing(cfg, traffic, seed), device, {})
    cell.block()
    return (cell.step, harness.clone_state(cell.init),
            [record(cell.stack, i) for i in range(n_rec)])


def run_profiled(step, state, forcings, device, stub):
    """(kineto events, host seconds of each profiled step call, the
    change of each counter that moved)."""
    from torch.profiler import ProfilerActivity, profile
    sync(device)
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    saved = trace._Record
    if stub:
        trace._Record = lambda name: trace._OFF
    host_s = []
    counts0 = trace.counters()
    try:
        with profile(activities=acts) as prof:
            for forcing in forcings:
                t0 = time.perf_counter()
                state, _ = step(state, forcing)
                host_s.append(time.perf_counter() - t0)
            sync(device)
    finally:
        trace._Record = saved
    counts = trace.counters()
    moved = {k: v - counts0[k] for k, v in counts.items() if v != counts0[k]}
    return list(prof.profiler.kineto_results.events()), host_s, moved


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def breakdown(events, n_rec):
    """The per-span rows (see the module's docstring), a record each."""
    from torch.autograd import DeviceType
    spans, runtime, ops = [], [], []
    for e in events:
        name, start = e.name(), e.start_ns()
        item = (start, start + e.duration_ns(), name, e.correlation_id(),
                e.start_thread_id())
        if e.device_type() == DeviceType.CUDA:
            if not name.startswith(PROGRAM) and not e.is_user_annotation():
                ops.append(item)
        elif name.startswith(PROGRAM):
            spans.append(item)
        elif name.startswith(RUNTIME):
            runtime.append(item)
    rows = collections.defaultdict(lambda: {
        "calls": 0, "host_ns": 0, "self_ns": 0,
        "runtime_ns": collections.Counter(), "launches": 0, "copies": 0,
        "device_ns": 0})
    # each span's parent and each runtime call's innermost span, by a sweep
    # over the host events of each thread in start order
    owner = {}
    by_thread = collections.defaultdict(list)
    for i, s in enumerate(spans):
        by_thread[s[4]].append((s[0], -s[1], 0, i))
    for i, r in enumerate(runtime):
        by_thread[r[4]].append((r[0], -r[1], 1, i))
    for items in by_thread.values():
        open_spans = []
        for start, neg_end, kind, i in sorted(items):
            while open_spans and spans[open_spans[-1]][1] <= start:
                open_spans.pop()
            inner = spans[open_spans[-1]][2] if open_spans else "outside"
            if kind:
                rows[inner]["runtime_ns"][runtime[i][2]] += -neg_end - start
                owner[runtime[i][3]] = inner
                continue
            row = rows[spans[i][2]]
            row["calls"] += 1
            row["host_ns"] += -neg_end - start
            row["self_ns"] += -neg_end - start
            if open_spans:
                rows[spans[open_spans[-1]][2]]["self_ns"] -= -neg_end - start
            open_spans.append(i)
    for start, end, name, corr, _ in ops:
        row = rows[owner.get(corr, "outside")]
        row["copies" if name.startswith(COPIES) else "launches"] += 1
        row["device_ns"] += end - start
    out = {}
    for name, r in sorted(rows.items()):
        out[name] = {
            "calls": r["calls"] / n_rec,
            "host_ms": r["host_ns"] / 1e6 / n_rec,
            "host_self_ms": r["self_ns"] / 1e6 / n_rec,
            "runtime_ms": {k: v / 1e6 / n_rec for k, v in
                           r["runtime_ns"].most_common()},
            "launches": r["launches"] / n_rec,
            "copies": r["copies"] / n_rec,
            "device_ms": r["device_ns"] / 1e6 / n_rec}
    return out


def table(rows):
    """The rows as aligned text, by span name."""
    lines = [f"{'span':34} {'calls':>7} {'host':>9} {'self':>9} "
             f"{'runtime':>9} {'launch':>8} {'device':>9}  top runtime"]
    for name, r in rows.items():
        rt = sum(r["runtime_ms"].values())
        top = ", ".join(f"{k} {v:.2f}" for k, v in
                        list(r["runtime_ms"].items())[:2])
        lines.append(f"{name:34} {r['calls']:7.2f} {r['host_ms']:9.3f} "
                     f"{r['host_self_ms']:9.3f} {rt:9.3f} "
                     f"{r['launches']:8.1f} {r['device_ms']:9.3f}  {top}")
    return "\n".join(lines)


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", choices=tuple(CONFIGS), default="light")
    ap.add_argument("--cells", type=int, default=32768)
    ap.add_argument("--workload", default=None)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--records", type=int, default=2)
    ap.add_argument("--stub-spans", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if a.device == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: these rows would not be the card's "
                 "(--device cpu runs the plain path on the CPU)")
    device = (torch.device("cuda", torch.cuda.current_device())
              if a.device == "cuda" else torch.device("cpu"))
    made = (from_workload(a.workload, a.seed, a.records, device)
            if a.workload else from_config(a.config, a.cells, a.records,
                                           device))
    events, host_s, moved = run_profiled(*made, device, a.stub_spans)
    rows = breakdown(events, a.records)
    print(table(rows), file=sys.stderr)
    counters = {k: v / a.records for k, v in sorted(moved.items())}
    print("counters a record: " + json.dumps(counters), file=sys.stderr)
    result = {"card": card() if device.type == "cuda" else "cpu",
              "config": a.config, "cells": a.cells, "workload": a.workload,
              "seed": a.seed, "records": a.records,
              "stub_spans": a.stub_spans,
              "step_host_ms": [s * 1e3 for s in host_s],
              "counters": counters, "spans": rows}
    text = json.dumps(result, indent=1)
    print(text)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
