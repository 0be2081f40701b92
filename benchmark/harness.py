"""One run of one cell of the vic_tpu_torch benchmark.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (`BENCHMARK.json`'s `workloads`) names a configuration
(`benchmark/configs/<config>.json`: the GlobalParams fields, the OUTVARs,
the domain's layout, what is checked and its limits) and a traffic mix
(`benchmark/traffic/<traffic>.json`: the cells, the start date, the
records of a block). The per-layer metrics are read by
`benchmark/metrics/<metric>.py`, each a `read(trace)` that returns a
number or None.

Set-up makes the domain and one block's forcing on the host from the seed
(`benchmark/gen.py`), hands them to the program's own API
(`prepare.prepare_domain`, `physics.frozen_soil.build_node_geometry`,
`physics.hydrology_misc.build_zwt_curves`, `state.initial_state`,
`model.make_forcing_stack`), builds `model.make_step` once and runs one
block as warm-up. The window replays blocks: each starts from a device
copy of the set-up's initial state, calls the step once a record over the
block's forcing, and ends by stacking the outputs and moving them to the
host, as the program's driver does (`driver.run_simulation`'s
`run_records` and `run_shares`). Whole blocks run until `--seconds` have
passed, so a window's work does not depend on the program's speed.

With --trace 0 the result carries the end-to-end metrics. With --trace 1
the window runs with a span and a CUDA event around each step call, then
`trace_blocks` more blocks run as the window runs them under
torch.profiler, then, in the same profiler session, one block whose
kernel calls are counted for the roofline, each inside a span that waits
for the card; the result carries the per-layer metrics.

After the window the last measured block is compared with the plain
reference (`benchmark/compare.py`); each compared number and its limit is
printed last on standard error and last in the result line.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "vic_tpu")
# the kernel functions of the program, read for their names only
CSRC = ROOT / "vic_tpu_torch" / "csrc"


class RunRefused(RuntimeError):
    """A run that cannot give a result (no card, a forbidden module)."""


def forbidden_loaded() -> list:
    """The forbidden top-level names among the loaded modules (a module's
    top-level name is the part of its name before the first dot)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def refuse_forbidden(when: str):
    found = forbidden_loaded()
    if found:
        raise RunRefused(f"modules loaded {when}: {', '.join(found)}")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(workload: str, root: Path = ROOT):
    """(spec, workload entry, configuration, traffic) of a cell, each found
    by its name in BENCHMARK.json."""
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg = load_json(root / configs[cell["config"]]["file"])
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    return spec, cell, cfg, traffic


def cell_metrics(spec: dict, cell: dict, trace: bool) -> list:
    """The metric entries this cell reports in this mode."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in spec[kind]
            if cell["name"] in m.get("workloads", [cell["name"]])]


def metric_reader(name: str):
    """The `read` of benchmark/metrics/<name>.py."""
    path = BENCH / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def check_card(chips: int):
    import torch
    if not torch.cuda.is_available():
        raise RunRefused("torch.cuda.is_available() is false: the benchmark "
                         "measures the card and has no CPU fallback")
    if torch.cuda.device_count() < chips:
        raise RunRefused(f"{torch.cuda.device_count()} CUDA devices, the "
                         f"cell asks for {chips}")


def port_domain(domain):
    """The benchmark's domain as the program's own classes (copies of the
    arrays, so nothing the program does reaches the reference's)."""
    from vic_tpu_torch import params as pp

    def conv(obj, cls):
        return cls(**{f.name: _copy(getattr(obj, f.name))
                      for f in dataclasses.fields(obj) if f.init})
    return pp.Domain(soil=conv(domain.soil, pp.SoilParams),
                     veglib=conv(domain.veglib, pp.VegLib),
                     hru=conv(domain.hru, pp.HruParams),
                     bands=conv(domain.bands, pp.BandParams),
                     cell_valid=_copy(domain.cell_valid))


def _copy(x):
    import numpy as np
    return x.copy() if isinstance(x, np.ndarray) else x


def clone_state(state):
    import torch
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).clone()
        for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), torch.Tensor)})


class Cell:
    """The program set up for one cell: its step, initial state and one
    block's forcing on the device."""

    def __init__(self, cfg: dict, traffic: dict, domain, forcing, device,
                 stages: dict):
        from vic_tpu_torch import config, model, prepare, state, timeaxis
        from vic_tpu_torch.physics import frozen_soil, hydrology_misc
        from . import compare
        self.n_rec = traffic["block_records"]
        self.n_cell = traffic["n_cell"]
        # the block's last records that the check steps the reference
        # through from the program's own state before them
        self.tail = compare.check_tail(cfg, traffic)
        gp = config.GlobalParams(**compare.global_fields(cfg, traffic,
                                                          self.n_rec))
        t = time.perf_counter()
        dom = port_domain(domain)
        params = prepare.prepare_domain(dom, gp, device)
        sync(device)
        t = _stage(stages, "prepare", t)
        geom = None
        if gp.frozen_soil or not gp.quick_flux:
            geom = frozen_soil.build_node_geometry(dom.soil, gp).to(device)
            sync(device)
        t = _stage(stages, "geometry", t)
        zwt = hydrology_misc.zwt_curves_to(
            hydrology_misc.build_zwt_curves(dom.soil), device)
        self.init = state.initial_state(dom, gp, device, geom=geom)
        ax = timeaxis.make_time_axis(gp.startyear, gp.startmonth,
                                     gp.startday, 0, self.n_rec, gp.dt)
        self.stack = model.make_forcing_stack(forcing, ax, device)
        sync(device)
        t = _stage(stages, "upload", t)
        self.step = model.make_step(params, gp, geom, zwt, None,
                                    outvars=cfg["outvars"])
        t = _stage(stages, "step", t)

    def block(self, on_step=None, on_start=None):
        """One block: (final state on the device, outputs on the host as
        {name: [n_rec, n_cell, ...] tensor}, a copy of the state before
        the last `tail` records or None). on_start() is called at its
        start, on_step(host seconds in the step call) after each step
        call."""
        import torch
        if on_start is not None:
            on_start()
        st = clone_state(self.init)
        outs = []
        snap = None
        for i in range(self.n_rec):
            if self.tail and i == self.n_rec - self.tail:
                snap = clone_state(st)
            forc = {k: v[i] for k, v in self.stack.items()}
            t = time.perf_counter()
            st, o = self.step(st, forc)
            if on_step is not None:
                on_step(time.perf_counter() - t)
            outs.append(o)
        host = {k: torch.stack([o[k] for o in outs]).cpu() for k in outs[0]}
        return st, host, snap


def sync(device):
    """Waits for the card's work; nothing on the CPU."""
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _stage(stages: dict, name: str, t0: float) -> float:
    t = time.perf_counter()
    stages[name] = t - t0
    return t


def window(cell: Cell, seconds: float, **hooks):
    """Whole blocks until `seconds` have passed: (blocks, seconds, the last
    block's (state, outputs))."""
    t0 = time.perf_counter()
    ends = []
    while True:
        # the previous block's results are freed before the next block runs
        last = None
        last = cell.block(**hooks)
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    print("window blocks end at (s): " + json.dumps(ends), file=sys.stderr)
    return len(ends), time.perf_counter() - t0, last


def cell_steps_rate(blocks: int, records: int, cells: int,
                    seconds: float) -> float:
    """Cell-steps a second of a window: the cells times the records of
    every whole block it ran, over all its seconds."""
    return blocks * records * cells / seconds


def spanned_window(cell: Cell, seconds: float, trace):
    """The window with the harness's span (host seconds) and a CUDA event
    after each step call; fills trace.records, step_host_s, record_ms."""
    import torch
    events = []

    def on_start():
        events.append([_event()])

    def on_step(host_s):
        events[-1].append(_event())
        trace.step_host_s.append(host_s)

    blocks, secs, last = window(cell, seconds, on_step=on_step,
                                on_start=on_start)
    torch.cuda.synchronize()
    for evs in events:
        trace.record_ms += [a.elapsed_time(b) for a, b in zip(evs, evs[1:])]
    trace.records = len(trace.step_host_s)
    return blocks, secs, last


def _event():
    import torch
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


class KernelHooks:
    """Stands in for the program's countable kernel bindings
    (`vic_tpu_torch.kernels.<name>`, looked up by the call sites at each
    call) while a block runs: `run_counted` adds each call's bound
    (benchmark/roofline.py) and runs the call inside a span that waits for
    the card at both ends, so the profiler's trace shows which of the
    program's kernels each call launches."""

    def __init__(self):
        from vic_tpu_torch import kernels
        from . import roofline
        self.kernels = kernels
        self.roofline = roofline
        self.names = [n for n in kernels.launches if n in COUNTED]
        self.bound_s = 0.0
        self.counted_calls = 0

    def run_counted(self, fn):
        import torch
        from torch.profiler import record_function
        from .timeline import KERNEL_SPAN
        saved = {n: getattr(self.kernels, n) for n in self.names}

        def make(name, kern):
            def call(*a, **k):
                torch.cuda.synchronize()
                with record_function(KERNEL_SPAN):
                    r = kern(*a, **k)
                    torch.cuda.synchronize()
                w = self.roofline.work(name, a, k, r)
                if w is not None:
                    self.bound_s += self.roofline.bound_s(*w)
                    self.counted_calls += 1
                return r
            return call
        for n, kern in saved.items():
            setattr(self.kernels, n, make(n, kern))
        try:
            return fn()
        finally:
            for n, kern in saved.items():
                setattr(self.kernels, n, kern)


# the bindings benchmark/roofline.py counts
COUNTED = ("glacier_brent", "snowpack_brent", "canopy_brent",
           "runoff_hourly", "surface_brent", "node_sweep",
           "fd_surface_brent")


def traced_part(cell: Cell, n_blocks: int, trace):
    """n_blocks blocks under torch.profiler as the window runs them, then,
    in the same profiler session, one block whose countable kernel calls
    are counted for the roofline. Fills the trace's profiled part; returns
    the last of the n_blocks blocks."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from . import timeline
    hooks = KernelHooks()
    torch.cuda.synchronize()
    last = None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("bench.window"):
            for _ in range(n_blocks):
                with record_function("bench.block"):
                    last = None
                    last = cell.block()
            torch.cuda.synchronize()
        with record_function("bench.counted"):
            hooks.run_counted(cell.block)
            torch.cuda.synchronize()
    ops, host = timeline.events_of(prof)
    win = [h for h in host if h.name == "bench.window"]
    if not win:
        raise RuntimeError("the profiler recorded no bench.window span")
    trace.window_ns = (win[0].start_ns, win[0].end_ns)
    trace.ops = [o for o in ops if o.end_ns > trace.window_ns[0]
                 and o.start_ns < trace.window_ns[1]]
    trace.host = [h for h in host if h.end_ns > trace.window_ns[0]
                  and h.start_ns < trace.window_ns[1]]
    trace.profiled_records = n_blocks * cell.n_rec
    if not trace.ops:
        raise RuntimeError("torch.profiler recorded no device operation in "
                           "the traced window")
    names = {o.name for o in timeline.span_ops(ops, host,
                                               timeline.KERNEL_SPAN)
             if timeline.is_port_kernel(o.name, trace.port_kernels)}
    if hooks.counted_calls and names:
        trace.roofline = (hooks.bound_s * n_blocks, frozenset(names))
    own = timeline.profiler_idle_ns(trace)
    print(f"profiler's own idle time (s): {own / 1e9} of a window of "
          f"{(trace.window_ns[1] - trace.window_ns[0]) / 1e9}",
          file=sys.stderr)
    return last


def power_limit() -> str:
    """The card's power limit as nvidia-smi reads it, or "unknown"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "unknown"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    try:
        result, checks = run(args, t_start)
    except RunRefused as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    for name, (value, limit) in checks.items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def run(args, t_start: float, check_card_fn=check_card, fault=None,
        resize=None):
    """One run: (result dict, {check name: (value, limit)}). The tests'
    hooks: fault(cell) breaks the program's timed path after set-up;
    resize(cfg, traffic) -> (cfg, traffic) shrinks the cell to a CPU's
    size."""
    spec, cell_entry, cfg, traffic = cell_spec(args.workload)
    if resize is not None:
        cfg, traffic = resize(cfg, traffic)
    stages = {}
    import numpy as np
    import torch
    check_card_fn(cell_entry["chips"])
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.init()
        torch.zeros(1, device=device)
    from vic_tpu_torch import kernels  # noqa: F401  (the program)
    from . import compare, gen, timeline
    refuse_forbidden("after importing the program")
    t = _stage(stages, "import_init", t_start)
    if on_card:
        from vic_tpu_torch.kernels import build
        build.load()
    t = _stage(stages, "library", t)
    domain = gen.cell_domain(cfg, traffic, args.seed)
    t = _stage(stages, "domain", t)
    forcing = gen.cell_forcing(cfg, traffic, args.seed)
    t = _stage(stages, "forcing", t)
    cell = Cell(cfg, traffic, domain, forcing, device, stages)
    t = time.perf_counter()
    cell.block()
    sync(device)
    t = _stage(stages, "warmup", t)
    if fault is not None:
        fault(cell)
    setup_s = time.perf_counter() - t_start
    print("setup stages (s): " + json.dumps(stages), flush=True)

    trace = timeline.Trace()
    if args.trace:
        blocks, win_s, _ = spanned_window(cell, args.seconds, trace)
        trace.port_kernels = timeline.port_kernel_names(CSRC)
        last = traced_part(cell, traffic.get("trace_blocks", 2), trace)
    else:
        blocks, win_s, last = window(cell, args.seconds)
    refuse_forbidden("after the window")
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    # the check: the last block's compared cells and records on the host,
    # the program's state freed, then the reference on the card
    cells = compare.check_cells(cfg, traffic, args.seed)
    n_rec = cell.n_rec
    n_chk = compare.check_records(cfg, traffic)
    tail = cell.tail
    final, outs, snap = last
    recs = (list(range(n_chk)) + list(range(n_rec - tail, n_rec))
            if tail else slice(0, n_chk))
    prog_out = {k: (v[recs] if cells is None else
                    v[recs][:, torch.as_tensor(cells)]).numpy()
                for k, v in outs.items()}
    whole = n_chk == n_rec or tail > 0
    prog_state = compare.state_arrays(final, cells) if whole else None
    start = compare.state_arrays(snap, cells) if tail else None
    del cell, final, outs, last, snap
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref_out, ref_final = compare.run_reference(cfg, traffic, domain,
                                               forcing, device, cells, n_chk)
    if tail:
        tail_out, ref_final = compare.run_reference(
            cfg, traffic, domain, forcing, device, cells, tail,
            first=n_rec - tail, start=start)
        ref_out = {k: np.concatenate([v, tail_out[k]])
                   for k, v in ref_out.items()}
    print(f"reference (s): {time.perf_counter() - t}", file=sys.stderr)
    nums = compare.numbers(prog_out, ref_out, prog_state,
                           ref_final if whole else None)
    limits = cfg["limits"]
    correct = compare.verdict(nums, limits)
    refuse_forbidden("before the result")

    metrics = {}
    if args.trace:
        for m in cell_metrics(spec, cell_entry, True):
            v = metric_reader(m["name"])(trace)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"cell_steps_per_s": cell_steps_rate(
                      blocks, traffic["block_records"], traffic["n_cell"],
                      win_s),
                  "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
        for m in cell_metrics(spec, cell_entry, False):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell_entry["chips"], "memory_peak_bytes": int(peak),
           "power_limit": power_limit() if on_card else "none"}
    result = {"correct": bool(correct), "attempted": int(blocks),
              "failed": 0 if correct else 1, "metrics": metrics,
              "device": dev}
    if args.trace:
        lo, hi = trace.window_ns
        busy = timeline.union_ns([(o.start_ns, o.end_ns) for o in trace.ops],
                                 lo, hi)
        dev["busy_s"] = busy / 1e9
        dev["window_s"] = (hi - lo) / 1e9
        result["breakdown"] = timeline.breakdown(trace)
    checks = {k: (nums.get(k, float("nan")), lim) for k, lim in
              limits.items()}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result, checks
