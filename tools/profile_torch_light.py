"""Where the time of the port's step goes on one NVIDIA GPU.

    python tools/profile_torch_light.py [--config light|frozen|
                                                  blowing_close|lakes|
                                                  dist_prcp|heavy_nolakes|
                                                  heavy|frozen_exp|
                                                  frozen_quick|
                                                  spatial_snow]
                                        [--cells 32768] [--records 8]
                                        [--repeats 5] [--rate-only]
                                        [--out FILE.json]

1. throughput: `--repeats` runs of `--records` records through
   vic_tpu_torch.model.run after a warm-up record, timed on the host clock
   around torch.cuda.synchronize(); cell-steps/s median, quartiles and
   each run's rate.
2. breakdown: one run with each physics call of the step wrapped in
   synchronize() + host clock, so every call's wall time (launch overhead
   included) is attributed to it, and its calls counted; the rest of the
   step is "other". Inside three calls the pieces that their kernels took
   over are timed and counted as nested breakdowns: the snowpack
   balance's terms (`snow_energy_terms`) inside `snow_melt`, the glacier
   balance's terms (`glacier_energy_terms`) and K1 (`glacier_brent`)
   inside `glacier_ablation`, the infiltration curve
   (`compute_runoff_and_asat`) and K4 (`runoff_hourly`) inside
   `runoff_step`; whatever of each call is not in them is its glue. With
   LAKES, lake_step's calls inside it (solve_lake and, inside that, the
   K10-K12 call sites; physics.lake's K13 depth bisections; the water
   balance's launch) are timed as a nested "lake" breakdown with
   solve_lake's own glue and lake_step less solve_lake (the water balance
   and the state masks; with BLOWING, the blowing-snow call over lake ice,
   K8, inside solve_lake too). A call the checkout lacks is left out, so an
   older checkout is profiled by the same script.
3. profile: torch.profiler over two records: device time by kernel name,
   the hand-written kernels' own device time, and the device's busy share.

With --rate-only only 1. runs, so two checkouts compare in one chip call
by running it from each root in turn, alternating.

Prints one JSON object with every number (also written to --out) and the
card's name and power limit. Needs a CUDA device. Imports the
`vic_tpu_torch` of the directory it is run from, so two checkouts compare
on one card when it is run from each root in turn.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.getcwd())

from vic_tpu_torch import kernels, model  # noqa: E402
from vic_tpu_torch.entry import CONFIGS  # noqa: E402
from vic_tpu_torch.physics import glacier, lake, runoff, snow  # noqa: E402

STEP_CALLS = ("calc_aerodynamic", "snow_intercept", "snow_albedo",
              "snow_melt", "glacier_ablation", "snow_density_update",
              "build_evap_pre", "solve_surface_temperature",
              "surf_energy_terms", "runoff_step", "compute_pot_evap")
# each configuration's own calls (the node sweep runs inside the surface
# Brent and the final surf_energy_terms, and is timed with them; with
# CLOSE_ENERGY every call of the canopy -> surface chain is timed over all
# its passes)
CONFIG_CALLS = {
    "light": (),
    "frozen": ("distribute_node_moisture", "estimate_layer_ice",
               "find_zero_fronts"),
    "blowing_close": ("calc_blowing_snow", "canopy_air_step",
                      "canopy_air_final"),
    # the lake coupling's pre-step depth (K13) and the lake step
    "lakes": ("depth_from_volume", "lake_step"),
    "dist_prcp": ("storm_transfer",),
    # the affine passes' probes and the final pass's Brent each run K6
    # inside solve_surface_temperature, and are timed with it
    "heavy_nolakes": ("distribute_node_moisture", "estimate_layer_ice",
                      "find_zero_fronts", "calc_blowing_snow",
                      "canopy_air_step", "canopy_air_final",
                      "storm_transfer", "compute_zwt"),
}
CONFIG_CALLS["heavy"] = CONFIG_CALLS["heavy_nolakes"] + CONFIG_CALLS["lakes"]
CONFIG_CALLS["frozen_exp"] = CONFIG_CALLS["frozen"]
CONFIG_CALLS["frozen_quick"] = ("estimate_layer_ice", "find_zero_fronts")
# SPATIAL_SNOW's depletion curve and CORRPREC's gauge correction
CONFIG_CALLS["spatial_snow"] = ("calc_snow_coverage", "correct_precip")
# inside lake_step (physics/lake.py): solve_lake, within it the open-water
# column (K10), the snow-on-ice update (K12 inside) and the under-ice
# column (K11); physics.lake's depth bisections (K13: solve_lake's and,
# before the water balance was one launch, the water balance's); the water
# balance's launch where the checkout has it
LAKE_CALLS = ("solve_lake", "lake_open_water", "lake_ice_melt",
              "water_under_ice", "depth_from_volume", "lake_water_balance")
# nested breakdowns: inside snow_melt (physics/snow.py) the snowpack
# balance's terms; inside glacier_ablation the glacier balance's terms and
# K1; inside runoff_step the infiltration curve and K4
NESTED = {"snow_melt": ((snow, "snow_energy_terms"),),
          "glacier_ablation": ((glacier, "glacier_energy_terms"),
                               (kernels, "glacier_brent")),
          "runoff_step": ((runoff, "compute_runoff_and_asat"),
                          (kernels, "runoff_hourly"))}
HAND_WRITTEN = ("brent_kernel", "runoff_hourly_kernel", "node_sweep_kernel",
                "node_finish_kernel", "fd_eval_kernel", "fd_expand_kernel",
                "fd_init_kernel", "fd_propose_kernel", "fd_accept_kernel",
                "fd_finish_kernel", "blowing_snow_kernel",
                "canopy_air_kernel", "canopy_air_final_kernel",
                "lake_open_water_kernel", "lake_under_ice_kernel",
                "lake_depth_kernel", "lake_water_balance_kernel")


def quartiles(xs):
    q = statistics.quantiles(xs, n=4) if len(xs) > 1 else [xs[0]] * 3
    return {"median": statistics.median(xs), "q1": q[0], "q3": q[2],
            "n": len(xs)}


def build(config, n_cell, n_rec, device):
    """(gp, params, stack, state, run keyword arguments) after a warm-up
    record."""
    gp, params, stack, state, kw = CONFIGS[config](n_cell, n_rec, device)
    model.run(state, {k: v[:1] for k, v in stack.items()}, params, gp, **kw)
    return gp, params, stack, state, kw


def throughput(config, n_cell, n_rec, repeats, device):
    gp, params, stack, state, kw = build(config, n_cell, n_rec, device)
    rates = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.run(state, stack, params, gp, **kw)
        torch.cuda.synchronize()
        rates.append(n_cell * n_rec / (time.perf_counter() - t0))
    return dict(quartiles(rates), runs=rates)


def breakdown(config, n_cell, n_rec, device):
    gp, params, stack, state, kw = build(config, n_cell, n_rec, device)
    # a call the checkout lacks (an older one) is left out
    wrapped = [(model, name) for name in STEP_CALLS + CONFIG_CALLS[config]
               if hasattr(model, name)]
    lake_calls = tuple(n for n in LAKE_CALLS if hasattr(lake, n)) + (
        ("calc_blowing_snow",) if gp.blowing else ())
    if gp.lakes:
        wrapped += [(lake, name) for name in lake_calls]
    wrapped += [pair for inner in NESTED.values() for pair in inner]
    spent = {(mod, name): 0.0 for mod, name in wrapped}
    count = {(mod, name): 0 for mod, name in wrapped}
    originals = {(mod, name): getattr(mod, name) for mod, name in wrapped}

    def timed(key, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t0
            count[key] += 1
            return out
        return wrapper

    for (mod, name), fn in originals.items():
        setattr(mod, name, timed((mod, name), fn))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.run(state, stack, params, gp, **kw)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for (mod, name), fn in originals.items():
            setattr(mod, name, fn)

    def ms(key):
        return spent[key] / n_rec * 1e3

    per_rec = {name: ms((model, name)) for mod, name in wrapped
               if mod is model}
    per_rec["other"] = total / n_rec * 1e3 - sum(per_rec.values())
    result = {"ms_per_record": per_rec,
              "total_ms_per_record": total / n_rec * 1e3,
              "calls_per_record": {
                  (name if mod is model else f"{mod.__name__}.{name}"):
                  count[(mod, name)] / n_rec for mod, name in wrapped}}
    for outer, inner in NESTED.items():
        result[f"{outer}_ms_per_record"] = {name: ms((mod, name))
                                            for mod, name in inner}
    if gp.lakes:
        # nested: solve_lake's calls inside it, the rest of lake_step
        inner = {name: ms((lake, name)) for name in lake_calls}
        nested = ("lake_open_water", "lake_ice_melt", "water_under_ice") \
            + (("calc_blowing_snow",) if gp.blowing else ())
        inner["solve_lake own glue"] = inner["solve_lake"] - sum(
            inner[n] for n in nested)
        # the water balance and the state masks: all of lake_step but
        # solve_lake (depth_from_volume counts physics.lake's calls,
        # solve_lake's one included)
        inner["lake_step less solve_lake"] = (per_rec["lake_step"]
                                              - inner["solve_lake"])
        result["lake_ms_per_record"] = inner
    return result


def profile(config, n_cell, device, step_ms):
    """Device time of every kernel over two profiled records. The busy
    share is given against the profiled wall time (profiler overhead
    included) and against two records at the unprofiled median step
    time `step_ms`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    gp, params, stack, state, kw = build(config, n_cell, 2, device)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.run(state, stack, params, gp, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side kernel events only: CPU-side aten ops also carry the
    # device time of the kernels they launched
    kernels = sorted(((e.key, e.self_device_time_total, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda x: -x[1])
    busy_ms = sum(k[1] for k in kernels) / 1e3
    ours = {k[0]: {"ms": k[1] / 1e3, "count": k[2]} for k in kernels
            if any(h in k[0] for h in HAND_WRITTEN)}
    return {"records": 2, "profiled_wall_ms": wall * 1e3,
            "device_busy_ms": busy_ms,
            "busy_share_of_profiled_wall": busy_ms / (wall * 1e3),
            "busy_share_of_unprofiled_steps": busy_ms / (2 * step_ms),
            "device_kernel_launches": sum(k[2] for k in kernels),
            "hand_written_kernels": ours,
            "top_device_time": [
                {"name": k[0][:100], "ms": k[1] / 1e3, "count": k[2]}
                for k in kernels[:12]]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", choices=tuple(CONFIGS), default="light")
    ap.add_argument("--cells", type=int, default=32768)
    ap.add_argument("--records", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--rate-only", action="store_true",
                    help="throughput alone, with each run's rate")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("profile_torch_light needs a CUDA device")
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    torch.empty(0, device=device)          # create the CUDA context
    torch.cuda.reset_peak_memory_stats(device)
    rate = throughput(a.config, a.cells, a.records, a.repeats, device)
    result = {
        "card": card, "config": a.config, "cells": a.cells,
        "records": a.records,
        "lanes": a.cells * 8, "cell_steps_per_s": rate,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(device),
    }
    if not a.rate_only:
        result["breakdown"] = breakdown(a.config, a.cells, a.records, device)
        result["profile"] = profile(a.config, a.cells, device,
                                    step_ms=a.cells / rate["median"] * 1e3)
    text = json.dumps(result, indent=1)
    print(text)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
