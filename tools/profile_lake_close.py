"""The lakes' step and the CLOSE_ENERGY canopy-air update on one NVIDIA
GPU: `lake_step` with its water balance, `lake_ice_melt` (K12 and the
torch around it, or the one launch that took them in), the column fixed
points K10 (`lake_open_water`) and K11 (`lake_under_ice`), K13
(`lake_depth`) alone, K9 (`canopy_air_step`) alone and as a pass of the
loop uses it, and the loop's final update, each call split into the
wrapper's host time and the device's time.

    cd <checkout> && python3 <path>/tools/profile_lake_close.py
        [--cells 32768] [--heavy-cells 8192] [--reps 20]
        [--dump FILE.pt] [--against FILE.pt] [--out FILE.json]

Like tools/profile_lane_brent.py it builds and imports the kernels,
`vic_tpu_torch` and `chip_smoke` of the checkout it is run from, so two
trees are compared on one card by running it from each root in turn.
Cases, each on the arguments of the call's first use in that step
(`chip_smoke.capture_kernel_args`):

- `lake_step` in lakes' second record (`--cells` cells) and heavy's fourth
  (`--heavy-cells`), and `solve_lake` on the same arguments;
- `lake_water_balance` (the kernel) on the arguments its step gives it,
  where the checkout has it;
- `physics.lake.lake_ice_melt` on the arguments `solve_lake` gives it in
  lakes' second record and heavy's fourth, and (for --dump and --against)
  in heavy's seventh (a blowing-snow flux over the ice) and in heavy's
  first NaN record of the smoke (CONTINUEONERROR, NaN air in 64 cells from
  the fourth record); its outputs include the Brent's root, flags and
  iterations: `IceMeltResult.solve` where the checkout has it, else what
  its `kernels.lake_ice_brent` call returned;
- K10 and K11 on the arguments `solve_lake` gives them in lakes' second
  record, heavy's fourth and heavy's first NaN record, each with its
  active lakes, the distribution of the iterations its lakes ran (the
  kernel's `iterations` on the active lakes), and the red-black sweeps of
  each of its mixes that mix some pair, counted on the plain version's
  columns (K10: its one mix of the converged column on every lake; K11:
  the mix in each iteration a lake ran);
- K13 on its first call in lakes' second record (the depth before the
  step);
- K9 in heavy_nolakes' fourth record (its first CLOSE_ENERGY pass),
  `--heavy-cells` cells: the kernel alone, and a pass as the loop makes it
  (the kernel and the host's read of the batch's largest change);
- the loop's final update at the settled temperature on the same lanes
  (`canopy_air_final` where the checkout has it, else the plain torch
  lines of `model.make_step` it replaced).

For each: the wrapper's host time (call to return, no synchronize) and
the call's (call to synchronize), medians of `--reps` calls after a
warm-up; CUDA-event milliseconds a call over `--reps` calls back to back;
one call under torch.profiler: the device's busy and idle milliseconds
and its events (kernels, memsets and copies).

--dump writes each case's arguments and outputs; --against reads such a
file (another checkout's) and runs this checkout's functions again on its
arguments, giving each output's largest difference and the elements where
only one of the two is NaN.

Prints the card's name and power limit and, as its last line, one JSON
object with every number (also written to --out).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.getcwd())
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from profile_fd_surface import _event_ms, _host_ms, _profiled  # noqa: E402
from profile_lane_brent import flat_outputs  # noqa: E402

# lake_step's arguments that solve_lake takes, by solve_lake's names
SOLVE_LAKE_ARGS = {"snowfall_mm": "snowfall_mm", "rainfall_mm": "rainfall_mm",
                   "tair": "tair", "wind": "wind", "vp": "vp_air",
                   "sw_in": "sw_in", "lw_in": "lw_in", "vpd": "vpd",
                   "pressure": "pressure", "air_density": "air_density",
                   "dt_sec": "dt_sec", "wind_h": "wind_h",
                   "snow_rough": "snow_rough", "lat": "lat",
                   "day_in_year": "day_in_year",
                   "new_snow_alb": "new_snow_alb",
                   "alb_accum_a": "alb_accum_a", "alb_accum_b": "alb_accum_b",
                   "alb_thaw_a": "alb_thaw_a", "alb_thaw_b": "alb_thaw_b",
                   "blowing": "blowing"}
# K9's arguments that the final update reads
FINAL_ARGS = ("canopy_sensible", "soil_sensible", "pack_sensible", "cov_w",
              "tair", "air_dens", "ra_over", "iter_mask")
DEVICE_KEYS = ("device_events", "device_busy_ms", "device_span_ms",
               "device_idle_ms")


def solve_lake_call(lake, a, kw):
    import torch
    active = kw.get("active")
    if active is None:
        active = torch.ones_like(a[1].volume, dtype=torch.bool)
    args = {k: kw[v] for k, v in SOLVE_LAKE_ARGS.items() if v in kw}
    return lambda: lake.solve_lake(a[0], a[1], active=active, **args)


# K10's and K11's kernels, by the physics.lake function solve_lake calls
COLUMN_KERNELS = {"lake_open_water": "lake_open_water",
                  "lake_under_ice": "water_under_ice"}


def captured_call(lake, name, a, kw):
    """The keyword arguments solve_lake gives physics.lake's `name` in a
    lake_step call on (a, kw)."""
    got = []
    original = getattr(lake, name)

    def wrapper(**k):
        got.append(k)
        return original(**k)

    setattr(lake, name, wrapper)
    try:
        solve_lake_call(lake, a, kw)()
    finally:
        setattr(lake, name, original)
    return got[0]


def mixing_sweeps(lake, temp, grid, cp):
    """Per column, the sweeps of tracer_mixer's fixed MIX_SWEEPS that mix
    some pair. A sweep mixes a pair exactly when its column starts it with
    a density-unstable active pair (a pass that mixes nothing leaves the
    column to the next), and after the first sweep that mixes nothing no
    later one does."""
    import torch
    count = torch.zeros(temp.shape[:-1], dtype=torch.int64,
                        device=temp.device)
    t = temp
    for _ in range(lake.MIX_SWEEPS):
        rho = lake.water_density(t)
        unstable = ((rho[..., :-1] > rho[..., 1:])
                    & grid.mask[..., 1:]).any(-1)
        if not bool(unstable.any()):
            break
        count += unstable
        t = lake.tracer_mixer(t, grid, cp, sweeps=1)
    return count


def column_mixes(lake, name, kw, iterations):
    """The mixes K10 (`name` lake_open_water: one of the converged column
    on every lake) or K11 (one in each iteration a lake ran, `iterations`
    the kernel's) runs on kw, counted on the plain version's columns: (the
    lake of each mix, the sweeps of it that mix some pair, the sweeps the
    kernel's mix runs: one more, at most MIX_SWEEPS)."""
    import torch
    grid, cp = kw["grid"], lake.specheat(kw["temp"])
    every = torch.arange(iterations.shape[0], device=iterations.device)
    if name == "lake_open_water":
        lakes = every
        mixing = mixing_sweeps(lake, lake.water_energy_balance(**kw).temp,
                               grid, cp)
    else:
        columns = []
        original = lake.tracer_mixer

        def spy(t, *a, **k):
            columns.append(t)
            return original(t, *a, **k)

        lake.tracer_mixer = spy
        try:
            lake.water_under_ice_plain(**kw)
        finally:
            lake.tracer_mixer = original
        ran = [kw["active"] & (iterations > i) for i in range(len(columns))]
        lakes = torch.cat([every[:0]] + [every[r] for r in ran])
        mixing = torch.cat([every[:0]] + [
            mixing_sweeps(lake, t, grid, cp)[r]
            for t, r in zip(columns, ran)])
    return lakes, mixing, (mixing + 1).clamp(max=lake.MIX_SWEEPS)


def column_stats(lake, name, kw, out):
    """K10's or K11's lakes, active lakes, converged active lakes, the
    iterations its lakes ran (counts of 0..EB_MAX_ITER over the active
    lakes), its mixes (column_mixes) and the counts of their mixing sweeps
    (0..MIX_SWEEPS), and the mean of the sweeps its mixes run."""
    import torch
    res = out[0] if name == "lake_open_water" else out
    active = kw["active"]
    _, mixing, run = column_mixes(lake, name, kw, res.iterations)
    return {"lakes": int(active.numel()), "active": int(active.sum()),
            "converged": int(res.converged[active].sum()),
            "iterations": torch.bincount(
                res.iterations[active].long(),
                minlength=lake.EB_MAX_ITER + 1).tolist(),
            "mixes": int(mixing.numel()),
            "mixing_sweeps": torch.bincount(
                mixing, minlength=lake.MIX_SWEEPS + 1).tolist(),
            "stopped_mix_sweeps_mean": float(run.double().mean())
            if mixing.numel() else 0.0}


def ice_melt_outputs(lake, kernels, kw):
    """lake_ice_melt on kw and the Brent's outputs: (IceMeltResult,
    RootResult)."""
    if not hasattr(kernels, "lake_ice_brent"):
        out = lake.lake_ice_melt(**kw)
        return out, out.solve
    roots = []
    original = kernels.lake_ice_brent

    def wrapper(*a, **k):
        roots.append(original(*a, **k))
        return roots[-1]

    kernels.lake_ice_brent = wrapper
    try:
        out = lake.lake_ice_melt(**kw)
    finally:
        kernels.lake_ice_brent = original
    return out, roots[0]


def final_plain(canopy_sensible, soil_sensible, pack_sensible, cov_w, tair,
                air_dens, ra_over, iter_mask):
    """model.make_step's final canopy-air update before it became
    physics.canopy_air.canopy_air_final."""
    import torch
    from vic_tpu_torch.physics.canopy_air import calc_atmos_energy_bal
    under_sens = soil_sensible + pack_sensible * cov_w
    ca = calc_atmos_energy_bal(canopy_sensible + under_sens, tair, air_dens,
                               ra_over)
    return (torch.where(iter_mask, ca.tcanopy, tair),
            torch.where(iter_mask, ca.fbflag, False),
            torch.where(iter_mask, ca.sensible, under_sens))


def move(x, device):
    import dataclasses

    import torch
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if dataclasses.is_dataclass(x):
        return x.to(device)
    if isinstance(x, dict):
        return {k: move(v, device) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(move(v, device) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(move(v, device) for v in x)
    return x


def differences(mine, theirs):
    """Each float output's largest difference where neither is NaN and its
    elements that differ bit for bit (NaN equal to NaN), the elements NaN
    in one only, and the differing elements of the others."""
    import torch
    out = {"largest_difference": {}, "nan_apart": 0, "differing": {}}
    for k, y in theirs.items():
        x = mine.get(k)
        if x is None or x.shape != y.shape:
            continue
        if x.dtype == torch.float32:
            both = ~torch.isnan(x) & ~torch.isnan(y)
            d = torch.where(both, (x - y).abs(), 0.0)
            out["largest_difference"][k] = float(d.max()) if d.numel() \
                else 0.0
            out["nan_apart"] += int((torch.isnan(x) != torch.isnan(y)).sum())
            out["differing"][k] = int(((x.view(torch.int32)
                                        != y.view(torch.int32))
                                       & ~(torch.isnan(x)
                                           & torch.isnan(y))).sum())
        else:
            out["largest_difference"][k] = int((x != y).sum())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", type=int, default=32768)
    ap.add_argument("--heavy-cells", type=int, default=8192)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--dump", default=None)
    ap.add_argument("--against", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    import chip_smoke
    from vic_tpu_torch import kernels
    from vic_tpu_torch.kernels import build
    from vic_tpu_torch.physics import canopy_air, lake

    device = chip_smoke.device_phase()
    build.build()
    build.load()
    result = {"root": os.getcwd(), "card": chip_smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]}
    balance = ("lake_water_balance",) if hasattr(kernels,
                                                  "lake_water_balance") else ()
    lakes = chip_smoke.capture_kernel_args(
        "lakes", ("lake_step", "lake_depth") + balance, device,
        record=chip_smoke.LAKES_RECORD, cells=args.cells)
    heavy = chip_smoke.capture_kernel_args(
        "heavy", ("lake_step",) + balance, device,
        record=chip_smoke.HEAVY_RECORD, cells=args.heavy_cells)
    steps = {"lakes": lakes["lake_step"], "heavy": heavy["lake_step"]}
    for label, record, build in (
            ("heavy_blowing", chip_smoke.HEAVY_LAKE_RECORD, None),
            ("heavy_nan", chip_smoke.NAN_FROM,
             chip_smoke.continue_on_error_build("heavy", shift=0))):
        steps[label] = chip_smoke.capture_kernel_args(
            "heavy", ("lake_step",), device, record=record, build=build,
            cells=args.heavy_cells)["lake_step"]
    ice_melt = {label: captured_call(lake, "lake_ice_melt", *step)
                for label, step in steps.items()}
    columns = {(name, label): captured_call(lake, fn, *steps[label])
               for name, fn in COLUMN_KERNELS.items()
               for label in ("lakes", "heavy", "heavy_nan")}
    close = chip_smoke.capture_kernel_args(
        "heavy_nolakes", ("canopy_air_step",), device,
        record=chip_smoke.HEAVY_RECORD, cells=args.heavy_cells)
    largest = getattr(canopy_air, "largest_change", float)
    final = getattr(canopy_air, "canopy_air_final", None)
    k9a, k9kw = close["canopy_air_step"]
    fkw = {k: k9kw[k] for k in FINAL_ARGS}

    def pass_call():
        return largest(kernels.canopy_air_step(*k9a, **k9kw)[2])

    cases = {}
    for config, cap in (("lakes", lakes), ("heavy", heavy)):
        a, kw = cap["lake_step"]
        cases[f"lake_step/{config}"] = (lambda a=a, kw=kw:
                                        lake.lake_step(*a, **kw), (a, kw))
        cases[f"solve_lake/{config}"] = (solve_lake_call(lake, a, kw), None)
        if balance:
            a, kw = cap["lake_water_balance"]
            cases[f"lake_water_balance/{config}"] = (
                lambda a=a, kw=kw: kernels.lake_water_balance(*a, **kw),
                None)
    for config, kw in ice_melt.items():
        cases[f"lake_ice_melt/{config}"] = (
            lambda kw=kw: lake.lake_ice_melt(**kw), ((), kw))
    for (name, label), kw in columns.items():
        cases[f"{name}/{label}"] = (
            lambda name=name, kw=kw: getattr(kernels, name)(**kw), ((), kw))
    a, kw = lakes["lake_depth"]
    cases["lake_depth/lakes"] = (lambda: kernels.lake_depth(*a, **kw), None)
    cases["canopy_air_step/heavy_nolakes"] = (
        lambda: kernels.canopy_air_step(*k9a, **k9kw), (k9a, k9kw))
    cases["canopy_air_pass/heavy_nolakes"] = (pass_call, None)
    cases["close_energy_tail/heavy_nolakes"] = (
        (lambda: final(**fkw)) if final else (lambda: final_plain(**fkw)),
        ((), fkw))

    calls, dumped = {}, {}
    for label, (fn, captured) in cases.items():
        out = fn()
        if label.startswith("lake_ice_melt/"):
            out = ice_melt_outputs(lake, kernels, captured[1])
        torch.cuda.synchronize()
        wrapper_ms, call_ms = _host_ms(fn, args.reps)
        calls[label] = fn
        result[label] = {"wrapper_host_ms": wrapper_ms, "call_ms": call_ms,
                         "cuda_event_ms": _event_ms(fn, args.reps)}
        name = label.split("/")[0]
        if name in COLUMN_KERNELS:
            result[label].update(column_stats(lake, name, captured[1], out))
        if captured is not None:
            dumped[label] = {
                "args": move(chip_smoke.clone_args(captured), "cpu"),
                "flat": {k: v.cpu() for k, v in flat_outputs(out).items()}}
    _, prof = _profiled(calls)
    for label in cases:
        case = result[label]
        case.update({k: prof[label][k] for k in DEVICE_KEYS + ("by_kernel",)})
    for label, case in result.items():
        if isinstance(case, dict):
            print(f"  {label}: wrapper {case['wrapper_host_ms']:.4f} ms on "
                  f"the host, call {case['call_ms']:.4f} ms, CUDA events "
                  f"{case['cuda_event_ms']:.4f} ms, device busy "
                  f"{case['device_busy_ms']:.4f} ms in "
                  f"{case['device_events']} events, idle "
                  f"{case['device_idle_ms']:.4f} ms", flush=True)
            if "active" in case:
                print(f"    lakes {case['lakes']}, active {case['active']}, "
                      f"converged {case['converged']}, iterations "
                      f"{case['iterations']}, mixes {case['mixes']}, "
                      f"mixing sweeps {case['mixing_sweeps']}, a stopped "
                      f"mix's sweeps mean "
                      f"{case['stopped_mix_sweeps_mean']:.4f}", flush=True)
    if args.dump:
        os.makedirs(os.path.dirname(os.path.abspath(args.dump)),
                    exist_ok=True)
        torch.save(dumped, args.dump)
    if args.against:
        other = torch.load(args.against, weights_only=False)
        fns = {"lake_step": lake.lake_step,
               "lake_ice_melt": lambda **kw: ice_melt_outputs(lake, kernels,
                                                              kw),
               "canopy_air_step": kernels.canopy_air_step,
               "lake_open_water": kernels.lake_open_water,
               "lake_under_ice": kernels.lake_under_ice,
               "close_energy_tail": final or final_plain}
        for label, theirs in other.items():
            a, kw = move(theirs["args"], device)
            out = fns[label.split("/")[0]](*a, **kw)
            torch.cuda.synchronize()
            diff = differences(
                {k: v.cpu() for k, v in flat_outputs(out).items()},
                theirs["flat"])
            print(f"  {label} on {args.against}'s arguments: "
                  + json.dumps(diff), flush=True)
            result[label]["against"] = diff
    text = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
