"""The lakes' water balance, K13 and K16 on one NVIDIA GPU, from a
checkout's root, so that two trees unpacked side by side compare on one
card (parent, change, change, parent).

    cd <checkout> && python3 <path>/tools/profile_balance_implicit.py
        [--cases PREFIX ...] [--reps 20] [--dump FILE.pt]
        [--against FILE.pt] [--out FILE.json]

It builds and imports the kernels, `vic_tpu_torch` and `chip_smoke` of the
checkout it is run from (nvcc with -Xptxas -v: each kernel's registers,
stack frame and spill stores) and takes each case's arguments from a step
of that checkout (`chip_smoke.capture_kernel_args`):

- `lake_water_balance/lakes` and `/heavy`: the water balance in lakes'
  second record (32,768 lakes) and heavy's fourth (8,192);
- `lake_depth/lakes`: K13's first call in lakes' second record;
- `implicit_profile/frozen_5`: K16 on K6's arguments in frozen's third
  record (5 linear nodes, 32,768 cells); `/exp_trans_10` the same in
  frozen_exp's (10 EXP_TRANS nodes); `/exp_trans_3`, `_18`, `_50` in
  frozen_exp's configuration with its node count replaced, 4,096 cells
  (the smoke's rows), each with the step's NOFLUX and again with the
  other.

For each: CUDA-event milliseconds a call over --reps calls back to back
(`chip_smoke.cuda_ms`, the wrapper included), and the device's busy
milliseconds and events of each of five calls traced one at a time
(`tools/profile_fd_surface.py`'s `_profiled`; their median). --cases
keeps the cases whose names start with one of the prefixes.

--dump writes each case's arguments and outputs; --against reads such a
file (another checkout's) and runs this checkout's kernels on its
arguments, counting the output elements that differ bit for bit (NaN
equal to NaN).

Prints the card's name and power limit and, as its last line, one JSON
object with every number (also written to --out).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

sys.path.insert(0, os.getcwd())
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

NODE_CELLS = 4096       # chip_smoke.NODE_COUNT_CELLS
NODE_COUNTS = (3, 18, 50)


def flat(x):
    """The tensors of an output, in order."""
    import torch
    if isinstance(x, torch.Tensor):
        return [x]
    if x is None or isinstance(x, (int, float)):
        return []
    return [t for y in x for t in flat(y)]


def differing(mine, theirs):
    """Output elements of `mine` that differ from `theirs` bit for bit."""
    import torch
    n = 0
    for a, b in zip(mine, theirs):
        a, b = a.cpu().float(), b.float()
        n += int((~((a == b) | (torch.isnan(a) & torch.isnan(b)))).sum())
    return n


def mapped(obj, fn):
    """obj (tensors, NamedTuples, dataclasses, lists and dicts of them)
    with fn applied to each tensor."""
    import dataclasses

    import torch
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: mapped(getattr(obj, f.name), fn)
            for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*[mapped(x, fn) for x in obj])
    if isinstance(obj, (tuple, list)):
        return type(obj)(mapped(x, fn) for x in obj)
    if isinstance(obj, dict):
        return {key: mapped(v, fn) for key, v in obj.items()}
    return obj


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", nargs="*", default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--dump", default=None)
    ap.add_argument("--against", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    import chip_smoke
    from profile_fd_surface import _profiled
    from profile_lane_brent import ptxas_registers
    from vic_tpu_torch import kernels
    from vic_tpu_torch.kernels import build

    device = chip_smoke.device_phase()
    _, log = build.build(extra_flags=("-Xptxas", "-v"))
    build.load()
    result = {"root": os.getcwd(), "card": chip_smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]}
    result["ptxas"] = {k: v for k, v in ptxas_registers(log).items()
                       if any(n in k for n in ("lake_water_balance",
                                               "lake_depth",
                                               "implicit_profile"))}
    for k, v in sorted(result["ptxas"].items()):
        print(f"  ptxas {k}: {v[0]} registers, {v[1]} B spill stores"
              + (f", {v[2]} B stack frame" if len(v) > 2 else ""))

    def wanted(label):
        return args.cases is None or any(label.startswith(p)
                                         for p in args.cases)

    def touches(kernel):
        return args.cases is None or any(
            p.startswith(kernel) or kernel.startswith(p) for p in args.cases)

    cap = chip_smoke.capture_kernel_args
    cases = {}
    if touches("lake_"):
        lakes = cap("lakes", ("lake_water_balance", "lake_depth"), device,
                    record=chip_smoke.LAKES_RECORD)
        heavy = cap("heavy", ("lake_water_balance",), device,
                    record=chip_smoke.HEAVY_RECORD)
        cases = {"lake_water_balance/lakes": ("lake_water_balance",
                                              *lakes["lake_water_balance"]),
                 "lake_water_balance/heavy": ("lake_water_balance",
                                              *heavy["lake_water_balance"]),
                 "lake_depth/lakes": ("lake_depth", *lakes["lake_depth"])}
    profiles = {}
    if touches("implicit_profile"):
        profiles = {"frozen_5": cap("frozen", ("node_sweep",), device,
                                    record=chip_smoke.FROZEN_RECORD),
                    "exp_trans_10": cap("frozen_exp", ("node_sweep",),
                                        device,
                                        record=chip_smoke.FROZEN_RECORD)}
        for nn in NODE_COUNTS:
            profiles[f"exp_trans_{nn}"] = cap(
                "frozen_exp", ("node_sweep",), device,
                record=chip_smoke.FROZEN_RECORD,
                build=chip_smoke.node_count_build(nn), cells=NODE_CELLS)
    for label, captured in profiles.items():
        a, kw = captured["node_sweep"]
        for noflux in (kw["noflux"], not kw["noflux"]):
            tag = "" if noflux == kw["noflux"] else f"/noflux={noflux}"
            cases[f"implicit_profile/{label}{tag}"] = (
                "implicit_profile", a,
                dict(dt_sec=kw["dt_sec"], noflux=noflux,
                     frozen=kw["frozen"]))

    def timed(label, fn):
        out = fn()
        torch.cuda.synchronize()
        busy = [_profiled({label: fn})[1][label] for _ in range(5)]
        row = {"cuda_event_ms": chip_smoke.cuda_ms(fn, args.reps),
               "device_busy_ms": statistics.median(
                   b["device_busy_ms"] for b in busy),
               "device_events": max(b["device_events"] for b in busy)}
        print(f"  {label}: CUDA events {row['cuda_event_ms']:.4f} ms, "
              f"device busy {row['device_busy_ms']:.4f} ms in "
              f"{row['device_events']} events", flush=True)
        return out, row

    dumped = {}
    cases = {k: v for k, v in cases.items() if wanted(k)}
    for label, (name, a, kw) in cases.items():
        fn = getattr(kernels, name)
        out, result[label] = timed(label, lambda: fn(*a, **kw))
        dumped[label] = {"args": mapped((a, kw), lambda t: t.cpu()),
                         "flat": [t.cpu() for t in flat(out)]}
    if args.dump:
        os.makedirs(os.path.dirname(os.path.abspath(args.dump)),
                    exist_ok=True)
        torch.save(dumped, args.dump)
    if args.against:
        other = torch.load(args.against, weights_only=False)
        for label, theirs in other.items():
            name = label.split("/")[0]
            a, kw = mapped(theirs["args"], lambda t: t.to(device))
            out = getattr(kernels, name)(*a, **kw)
            torch.cuda.synchronize()
            n = differing(flat(out), theirs["flat"])
            print(f"  {label} on {args.against}'s arguments: {n} elements "
                  f"differ", flush=True)
            result.setdefault(label, {})["differing_from_against"] = n
    text = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
