"""The Brent kernels on csrc/lane_brent.cuh's driver and K4 on one NVIDIA
GPU: K14 (the CLOSE_ENERGY surface Brent), K3 (the canopy foliage Brent),
K5 (the QUICK_FLUX surface Brent), K2 (the snowpack Brent), K1 (the
glacier Brent) and K4 (the hourly runoff loop), each call split into the
wrapper's host time and the device's time, the Brent lanes' residual
evaluations read from the kernel's own outputs; and the two step functions
around K1 and K4 (`glacier_ablation`, `runoff_step`) as the step calls
them, glue included.

    cd <checkout> && python3 <path>/tools/profile_lane_brent.py
        [--cells 32768] [--heavy-cells 8192] [--reps 20]
        [--dump FILE.pt] [--against FILE.pt] [--out FILE.json]

Like tools/profile_fd_surface.py it builds and imports the kernels,
`vic_tpu_torch` and `chip_smoke` of the checkout it is run from, so two
trees are compared on one card by running it from each root in turn.
Cases, each on the arguments of the kernel's (or function's) first call in
that step (`chip_smoke.capture_kernel_args`):

- K14 in heavy_nolakes' fourth record (its first CLOSE_ENERGY pass),
  `--heavy-cells` cells;
- K3 in the same record, and in light's first record, `--cells` cells;
- K5 in light's first record and blowing_close's fourth (its first
  CLOSE_ENERGY pass), `--cells` cells;
- K2 and K1 in light's first record (`--cells` cells) and heavy_nolakes'
  fourth (`--heavy-cells`);
- K4 in light's first record and heavy_nolakes' fourth, where its first
  call is the wet column's and its second the dry column's (DIST_PRCP);
- `glacier_ablation` and `runoff_step` (both columns) on the same records.

For each: the wrapper's host time (call to return, no synchronize) and
the call's (call to synchronize), medians of `--reps` calls after a
warm-up; CUDA-event milliseconds a call over `--reps` calls back to back,
as chip_smoke.cuda_ms takes them; one call under torch.profiler: the
device's busy and idle milliseconds and its launches (kernels, memsets and
copies). For the Brent kernels, from their outputs: the active and
bracketed lanes, the residual evaluations a lane (2 + the Brent iterations
on a bracketed lane, 2 + 2 x max_tries on an active lane that never
brackets; a bracketed lane's expansion rounds are not in the outputs and
not counted), their mean, p99 and max, the warp efficiency of consecutive
lanes in warps of 32 (sum of evaluations / sum over warps of 32 x the
warp's most), and the waves: lanes / the threads the card keeps resident
at the registers ptxas reports for the kernel's instance (K4's too). K2's
and K1's solved lanes are their `active` argument where the caller forms
the 0 C melt test (the kernels' callers before the kernels took the test
over), else `active` less the lanes whose balance melts at 0 C (the
kernel's `melt_cond`) and, for K2, those whose pack is thin
(surface_swq <= MIN_SWQ_EB_THRES).

--dump writes each case's root, converged, bracketed and iterations, its
solved lanes and a digest of the arguments both kernel forms take (K1's
and K2's `active` left out), and, for K1 and the two functions, the
arguments themselves and every float, int and bool output; --against reads
such a file (another checkout's) and counts the lanes whose solved flag
differs and, of the lanes both solve or neither, those whose root,
converged, bracketed or iterations differ bit for bit, after checking that
both runs captured the same arguments; and runs this checkout's K1 and
functions again on the other run's arguments (K1's `active` as the
other run passed it: a lane it left out stays out), giving the lanes whose
Brent outputs differ bit for bit and each output's largest difference.

Prints the card's name and power limit and, as its last line, one JSON
object with every number (also written to --out).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import sys

sys.path.insert(0, os.getcwd())
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from profile_fd_surface import _event_ms, _host_ms, _profiled  # noqa: E402

# H100 SXM: SMs, 32-bit registers an SM, resident warps and blocks an SM
SMS, SM_REGISTERS, SM_WARPS, SM_BLOCKS = 132, 65536, 64, 32
REG_UNIT = 256                      # registers are granted a warp at a time
WARP = 32


def resident_threads(registers, block):
    """Threads of `block`-thread blocks the card keeps resident at
    `registers` registers a thread."""
    per_warp = -(-registers * WARP // REG_UNIT) * REG_UNIT
    warps = min(SM_REGISTERS // per_warp, SM_WARPS)
    blocks = min(warps // (block // WARP), SM_BLOCKS)
    return blocks * block * SMS


def ptxas_registers(log):
    """{mangled kernel name: (registers, spill store bytes, stack frame
    bytes)} from nvcc's -Xptxas -v output."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        if not name:
            continue
        regs, spill, frame = out.get(name, (0, 0, 0))
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m:
            frame, spill = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs = int(m.group(1))
        out[name] = (regs, spill, frame)
    return out


# the names a kernel's instances carry: one thread a lane, or its lane type
# on lane_brent.cuh's driver
KERNEL_NAMES = {"canopy_brent": ("canopy_brent", "CanopyLane"),
                "snowpack_brent": ("snowpack_brent", "SnowpackLane"),
                "glacier_brent": ("glacier_brent_kernel", "GlacierLane"),
                "runoff_hourly": ("runoff_hourly_kernel",),
                "affine_surface_brent": ("affine_surface_brent",
                                         "AffineLane"),
                "surface_brent": ("surface_brent_kernel", "SurfaceLane")}


def instance_registers(regs, name, eb_kwargs, nl=None):
    """(registers, spill bytes, mangled name) of the instance of `name`'s
    kernel that a call with these arguments launches (K4's: the one of
    `nl` layers)."""
    names = KERNEL_NAMES[name]
    keys = [k for k in regs if any(n in k for n in names)]
    if eb_kwargs is not None:
        nl = eb_kwargs["root"].shape[-1]
        dist = eb_kwargs.get("dist_dry") is not None
        tag = f"ILi{nl}ELb{int(dist)}E"
        keys = [k for k in keys if tag in k]
    elif nl is not None:
        keys = [k for k in keys if f"ILi{nl}E" in k]
    if not keys:
        return None, None, None
    key = sorted(keys)[0]
    return regs[key][0], regs[key][1], key


def evaluations(active, out, max_tries):
    import torch
    act = active.expand(out.root.shape)
    return torch.where(out.bracketed, 2 + out.iterations.long(),
                       torch.where(act, 2 + 2 * max_tries, 0)).reshape(-1)


def solved_lanes(name, active, kw, out):
    """The lanes a call solves: `active`, less K2's and K1's lanes that
    melt at 0 C (and K2's thin packs) where the kernel forms the melt test
    (its result carries melt_cond)."""
    import torch
    if active is None:
        active = torch.ones((), dtype=torch.bool, device=out.root.device)
    act = active.expand(out.root.shape)
    if name in ("snowpack_brent", "glacier_brent") \
            and hasattr(out, "melt_cond"):
        act = act & ~out.melt_cond
    if name == "snowpack_brent" and hasattr(out, "melt_cond"):
        from vic_tpu_torch.constants import MIN_SWQ_EB_THRES
        act = act & ~(kw["surface_swq"] <= MIN_SWQ_EB_THRES)
    return act


def common_args(name, a, kw):
    """The arguments both forms of a kernel take: K2's and K1's without
    `active` (the solved lanes where the caller forms the melt test, the
    mask where the kernel does)."""
    if name in ("snowpack_brent", "glacier_brent"):
        return a[:2], kw
    return a, kw


def warp_efficiency(evals):
    import torch
    pad = (-evals.numel()) % WARP
    w = torch.cat([evals, evals.new_zeros(pad)]).reshape(-1, WARP)
    spent = float(w.amax(1).sum()) * WARP
    return float(evals.sum()) / spent if spent else 1.0


def digest(obj):
    """sha1 of every tensor's bytes in `obj`, in order."""
    import torch
    h = hashlib.sha1()

    def walk(x):
        if isinstance(x, torch.Tensor):
            h.update(str((x.dtype, tuple(x.shape))).encode())
            h.update(x.detach().contiguous().cpu().numpy().tobytes())
        elif isinstance(x, dict):
            for k in sorted(x):
                h.update(str(k).encode())
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, (int, float, bool, str)) or x is None:
            h.update(repr(x).encode())
    walk(obj)
    return h.hexdigest()


def flat_outputs(out):
    """The float and bool tensors of a result, named by their path in it:
    {name: tensor} (a NamedTuple's fields by name, a tuple's by index)."""
    import torch
    flat = {}

    def walk(x, path):
        if isinstance(x, torch.Tensor):
            if x.dtype in (torch.float32, torch.bool, torch.int32):
                flat[path] = x
        elif isinstance(x, tuple):
            names = getattr(x, "_fields", None) or range(len(x))
            for k, v in zip(names, x):
                walk(v, f"{path}.{k}" if path else str(k))
    walk(out, "")
    return flat


# the cases whose arguments and outputs --dump keeps, so that another
# checkout's kernel and functions run again on them (--against): K1, whose
# arguments both forms take, and the functions around K1 and K4
REPLAYED = ("glacier_brent", "glacier_ablation", "runoff_step")


def replay(label, fn, theirs, device):
    """This checkout's `fn` on another run's arguments against that run's
    outputs: lanes whose Brent outputs differ bit for bit (K1), and each
    float output's largest difference."""
    import torch
    a, kw = theirs["args"]

    def move(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        if isinstance(x, dict):
            return {k: move(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(move(v) for v in x)
        return x

    out = fn(*move(a), **move(kw))
    torch.cuda.synchronize()
    mine = {k: v.cpu() for k, v in flat_outputs(out).items()}
    result = {"largest_difference": {}}
    for k, y in theirs["flat"].items():
        x = mine.get(k)
        if x is None or x.shape != y.shape:
            continue
        if x.dtype == torch.float32:
            both = ~torch.isnan(x) & ~torch.isnan(y)
            d = torch.where(both, (x - y).abs(), 0.0)
            result["largest_difference"][k] = float(d.max()) if d.numel() \
                else 0.0
            result.setdefault("nan_apart", 0)
            result["nan_apart"] += int((torch.isnan(x)
                                        != torch.isnan(y)).sum())
        else:
            result["largest_difference"][k] = int((x != y).sum())
    if "root" in mine and "root" in theirs["flat"]:
        differ = torch.zeros(mine["root"].shape, dtype=torch.bool)
        for k in ("root", "converged", "bracketed", "iterations"):
            x, y = mine[k], theirs["flat"][k]
            if x.dtype == torch.float32:
                x, y = x.view(torch.int32), y.view(torch.int32)
            differ |= x != y
        result["differing_lanes"] = int(differ.sum())
    print(f"  {label} on {theirs['root']}'s arguments: "
          + json.dumps(result), flush=True)
    return result


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
    from vic_tpu_torch import kernels, model
    from vic_tpu_torch.kernels import build
    from vic_tpu_torch.ops.rootfind import MAXTRIES

    device = chip_smoke.device_phase()
    _, log = build.build(extra_flags=("-Xptxas", "-v"))
    regs = ptxas_registers(log)
    build.load()
    result = {"root": os.getcwd(), "card": chip_smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]}
    fns = ("glacier_ablation", "runoff_step")
    second = {"runoff_hourly": (1,), "runoff_step": (1,)}
    heavy = chip_smoke.capture_kernel_args(
        "heavy_nolakes", ("affine_surface_brent", "canopy_brent",
                          "snowpack_brent", "glacier_brent",
                          "runoff_hourly") + fns, device,
        record=chip_smoke.HEAVY_RECORD, cells=args.heavy_cells, also=second)
    light = chip_smoke.capture_kernel_args(
        "light", ("canopy_brent", "surface_brent", "snowpack_brent",
                  "glacier_brent", "runoff_hourly") + fns, device,
        cells=args.cells)
    blowing = chip_smoke.capture_kernel_args(
        "blowing_close", ("surface_brent",), device,
        record=chip_smoke.BLOWING_RECORD, cells=args.cells)
    cases = {"affine_surface_brent/heavy_nolakes":
             heavy["affine_surface_brent"],
             "canopy_brent/heavy_nolakes": heavy["canopy_brent"],
             "canopy_brent/light": light["canopy_brent"],
             "surface_brent/light": light["surface_brent"],
             "surface_brent/blowing_close": blowing["surface_brent"],
             "snowpack_brent/light": light["snowpack_brent"],
             "snowpack_brent/heavy_nolakes": heavy["snowpack_brent"],
             "glacier_brent/light": light["glacier_brent"],
             "glacier_brent/heavy_nolakes": heavy["glacier_brent"],
             "runoff_hourly/light": light["runoff_hourly"],
             "runoff_hourly/heavy_nolakes_wet": heavy["runoff_hourly"],
             "runoff_hourly/heavy_nolakes_dry": heavy["runoff_hourly@1"],
             "glacier_ablation/light": light["glacier_ablation"],
             "glacier_ablation/heavy_nolakes": heavy["glacier_ablation"],
             "runoff_step/light": light["runoff_step"],
             "runoff_step/heavy_nolakes_wet": heavy["runoff_step"],
             "runoff_step/heavy_nolakes_dry": heavy["runoff_step@1"]}

    def fn_of(name):
        return getattr(model if name in fns else kernels, name)

    calls, dumped = {}, {}
    for label, (a, kw) in cases.items():
        name = label.split("/")[0]
        fn = fn_of(name)

        def call(fn=fn, a=a, kw=kw):
            return fn(*a, **kw)

        out = call()
        torch.cuda.synchronize()
        wrapper_ms, call_ms = _host_ms(call, args.reps)
        calls[label] = call
        case = {"wrapper_host_ms": wrapper_ms, "call_ms": call_ms,
                "cuda_event_ms": _event_ms(call, args.reps)}
        dumped[label] = {"root": os.getcwd()}
        if name in REPLAYED:
            dumped[label].update(
                args=chip_smoke.clone_args((a, kw)),
                flat={k: v.cpu() for k, v in flat_outputs(out).items()})
            dumped[label]["args"] = (
                [x.cpu() if isinstance(x, torch.Tensor) else x
                 for x in dumped[label]["args"][0]],
                {k: v.cpu() if isinstance(v, torch.Tensor) else v
                 for k, v in dumped[label]["args"][1].items()})
        if name == "runoff_hourly":
            nl = a[0].shape[-1]
            lanes = a[0][..., 0].numel()
            n_reg, spill, kname = instance_registers(
                regs, "runoff_hourly", None, nl)
        elif name in fns:
            n_reg = spill = kname = None
            lanes = None
        else:
            lanes = out.root.numel()
            act = solved_lanes(name, a[2], kw, out)
            evals = evaluations(act, out, kw.get("max_tries", MAXTRIES))
            n_reg, spill, kname = instance_registers(regs, name,
                                                     kw.get("eb_kwargs"))
            live = evals[evals > 0].double()
            case.update({
                "active": int(act.sum()),
                "bracketed": int(out.bracketed.sum()),
                "evals_mean_active": (float(live.mean()) if live.numel()
                                      else 0.0),
                "evals_p99_active": (float(torch.quantile(live, 0.99))
                                     if live.numel() else 0.0),
                "evals_max": int(evals.max()),
                "evals_sum": int(evals.sum()),
                "warp_efficiency": warp_efficiency(evals),
                "args_digest": digest(common_args(name, a, kw))})
            dumped[label].update(
                digest=case["args_digest"],
                out=[t.cpu() for t in tuple(out)[:4]], solved=act.cpu(),
                evals=evals.cpu())
        resident = resident_threads(n_reg, 128) if n_reg else None
        case.update({
            "lanes": lanes, "kernel_instance": kname,
            "ptxas_registers": n_reg, "ptxas_spill_store_bytes": spill,
            "resident_threads_at_128": resident,
            "waves": lanes / resident if resident and lanes else None})
        result[label] = case
    _, prof = _profiled(calls)
    for label in cases:
        case = result[label]
        case.update({k: prof[label][k] for k in
                     ("device_events", "device_busy_ms", "device_span_ms",
                      "device_idle_ms", "by_kernel")})
        lanes = ""
        if "active" in case:
            lanes = (f"lanes {case['lanes']}, active {case['active']}, "
                     f"bracketed {case['bracketed']}; evaluations a lane "
                     f"mean {case['evals_mean_active']:.3f} (active lanes),"
                     f" p99 {case['evals_p99_active']:.1f}, max "
                     f"{case['evals_max']}; warp efficiency "
                     f"{case['warp_efficiency']:.4f}; ")
        print(f"  {label}: {lanes}ptxas {case['ptxas_registers']} "
              f"registers, {case['ptxas_spill_store_bytes']} B spill "
              f"stores; waves {case['waves']}; wrapper "
              f"{case['wrapper_host_ms']:.4f} ms on the host, call "
              f"{case['call_ms']:.4f} ms, CUDA events "
              f"{case['cuda_event_ms']:.4f} ms, device busy "
              f"{case['device_busy_ms']:.4f} ms in "
              f"{case['device_events']} events, idle "
              f"{case['device_idle_ms']:.4f} ms", flush=True)
    if args.dump:
        os.makedirs(os.path.dirname(os.path.abspath(args.dump)),
                    exist_ok=True)
        torch.save(dumped, args.dump)
    if args.against:
        other = torch.load(args.against, weights_only=False)
        for label, mine in dumped.items():
            theirs = other.get(label)
            if theirs is None:
                continue
            name = label.split("/")[0]
            against = {}
            if "out" in mine and "out" in theirs:
                same_args = theirs["digest"] == mine["digest"]
                differ = torch.zeros(mine["out"][0].shape, dtype=torch.bool)
                for x, y in zip(mine["out"], theirs["out"]):
                    # bit for bit, NaN included
                    if x.dtype == torch.float32:
                        x, y = x.view(torch.int32), y.view(torch.int32)
                    differ |= x != y
                flips = mine["solved"] != theirs.get("solved",
                                                     mine["solved"])
                against = {"same_arguments": same_args,
                           "solved_flag_differs": int(flips.sum()),
                           "differing_lanes": int((differ & ~flips).sum())}
                print(f"  {label} against {args.against}: same arguments "
                      f"{same_args}, lanes solved in one run only: "
                      f"{int(flips.sum())}, lanes solved in both or "
                      f"neither whose root, converged, bracketed or "
                      f"iterations differ: {against['differing_lanes']}",
                      flush=True)
            if "args" in theirs:
                against["replayed"] = replay(label, fn_of(name), theirs,
                                             device)
            result[label]["against"] = against
    text = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
