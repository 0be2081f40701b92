"""The Brent kernels on csrc/lane_brent.cuh's driver on one NVIDIA GPU: K14
(the CLOSE_ENERGY surface Brent), K3 (the canopy foliage Brent), K5 (the
QUICK_FLUX surface Brent) and K2 (the snowpack Brent), each call split into
the wrapper's host time and the device's time, and the lanes' residual
evaluations read from the kernel's own outputs.

    cd <checkout> && python3 <path>/tools/profile_lane_brent.py
        [--cells 32768] [--heavy-cells 8192] [--reps 20]
        [--dump FILE.pt] [--against FILE.pt] [--out FILE.json]

Like tools/profile_fd_surface.py it builds and imports the kernels,
`vic_tpu_torch` and `chip_smoke` of the checkout it is run from, so two
trees are compared on one card by running it from each root in turn.
Cases, each on the arguments of the kernel's first call in that step
(`chip_smoke.capture_kernel_args`):

- K14 in heavy_nolakes' fourth record (its first CLOSE_ENERGY pass),
  `--heavy-cells` cells;
- K3 in the same record, and in light's first record, `--cells` cells;
- K5 in light's first record and blowing_close's fourth (its first
  CLOSE_ENERGY pass), `--cells` cells;
- K2 in light's first record (`--cells` cells) and heavy_nolakes' fourth
  (`--heavy-cells`).

For each: the wrapper's host time (call to return, no synchronize) and
the call's (call to synchronize), medians of `--reps` calls after a
warm-up; CUDA-event milliseconds a call over `--reps` calls back to back,
as chip_smoke.cuda_ms takes them; one call under torch.profiler: the
device's busy and idle milliseconds. From the kernel's outputs: the
active and bracketed lanes, the residual evaluations a lane (2 + the Brent
iterations on a bracketed lane, 2 + 2 x max_tries on an active lane that
never brackets; a bracketed lane's expansion rounds are not in the outputs
and not counted), their mean, p99 and max, the warp efficiency of
consecutive lanes in warps of 32 (sum of evaluations / sum over warps of 32
x the warp's most), and the waves: lanes / the threads the card keeps
resident at the registers ptxas reports for the kernel's instance. K2's
solved lanes are its `active` argument where the caller forms the 0 C melt
test (the kernel's caller before the kernel took the test over), else
`active` less the lanes whose pack melts at 0 C (the kernel's `melt_cond`)
or is thin (surface_swq <= MIN_SWQ_EB_THRES).

--dump writes each case's root, converged, bracketed and iterations, its
solved lanes and a digest of the arguments both kernel forms take (K2's
`active` left out); --against reads such a
file (another checkout's) and counts the lanes whose solved flag differs
and, of the lanes both solve or neither, those whose root, converged,
bracketed or iterations differ bit for bit, after checking that both runs
captured the same arguments.

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
    """{mangled kernel name: (registers, spill store bytes)} from nvcc's
    -Xptxas -v output."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            out[name] = (out.get(name, (0, 0))[0], int(m.group(1)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)), out.get(name, (0, 0))[1])
    return out


# the names a kernel's instances carry: one thread a lane, or its lane type
# on lane_brent.cuh's driver
KERNEL_NAMES = {"canopy_brent": ("canopy_brent", "CanopyLane"),
                "snowpack_brent": ("snowpack_brent", "SnowpackLane"),
                "affine_surface_brent": ("affine_surface_brent",
                                         "AffineLane"),
                "surface_brent": ("surface_brent_kernel", "SurfaceLane")}


def instance_registers(regs, name, eb_kwargs):
    """(registers, spill bytes, mangled name) of the instance of `name`'s
    kernel that a call with these arguments launches."""
    names = KERNEL_NAMES[name]
    keys = [k for k in regs if any(n in k for n in names)]
    if eb_kwargs is not None:
        nl = eb_kwargs["root"].shape[-1]
        dist = eb_kwargs.get("dist_dry") is not None
        tag = f"ILi{nl}ELb{int(dist)}E"
        keys = [k for k in keys if tag in k]
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
    """The lanes a call solves: `active`, less K2's lanes that melt at 0 C
    or are thin where the kernel forms the melt test (its result carries
    melt_cond)."""
    import torch
    if active is None:
        active = torch.ones((), dtype=torch.bool, device=out.root.device)
    act = active.expand(out.root.shape)
    if name == "snowpack_brent" and hasattr(out, "melt_cond"):
        from vic_tpu_torch.constants import MIN_SWQ_EB_THRES
        thin = kw["surface_swq"] <= MIN_SWQ_EB_THRES
        act = act & ~out.melt_cond & ~thin
    return act


def common_args(name, a, kw):
    """The arguments both forms of a kernel take: K2's without `active`
    (the solved lanes where the caller forms the melt test, the mask where
    the kernel does)."""
    if name == "snowpack_brent":
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
    from vic_tpu_torch.ops.rootfind import MAXTRIES

    device = chip_smoke.device_phase()
    _, log = build.build(extra_flags=("-Xptxas", "-v"))
    regs = ptxas_registers(log)
    build.load()
    result = {"root": os.getcwd(), "card": chip_smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]}
    heavy = chip_smoke.capture_kernel_args(
        "heavy_nolakes", ("affine_surface_brent", "canopy_brent",
                          "snowpack_brent"), device,
        record=chip_smoke.HEAVY_RECORD, cells=args.heavy_cells)
    light = chip_smoke.capture_kernel_args(
        "light", ("canopy_brent", "surface_brent", "snowpack_brent"), device,
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
             "snowpack_brent/heavy_nolakes": heavy["snowpack_brent"]}
    calls, dumped = {}, {}
    for label, (a, kw) in cases.items():
        name = label.split("/")[0]
        fn = getattr(kernels, name)

        def call(fn=fn, a=a, kw=kw):
            return fn(*a, **kw)

        out = call()
        torch.cuda.synchronize()
        wrapper_ms, call_ms = _host_ms(call, args.reps)
        calls[label] = call
        lanes = out.root.numel()
        act = solved_lanes(name, a[2], kw, out)
        evals = evaluations(act, out, kw.get("max_tries", MAXTRIES))
        n_reg, spill, kname = instance_registers(regs, name,
                                                 kw.get("eb_kwargs"))
        resident = resident_threads(n_reg, 128) if n_reg else None
        live = evals[evals > 0].double()
        result[label] = {
            "lanes": lanes, "active": int(act.sum()),
            "bracketed": int(out.bracketed.sum()),
            "evals_mean_active": float(live.mean()) if live.numel() else 0.0,
            "evals_p99_active": (float(torch.quantile(live, 0.99))
                                 if live.numel() else 0.0),
            "evals_max": int(evals.max()),
            "evals_sum": int(evals.sum()),
            "warp_efficiency": warp_efficiency(evals),
            "kernel_instance": kname, "ptxas_registers": n_reg,
            "ptxas_spill_store_bytes": spill,
            "resident_threads_at_128": resident,
            "waves": lanes / resident if resident else None,
            "args_digest": digest(common_args(name, a, kw)),
            "wrapper_host_ms": wrapper_ms, "call_ms": call_ms,
            "cuda_event_ms": _event_ms(call, args.reps)}
        dumped[label] = {"digest": result[label]["args_digest"],
                         "out": [t.cpu() for t in tuple(out)[:4]],
                         "solved": act.cpu(), "evals": evals.cpu()}
    _, prof = _profiled(calls)
    for label in cases:
        case = result[label]
        case.update({k: prof[label][k] for k in
                     ("device_events", "device_busy_ms", "device_span_ms",
                      "device_idle_ms", "by_kernel")})
        print(f"  {label}: lanes {case['lanes']}, active {case['active']},"
              f" bracketed {case['bracketed']}; evaluations a lane mean "
              f"{case['evals_mean_active']:.3f} (active lanes), p99 "
              f"{case['evals_p99_active']:.1f}, max {case['evals_max']}; "
              f"warp efficiency {case['warp_efficiency']:.4f}; ptxas "
              f"{case['ptxas_registers']} registers, "
              f"{case['ptxas_spill_store_bytes']} B spill stores; waves "
              f"{case['waves']}; wrapper {case['wrapper_host_ms']:.4f} ms "
              f"on the host, call {case['call_ms']:.4f} ms, CUDA events "
              f"{case['cuda_event_ms']:.4f} ms, device busy "
              f"{case['device_busy_ms']:.4f} ms in "
              f"{case['device_events']} events, idle "
              f"{case['device_idle_ms']:.4f} ms", flush=True)
    if args.dump:
        os.makedirs(os.path.dirname(os.path.abspath(args.dump)),
                    exist_ok=True)
        torch.save(dumped, args.dump)
    if args.against:
        other = torch.load(args.against)
        for label, mine in dumped.items():
            theirs = other[label]
            same_args = theirs["digest"] == mine["digest"]
            differ = torch.zeros(mine["out"][0].shape, dtype=torch.bool)
            for x, y in zip(mine["out"], theirs["out"]):
                # bit for bit, NaN included
                if x.dtype == torch.float32:
                    x, y = x.view(torch.int32), y.view(torch.int32)
                differ |= x != y
            flips = mine["solved"] != theirs.get("solved", mine["solved"])
            result[label]["against"] = {
                "same_arguments": same_args,
                "solved_flag_differs": int(flips.sum()),
                "differing_lanes": int((differ & ~flips).sum())}
            print(f"  {label} against {args.against}: same arguments "
                  f"{same_args}, lanes solved in one run only: "
                  f"{int(flips.sum())}, lanes solved in both or neither "
                  f"whose root, converged, bracketed or iterations differ: "
                  f"{int((differ & ~flips).sum())}", flush=True)
    text = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
