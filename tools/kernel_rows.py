"""The kernels' rows of chip_smoke.py (phases 0-2) of one checkout, on one
NVIDIA GPU, with each kernel's device time.

    cd <checkout> && python3 <path>/tools/kernel_rows.py [--rows ROW ...]
        [--out FILE.json] [--dump F.pt | --against F.pt]

Runs the checkout's own `chip_smoke.device_phase`, `build_phase` and
`kernels_phase`: every kernel row built from the checkout's sources, held
against its plain version on the arguments a step gave it, timed with CUDA
events and given its bound (with --rows, only those rows of its ROWS, and
their kernels' other steps of ALSO_ON). Two trees unpacked side by side
compare on one card when it is run from each root in turn (parent,
change, change, parent), the parent's two runs giving the spread. Each
call chip_smoke.cuda_ms times is run once more under torch.profiler
(tools/profile_fd_surface.py's `_profiled`), and a row's kernel call, the
one whose time is the row's `ms`, gives the row its device busy
milliseconds, device events and idle milliseconds, the wrapper left out.

The loop kernels' rows (K15-K17, chip_smoke.check_loop_kernel) also keep
every output the kernel gave in each comparison with its plain version,
and a digest of the row's arguments; with a bisection row, K17 also runs
on K2's arguments in the spatial_snow step's second record. --dump saves
them; --against counts, output by output, the elements that differ bit
for bit from a dump of another checkout (NaN payloads included) and says
whether the arguments were the same (null for the comparisons whose
arguments were formed from their row's).

Prints the card's name and power limit and, as its last line, {"card":
..., "rows": {row: {ms, plain_ms, bound_ms, bound_by, max_abs_err,
device_busy_ms, device_events, device_idle_ms}}, "ptxas": {kernel:
[registers, spill store bytes, stack frame bytes]}, "bits": {comparison:
{"args_equal": ..., "differing": [...], "elements": [...]}}} (also written
to --out).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.getcwd())
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def differing(a, b):
    """Elements of two tensors that differ bit for bit."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return a.numel()
    if a.dtype == torch.float32:
        a, b = a.contiguous().view(torch.int32), b.contiguous().view(
            torch.int32)
    return int((a != b).sum())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", nargs="*", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--dump", default=None)
    ap.add_argument("--against", default=None)
    args = ap.parse_args(argv)

    import torch

    import chip_smoke
    if args.rows is not None:
        chip_smoke.ROWS = {r: chip_smoke.ROWS[r] for r in args.rows}
        names = {k[0] for k in chip_smoke.ROWS.values()}
        chip_smoke.ALSO_ON = {k: v for k, v in chip_smoke.ALSO_ON.items()
                              if k in names}

    from profile_fd_surface import _profiled
    from profile_lane_brent import digest

    # every call chip_smoke times, with the time it gave and its device
    # numbers: a row's kernel call is the one whose time is the row's `ms`
    timed, cuda_ms = [], chip_smoke.cuda_ms

    def logged(fn, reps):
        ms = cuda_ms(fn, reps)
        timed.append((ms, _profiled({"call": fn})[1]["call"]))
        return ms

    # the loop kernels' outputs in each comparison, and their arguments
    outputs, digests = {}, {}
    compare_loop, loop_args = chip_smoke.compare_loop, chip_smoke.loop_args

    def kept(row, name, kern, plain):
        outputs[row] = [t.detach().cpu().clone() for t in kern
                        if torch.is_tensor(t)]
        return compare_loop(row, name, kern, plain)

    def args_of(row, name, captured):
        got = loop_args(row, name, captured)
        digests[row] = digest(got)
        return got

    chip_smoke.cuda_ms = logged
    chip_smoke.compare_loop = kept
    chip_smoke.loop_args = args_of
    device = chip_smoke.device_phase()
    regs = chip_smoke.build_phase()
    # a checkout whose build phase returns nothing takes no registers
    results = (chip_smoke.kernels_phase(device) if regs is None
               else chip_smoke.kernels_phase(device, regs))
    if any(k[0] == "bisection" for k in chip_smoke.ROWS.values()):
        from vic_tpu_torch import kernels
        from vic_tpu_torch.physics.bisection import bisection_plain
        label = "bisection/snowpack (spatial_snow record " \
            f"{chip_smoke.SPATIAL_SNOW_RECORD})"
        captured = chip_smoke.capture_kernel_args(
            "spatial_snow", ("snowpack_brent",), device,
            record=chip_smoke.SPATIAL_SNOW_RECORD)
        a, kw = loop_args("bisection/snowpack", "bisection", captured)
        digests[label] = digest((a, kw))
        kept(label, "bisection", kernels.bisection(*a, **kw),
             bisection_plain(*a, **kw))
    card = chip_smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    prof = {row: next(p for ms, p in timed if ms == r["ms"])
            for row, r in results.items()}
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")
    dev = ("device_busy_ms", "device_events", "device_idle_ms")
    rows = {row: dict({k: r[k] for k in keys},
                      **{k: prof[row][k] for k in dev})
            for row, r in results.items()}
    for row, r in rows.items():
        print(f"  {row}: kernel {r['ms']:.4f} ms (CUDA events, wrapper "
              f"included), device busy {r['device_busy_ms']:.4f} ms in "
              f"{r['device_events']} events, bound {r['bound_ms']:.4f} ms",
              flush=True)
    if args.dump:
        torch.save({"outputs": outputs, "digests": digests}, args.dump)
    bits = {}
    if args.against:
        theirs = torch.load(args.against)
        for row in sorted(set(outputs) & set(theirs["outputs"])):
            mine, other = outputs[row], theirs["outputs"][row]
            # None where the comparison's arguments were formed from its
            # row's (K15's seeded storage and table path)
            bits[row] = dict(
                args_equal=(digests[row] == theirs["digests"].get(row)
                            if row in digests else None),
                differing=[differing(a, b) for a, b in zip(mine, other)],
                elements=[t.numel() for t in mine])
            print(f"  {row}: against {args.against}: {bits[row]}",
                  flush=True)
        only = sorted(set(outputs) ^ set(theirs["outputs"]))
        if only:
            print(f"  compared in one checkout only: {only}", flush=True)
    text = json.dumps({"root": os.getcwd(), "card": card, "rows": rows,
                       "ptxas": regs or {}, "bits": bits})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
