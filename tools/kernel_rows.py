"""The kernels' rows of chip_smoke.py (phases 0-2) of one checkout, on one
NVIDIA GPU, with each kernel's device time.

    cd <checkout> && python3 <path>/tools/kernel_rows.py [--rows ROW ...]
        [--out FILE.json]

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
Prints the card's name and power limit and, as its last line, {"card":
..., "rows": {row: {ms, plain_ms, bound_ms, bound_by, max_abs_err,
device_busy_ms, device_events, device_idle_ms}}} (also written to --out).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.getcwd())
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", nargs="*", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import chip_smoke
    if args.rows is not None:
        chip_smoke.ROWS = {r: chip_smoke.ROWS[r] for r in args.rows}
        names = {k[0] for k in chip_smoke.ROWS.values()}
        chip_smoke.ALSO_ON = {k: v for k, v in chip_smoke.ALSO_ON.items()
                              if k in names}

    from profile_fd_surface import _profiled

    # every call chip_smoke times, with the time it gave and its device
    # numbers: a row's kernel call is the one whose time is the row's `ms`
    timed, cuda_ms = [], chip_smoke.cuda_ms

    def logged(fn, reps):
        ms = cuda_ms(fn, reps)
        timed.append((ms, _profiled({"call": fn})[1]["call"]))
        return ms

    chip_smoke.cuda_ms = logged
    device = chip_smoke.device_phase()
    regs = chip_smoke.build_phase()
    # a checkout whose build phase returns nothing takes no registers
    results = (chip_smoke.kernels_phase(device) if regs is None
               else chip_smoke.kernels_phase(device, regs))
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
    text = json.dumps({"root": os.getcwd(), "card": card, "rows": rows})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
