"""The kernels' rows of chip_smoke.py (phases 0-2) of one checkout, on one
NVIDIA GPU.

    cd <checkout> && python3 <path>/tools/kernel_rows.py [--rows ROW ...]
        [--out FILE.json]

Runs the checkout's own `chip_smoke.device_phase`, `build_phase` and
`kernels_phase`: every kernel row built from the checkout's sources, held
against its plain version on the arguments a step gave it, timed with CUDA
events and given its bound (with --rows, only those rows of its ROWS, and
their kernels' other steps of ALSO_ON). Two trees unpacked side by side
compare on one card when it is run from each root in turn (parent,
change, change, parent), the parent's two runs giving the spread. Prints
the card's name and power limit and, as its last line, {"card": ...,
"rows": {row: {ms, plain_ms, bound_ms, bound_by, max_abs_err}}} (also
written to --out).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.getcwd())


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

    device = chip_smoke.device_phase()
    regs = chip_smoke.build_phase()
    # a checkout whose build phase returns nothing takes no registers
    results = (chip_smoke.kernels_phase(device) if regs is None
               else chip_smoke.kernels_phase(device, regs))
    card = chip_smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")
    text = json.dumps({"root": os.getcwd(), "card": card, "rows": {
        row: {k: r[k] for k in keys} for row, r in results.items()}})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
