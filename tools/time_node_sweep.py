"""K6 (the frozen-soil node sweep) timed at several node counts on one
NVIDIA GPU.

    cd <checkout> && python3 <path>/tools/time_node_sweep.py
        [--nodes 3 10 18 50] [--cells 4096 32768] [--reps 20]

The script builds and imports the kernels, `vic_tpu_torch` and
`chip_smoke` of the checkout it is run from (the working directory, not
the script's own tree), so two versions of K6 are compared on one card by
running it from each checkout's root in turn. For each cell count and
node count, K6 runs on the arguments of its first call in the third
record of frozen_exp's configuration (EXP_TRANS, SPATIAL_FROST) with its
node count replaced (`chip_smoke.capture_kernel_args`; the profile at the
surface root, K7 running its own sweeps inside its launch), timed with
CUDA events over `--reps` calls after one warm-up call.

Prints the card's name and power limit, ptxas' registers and spills of
every kernel, and as its last line one JSON object
{"<cells>x<nodes>": milliseconds a call, ...}.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.getcwd())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, nargs="+", default=[3, 10, 18, 50])
    ap.add_argument("--cells", type=int, nargs="+", default=[4096, 32768])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import chip_smoke
    from vic_tpu_torch import kernels

    device = chip_smoke.device_phase()
    chip_smoke.build_phase()
    times = {}
    for cells in args.cells:
        for nnode in args.nodes:
            (sweep_args, sweep_kwargs), = chip_smoke.capture_kernel_args(
                "frozen_exp", ("node_sweep",), device,
                record=chip_smoke.FROZEN_RECORD,
                build=chip_smoke.node_count_build(nnode),
                cells=cells).values()
            ms = chip_smoke.cuda_ms(
                lambda: kernels.node_sweep(*sweep_args, **sweep_kwargs),
                reps=args.reps)
            times[f"{cells}x{nnode}"] = ms
            print(f"  {cells} cells x {nnode} nodes: {ms:.4f} ms a call",
                  flush=True)
    print(json.dumps(times))


if __name__ == "__main__":
    main()
