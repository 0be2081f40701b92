"""The control of a cell's check: the plain reference put in the program's
place and computed in bfloat16, the nearest precision below the float32
the configurations state, compared with the float32 reference by the
cell's own numbers and limits. It must come out not correct. Where the
check steps the block's last records from the program's own state, the
program runs one block to give that state to both.

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...]

prints one JSON line a seed with its numbers and verdict. It runs on the
card at the cell's own size (the compared cells and records of one block)
and is not part of a benchmark run. benchmark/tests/test_bench_check.py
keeps it at a size a test run holds.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def control_numbers(cfg: dict, traffic: dict, seed: int, device):
    """The compared numbers of the control against the reference at one
    seed. Where the check steps the block's last records from the
    program's own state, both step them from the program's state there."""
    from . import compare, gen
    domain, forcing = gen.cell_inputs(cfg, traffic, seed)
    cells = compare.check_cells(cfg, traffic, seed)
    n_rec = compare.check_records(cfg, traffic)
    tail = compare.check_tail(cfg, traffic)
    whole = n_rec == traffic["block_records"] or tail > 0
    start = (program_state_before(cfg, traffic, domain, forcing, device,
                                  cells) if tail else None)
    sides = []
    for lower in (False, True):
        out, final = compare.run_reference(cfg, traffic, domain, forcing,
                                           device, cells, n_rec, lower=lower)
        if tail:
            t_out, final = compare.run_reference(
                cfg, traffic, domain, forcing, device, cells, tail,
                lower=lower, first=traffic["block_records"] - tail,
                start=start)
            out = {k: np.concatenate([v, t_out[k]]) for k, v in out.items()}
        sides.append((out, final if whole else None))
    (ref_out, ref_final), (low_out, low_final) = sides
    return compare.numbers(low_out, ref_out, low_final, ref_final)


def program_state_before(cfg: dict, traffic: dict, domain, forcing, device,
                         cells):
    """The program's state before the block's last compared records, as
    one block of the timed path leaves it, as {field: array}."""
    import gc
    import torch
    from . import compare, harness
    if device.type == "cuda":
        from vic_tpu_torch.kernels import build
        build.load()
    cell = harness.Cell(cfg, traffic, domain, forcing, device, {})
    _, _, snap = cell.block()
    start = compare.state_arrays(snap, cells)
    del cell, snap
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return start


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    from . import compare, harness
    harness.check_card(1)
    _, _, cfg, traffic = harness.cell_spec(args.workload)
    for seed in args.seeds:
        nums = control_numbers(cfg, traffic, seed, torch.device("cuda"))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "numbers": nums,
                          "correct": compare.verdict(nums, cfg["limits"])}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from benchmark.control import main as _main
    sys.exit(_main(sys.argv[1:]))
