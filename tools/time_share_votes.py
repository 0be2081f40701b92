"""K6 and K7 with and without a share group, timed on NVIDIA GPUs.

    cd <checkout> && python3 <path>/tools/time_share_votes.py
        [--cells 32768] [--reps 10] [--out out/share_votes.json]
        [--no-group] [--dump F.pt | --against F.pt]

Builds and imports the kernels, `vic_tpu_torch` and `chip_smoke` of the
checkout it is run from. Prints the card's name and power limit and
`nvidia-smi -L`; then, on the arguments of K6's and K7's first calls in the
third record of the frozen step (5 linear nodes; `chip_smoke.FROZEN_RECORD`)
and of frozen_exp's (10 EXP_TRANS nodes) at `--cells` cells:

- each kernel's one launch over the whole batch, CUDA events over `--reps`
  calls after a warm-up (no group: the path of a run on one device);
  and again waiting for each call, as a share's call does;
- the same batch as two shares of a `parallel.votes.ShareGroup` on the
  first card (two cooperative grids side by side, each on its own stream
  from its own thread, each of half the co-resident blocks), and as one
  share a card on every card where the host has two or more: each share's
  ms a call, CUDA events around `--reps` calls on its stream after a
  warm-up; on the first call each share's thread allocates fresh device
  memory just before its launch (a cudaMalloc while the other share's
  grid waits at its first vote, as a run's first record does), and every
  count and lane must equal the one launch's;
- a group of two whose second share never launches, with a 2 s limit: the
  first share's call must raise, naming the vote, within 30 s.

`--no-group` runs the one launches alone, so a checkout from before share
groups runs it too; `--built` loads the library as last built; `--dump`
saves their outputs and counts, `--against` counts the elements and
counts that differ from a dump (another checkout's: parent and change
compared bit for bit on one card).

The last line is one JSON object of those times (ms) and counts.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())


def split_ms(name, args, kwargs, devices, reps):
    """The batch as len(devices) shares of one ShareGroup, each share's
    thread calling its kernel reps + 1 times on its own stream (each call
    waits for its launch, as a split run's does), the first call just after
    a fresh allocation: (each share's ms a call from CUDA events around its
    last reps calls, the first call's results)."""
    import torch

    from vic_tpu_torch import kernels
    from vic_tpu_torch.parallel.votes import ShareGroup
    from vic_tpu_torch.testing import (cell_share, split_kernel_call,
                                       with_votes)

    def fresh(i):
        # a size no block of the caching allocator has: a cudaMalloc while
        # the other share's grid may be waiting at its first vote
        torch.empty((1 << 20) + 4096 * i, dtype=torch.uint8, device="cuda")
    first = split_kernel_call(name, args, kwargs, devices, before=fresh)
    n_cell = args[0].shape[0]
    k = n_cell // len(devices)
    group = ShareGroup(len(devices), devices)
    ms = [0.0] * len(devices)
    shares = [cell_share((args, kwargs), i * k, (i + 1) * k, n_cell, d)
              for i, d in enumerate(devices)]

    def job(i):
        a, kw = shares[i]
        kw = with_votes(name, kw, group.member(i))
        fn = getattr(kernels, name)
        with torch.cuda.device(devices[i]), torch.cuda.stream(
                torch.cuda.Stream(devices[i])):
            fn(*a, **kw)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn(*a, **kw)
            end.record()
            end.synchronize()
            ms[i] = start.elapsed_time(end) / reps

    for d in dict.fromkeys(devices):
        torch.cuda.synchronize(d)
    try:
        group.run([lambda i=i: job(i)
                               for i in range(len(devices))])
    finally:
        group.close()
    return ms, first


def synced_ms(fn, reps):
    """ms a call of fn with a synchronize after each (CUDA events around
    reps calls after a warm-up): a one-device call that waits as a share's
    does."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
        torch.cuda.current_stream().synchronize()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def same(a, b):
    """Equal bit for bit, NaN where the other is NaN."""
    import torch
    if a.is_floating_point():
        return torch.allclose(a, b, rtol=0.0, atol=0.0, equal_nan=True)
    return torch.equal(a, b)


def counts_of(result):
    if hasattr(result, "solves"):
        return [int(result.iterations), int(result.solves),
                int(result.sweeps)]
    return [int(result.iterations)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", type=int, default=32768)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-group", action="store_true")
    ap.add_argument("--built", action="store_true",
                    help="load the library as built, without ptxas' log")
    ap.add_argument("--dump", default=None)
    ap.add_argument("--against", default=None)
    args = ap.parse_args(argv)

    import torch

    import chip_smoke
    from vic_tpu_torch import kernels

    device = chip_smoke.device_phase()
    print(subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if args.built:
        from vic_tpu_torch.kernels import build
        build.load()
    else:
        chip_smoke.build_phase()
    n_dev = torch.cuda.device_count()
    out = {"card": torch.cuda.get_device_name(0), "devices": n_dev}
    dump, differ = {}, {}
    ref = torch.load(args.against) if args.against else None
    for config in ("frozen", "frozen_exp"):
        captured = chip_smoke.capture_kernel_args(
            config, ("node_sweep", "fd_surface_brent"), device,
            record=chip_smoke.FROZEN_RECORD, cells=args.cells)
        for name, (a, kw) in captured.items():
            row = f"{name}/{config}"
            whole_ms = chip_smoke.cuda_ms(
                lambda: getattr(kernels, name)(*a, **kw), reps=args.reps)
            waited_ms = synced_ms(lambda: getattr(kernels, name)(*a, **kw),
                                  args.reps)
            whole = getattr(kernels, name)(*a, **kw)
            torch.cuda.synchronize()
            out[f"{row}/one_launch_ms"] = whole_ms
            out[f"{row}/one_launch_synced_ms"] = waited_ms
            out[f"{row}/counts"] = counts_of(whole)
            fields = (("temp", "fbcount") if name == "node_sweep"
                      else ("root", "converged", "bracketed"))
            dump[row] = {"counts": counts_of(whole), **{
                f: getattr(whole, f).cpu() for f in fields}}
            print(f"  {row}: one launch {whole_ms:.4f} ms a call "
                  f"({waited_ms:.4f} waiting for each), counts "
                  f"{counts_of(whole)}", flush=True)
            if ref is not None:
                differ[row] = {"counts": ref[row]["counts"] != counts_of(
                    whole), **{f: int((~(dump[row][f] == ref[row][f])
                                       & ~(dump[row][f].isnan()
                                           & ref[row][f].isnan())).sum())
                               if dump[row][f].is_floating_point() else
                               int((dump[row][f] != ref[row][f]).sum())
                               for f in fields}}
                print(f"  {row}: elements differing from {args.against}: "
                      f"{differ[row]}", flush=True)
            if args.no_group:
                continue
            layouts = {"one_card_two_shares": [device, device]}
            if n_dev > 1:
                layouts["one_share_a_card"] = [torch.device("cuda", i)
                                               for i in range(n_dev)]
            for label, devs in layouts.items():
                if args.cells % len(devs):
                    continue
                ms, shares = split_ms(name, a, kw, devs, args.reps)
                got = [counts_of(r) for r in shares]
                equal = all(got_c == counts_of(whole) for got_c in got) and \
                    all(same(torch.cat([getattr(r, f).to(device)
                                        for r in shares]), getattr(whole, f))
                        for f in fields)
                out[f"{row}/{label}_ms"] = ms
                out[f"{row}/{label}_equal"] = equal
                print(f"  {row}, {label} {devs}: "
                      f"{', '.join(f'{m:.4f}' for m in ms)} ms a call on "
                      f"each share, counts {got}, equal to the one launch: "
                      f"{equal}", flush=True)
                if not equal:
                    raise AssertionError(f"{row} {label} differs from the "
                                         "one launch")

    if args.dump:
        torch.save(dump, args.dump)
    if ref is not None:
        out["differing_from_against"] = differ
    if not args.no_group:
        out.update(lone_share(chip_smoke, kernels, device, args.cells))
    text = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    if any(v for d in differ.values() for v in d.values()):
        raise AssertionError(f"outputs differ from {args.against}")


def lone_share(chip_smoke, kernels, device, cells):
    """A group of two whose second share never launches, with a 2 s limit:
    the seconds until the first share's call raised."""
    from vic_tpu_torch.parallel.votes import ShareGroup
    from vic_tpu_torch.testing import cell_share
    (a, kw), = chip_smoke.capture_kernel_args(
        "frozen", ("node_sweep",), device, record=chip_smoke.FROZEN_RECORD,
        cells=cells).values()
    half = cell_share((a, kw), 0, cells // 2, cells)
    # no devices: the lone share launches without meeting the other
    group = ShareGroup(2, timeout_s=2.0)
    t0 = time.perf_counter()
    try:
        kernels.node_sweep(*half[0], **dict(half[1], votes=group.member(0)))
    except RuntimeError as e:
        waited = time.perf_counter() - t0
        print(f"  a group whose second share never launches: raised after "
              f"{waited:.3f} s: {e}", flush=True)
        if waited > 30.0:
            raise AssertionError("the lone share's vote outlasted 30 s")
        return {"lone_share_raised_after_s": waited}
    else:
        raise AssertionError("a lone share of a group of two ran through")
    finally:
        group.close()


if __name__ == "__main__":
    main()
