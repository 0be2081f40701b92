"""K17 (csrc/bisection.cu) and variants of its driver, on one NVIDIA GPU.

    cd <checkout> && python3 <path>/tools/probe_bisection.py
        [--variants as_is unpeeled ...] [--out FILE.json]

K17 runs on csrc/lane_brent.cuh's lane_queue_kernel: persistent blocks
whose warps take K17's active lanes from one queue for the whole grid in
32-lane tiles, fill whole warps and solve them together. Each variant is
the checkout's csrc with a few lines replaced (a copy in a temporary
directory; the checkout is not touched), its bisection.cu compiled alone
into a shared library and run through kernels.bisection on K2's and K1's
arguments in the light step's first record (chip_smoke's rows
bisection/snowpack and bisection/glacier, 40 steps):

  as_is        the checkout's kernel
  unpeeled     the stepper's first two evaluations not peeled off the loop
  chunks       lane_brent_kernel's contiguous chunks (the Brent kernels'
               deal: each block one chunk of the lanes, refilled lane by
               lane, votes between evaluations)
  cap<N>       at most N lanes a warp a round (spreads the lanes thinner)
  tile128      four tiles a claim (a quarter of the atomics)
  blocks<N>    kMinBlocks N (__launch_bounds__' minimum blocks an SM,
               which caps the registers)
  a+b          both (chunks+blocks8: the chunks at 64 registers)

For each: ptxas' registers, spill stores and stack frame, the SASS
instructions of the instance, the resident blocks, the fewest rounds any
deal of the active lanes to their threads takes, the active lanes of the
densest of as many contiguous chunks (lane_brent_kernel's deal runs a
second round where above 128), the CUDA-event ms a call (wrapper
included), the device busy ms (three sessions of five calls under
torch.profiler, each session's median), and the outputs that differ bit
for bit from the checkout's own library. Prints the card and, as its
last line, one JSON object (also written to --out).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, os.getcwd())
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

ROWS = ("bisection/snowpack", "bisection/glacier")
LANE_TYPES = ("SnowBisectLane", "GlacierBisectLane")
PEELED = ("      s.next(f(s.x));\n      s.next(f(s.x));\n"
          "      while (s.phase != Stepper::kDone) s.next(f(s.x));\n")


def patches(name):
    """[(file, old, new, count)] of variant `name` (variants joined by
    "+" apply together)."""
    lb = "lane_brent.cuh"
    if "+" in name:
        return [q for part in name.split("+") for q in patches(part)]
    if name == "as_is":
        return []
    if name == "unpeeled":
        return [(lb, PEELED,
                 "      while (s.phase != Stepper::kDone) s.next(f(s.x));\n",
                 1)]
    if name == "chunks":
        return [(lb, "static constexpr bool kFixedCount = true;",
                 "static constexpr bool kFixedCount = false;", 1)]
    if name == "tile128":
        return [(lb, "  unsigned pending = 0;  // its active lanes not dealt "
                 "yet\n", "  unsigned pending = 0;\n  int claim = 0, "
                 "left = 0;\n", 1),
                (lb, "        if (me == 0) first = atomicAdd(queue, 32);\n"
                 "        base = __shfl_sync(kAll, first, 0);\n",
                 "        if (left == 0) {\n"
                 "          if (me == 0) first = atomicAdd(queue, 128);\n"
                 "          claim = __shfl_sync(kAll, first, 0);\n"
                 "          left = 4;\n        }\n"
                 "        base = claim + (4 - left) * 32;\n        --left;\n",
                 1)]
    m = re.fullmatch(r"cap(\d+)", name)
    if m:
        return [(lb, "    unsigned idle = kAll;\n",
                 f"    unsigned idle = (1u << {m.group(1)}) - 1u;\n", 1)]
    m = re.fullmatch(r"blocks(\d+)", name)
    if m:
        return [("bisection.cu", "static constexpr int kMinBlocks = 1;",
                 f"static constexpr int kMinBlocks = {m.group(1)};", 2)]
    raise ValueError(f"unknown variant {name!r}")


def build_variant(name, tmp):
    """The variant's bisection.cu compiled alone into a shared library:
    (path, {lane type: (registers, spill, frame)}, {lane type: SASS
    instructions})."""
    from vic_tpu_torch.kernels import build
    src = tmp / "csrc"
    src.mkdir(parents=True)
    texts = {p.name: p.read_text() for p in build.CSRC.iterdir()}
    for fname, old, new, count in patches(name):
        if texts[fname].count(old) != count:
            raise RuntimeError(f"{name}: {fname} does not hold the lines "
                               "the variant replaces")
        texts[fname] = texts[fname].replace(old, new)
    for fname, text in texts.items():
        (src / fname).write_text(text)
    lib = src / "libbisection.so"
    nvcc = build.find_nvcc()
    log = subprocess.run(
        [nvcc, *build.COMPILE_FLAGS, "-Xptxas", "-v", "-shared", "-I",
         str(src), "-o", str(lib), str(src / "bisection.cu")],
        capture_output=True, text=True)
    if log.returncode:
        raise RuntimeError(log.stdout + log.stderr)
    from profile_lane_brent import ptxas_registers
    regs = {t: v for k, v in ptxas_registers(log.stdout + log.stderr).items()
            for t in LANE_TYPES if t in k}
    sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass",
                           str(lib)], capture_output=True, text=True).stdout
    count, lane = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            lane = next((t for t in LANE_TYPES if t in m.group(1)), None)
            continue
        if lane and re.match(r"\s+/\*[0-9a-f]{4}\*/\s+\S", line):
            count[lane] = count.get(lane, 0) + 1
    return lib, regs, count


def densest_chunk(active, blocks):
    """Active lanes of the densest of `blocks` contiguous chunks of
    ceil(n / blocks) lanes."""
    import torch
    act = active.reshape(-1).to(torch.int32)
    chunk = -(-act.numel() // blocks)
    pad = act.new_zeros(chunk * blocks - act.numel())
    return int(torch.cat([act, pad]).view(blocks, chunk).sum(1).max())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="*",
                    default=["as_is", "unpeeled", "chunks", "cap16",
                             "tile128", "blocks8", "as_is"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    import chip_smoke
    from profile_fd_surface import _profiled
    from profile_lane_brent import resident_threads
    from vic_tpu_torch import kernels
    from vic_tpu_torch.kernels import build

    device = chip_smoke.device_phase()
    build.load()
    names = sorted({chip_smoke.CAPTURED_FROM[r] for r in ROWS})
    captured = chip_smoke.capture_kernel_args("light", names, device)
    calls = {r: chip_smoke.loop_args(r, "bisection", captured) for r in ROWS}
    ref = {r: kernels.bisection(*a, **kw) for r, (a, kw) in calls.items()}
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        for k, name in enumerate(args.variants):
            path, regs, count = build_variant(name, Path(tmp) / str(k))
            vlib = ctypes.CDLL(str(path))
            vlib.bisection.argtypes = build._BISECTION_ARGTYPES
            vlib.bisection.restype = ctypes.c_int
            variant = SimpleNamespace(bisection=vlib.bisection)
            for row, (a, kw) in calls.items():
                lane = LANE_TYPES[ROWS.index(row)]

                def call():
                    return kernels.bisection(*a, **kw)
                load, build.load = build.load, lambda: variant
                try:
                    got = call()
                    ms = chip_smoke.cuda_ms(call, 20)
                    busy = [statistics.median(
                        p["device_busy_ms"] for p in _profiled(
                            {f"call {i}": call for i in range(5)})[1]
                        .values()) for _ in range(3)]
                finally:
                    build.load = load
                n_reg = regs[lane][0]
                blocks = min(resident_threads(n_reg, 128) // 128,
                             -(-got.root.numel() // 128))
                mask = a[3].expand(got.root.shape)
                active = int(mask.sum())
                differ = sum(int((x.view(torch.int32) != y.view(torch.int32))
                                 .sum()) if x.dtype == torch.float32
                             else int((x != y).sum())
                             for x, y in zip(got, ref[row]))
                out.append(dict(
                    variant=name, row=row, registers=n_reg,
                    spill=regs[lane][1], frame=regs[lane][2],
                    sass=count.get(lane), blocks=blocks, active=active,
                    rounds=-(-active // (blocks * 128)),
                    densest_chunk=densest_chunk(mask, blocks), ms=ms,
                    device_busy_ms=busy, differing=differ))
                print(f"  {out[-1]}", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    text = json.dumps({"root": os.getcwd(), "card": card, "variants": out})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
