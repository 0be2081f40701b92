"""PyTorch's elementwise expf, logf, powf and sqrtf on one NVIDIA GPU against
the same CUDA math functions compiled as the port's kernels are
(`kernels.build.COMPILE_FLAGS`: `-fmad=false`, no fast math) and with FMA
contraction allowed (`-fmad=true`, nvcc's default, as PyTorch is built).

    python3 tools/probe_libm.py [--n 4194304] [--out FILE.json]

For each function: over seeded float32 arguments in the ranges the lake
and blowing-snow kernels give it, the elements whose result differs bit
for bit from torch's (`torch.exp`, `torch.log`, `torch.pow`,
`torch.sqrt`), and the largest difference in units in the last place, for
each of the two builds; and each build's PTX of the function (to
--ptx-dir, if given). Prints the card's name and power limit and, as its
last line, one JSON object (also written to --out).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, os.getcwd())

SOURCE = r"""
#include <cuda_runtime.h>
__global__ void probe(int fn, const float* a, const float* b, float* o,
                      int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float r;
  switch (fn) {
    case 0: r = expf(a[i]); break;
    case 1: r = logf(a[i]); break;
    case 2: r = powf(a[i], b[i]); break;
    default: r = sqrtf(a[i]); break;
  }
  o[i] = r;
}
extern "C" int run(int fn, const float* a, const float* b, float* o, int n,
                   void* stream) {
  probe<<<(n + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      fn, a, b, o, n);
  return static_cast<int>(cudaGetLastError());
}
"""
FUNCTIONS = ("expf", "logf", "powf", "sqrtf")


def ulps(x, y):
    """|x - y| in float32 units in the last place (ordered int views)."""
    import torch

    def ordered(v):
        i = v.view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    both = torch.isfinite(x) & torch.isfinite(y)
    d = (ordered(x) - ordered(y)).abs()
    return torch.where(both, d, 0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1 << 22)
    ap.add_argument("--out", default=None)
    ap.add_argument("--ptx-dir", default=None)
    args = ap.parse_args(argv)

    import torch

    from vic_tpu_torch.kernels import build
    if not torch.cuda.is_available():
        raise RuntimeError("probe_libm: no CUDA device")
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    nvcc = build.find_nvcc()
    flags = [f for f in build.COMPILE_FLAGS if f != "-fmad=false"]
    gen = torch.Generator(device="cpu").manual_seed(15)
    n = args.n
    # exp: the lakes' -6 hs, -1.5 hi, -20 hs ... and blowing snow's ranges;
    # log and pow: positive arguments, pow's exponents as the kernels' are
    a_exp = -torch.rand(n, generator=gen) * 30.0
    a_pos = torch.rand(n, generator=gen) * 50.0 + 1e-4
    b_pow = torch.rand(n, generator=gen) * 4.0 - 2.0
    inputs = {"expf": (a_exp, a_exp), "logf": (a_pos, a_pos),
              "powf": (a_pos, b_pow), "sqrtf": (a_pos, a_pos)}
    refs = {"expf": lambda a, b: torch.exp(a),
            "logf": lambda a, b: torch.log(a),
            "powf": lambda a, b: torch.pow(a, b),
            "sqrtf": lambda a, b: torch.sqrt(a)}
    result = {"card": card, "n": n}
    with tempfile.TemporaryDirectory() as tmp:
        cu = Path(tmp) / "probe.cu"
        cu.write_text(SOURCE)
        for label, fmad in (("fmad_false", "-fmad=false"),
                            ("fmad_true", "-fmad=true")):
            lib = Path(tmp) / f"probe_{label}.so"
            subprocess.run([nvcc, *flags, fmad, "-shared", "-o", str(lib),
                            str(cu)], check=True, capture_output=True)
            if args.ptx_dir:
                os.makedirs(args.ptx_dir, exist_ok=True)
                subprocess.run([nvcc, "-arch=sm_90a", "-std=c++17", "-O3",
                                fmad, "-ptx", "-o",
                                os.path.join(args.ptx_dir,
                                             f"probe_{label}.ptx"),
                                str(cu)], check=True, capture_output=True)
            so = ctypes.CDLL(str(lib))
            so.run.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [
                ctypes.c_int, ctypes.c_void_p]
            so.run.restype = ctypes.c_int
            for k, name in enumerate(FUNCTIONS):
                a, b = (x.to(device) for x in inputs[name])
                out = torch.empty_like(a)
                err = so.run(k, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                             n, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"probe launch failed: {err}")
                ref = refs[name](a, b)
                torch.cuda.synchronize()
                nan = torch.isnan(out) & torch.isnan(ref)
                differ = (out.view(torch.int32) != ref.view(torch.int32)) \
                    & ~nan
                result[f"{name}/{label}"] = {
                    "differing": int(differ.sum()),
                    "max_ulps": int(ulps(out, ref).max())}
                print(f"  {name} built {label} against torch: "
                      f"{int(differ.sum())} of {n} differ, at most "
                      f"{int(ulps(out, ref).max())} ulps", flush=True)
    text = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
