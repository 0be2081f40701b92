"""K12's prologue (csrc/lake_ice_melt.cu `IceLane::prologue`) on one NVIDIA
GPU against the PyTorch lines of `lake_ice_melt_plain` it repeats: the
inputs each forms for the ice balance's Brent, field by field.

    cd <checkout> && python3 <path>/tools/probe_ice_prologue.py
        [--cells 32768] [--out FILE.json]

On the arguments `solve_lake` gives `lake_ice_melt` in the lakes step's
second record (`chip_smoke.capture_kernel_args`, `--cells` cells), a probe
kernel compiled with the library's flags includes lake_ice_melt.cu, runs
the lane's init() and prologue() on every lake and writes the residual's
fields and the bracket; `lake_ice_melt_plain` on the same arguments gives
the fields `lake_ice_brent_plain` is called with. For each field: the
lakes whose value differs bit for bit (NaN equal to NaN) and the largest
difference in units in the last place. Prints the card's name and power
limit and, as its last line, one JSON object (also written to --out).

Then, for each Python float the plain version divides a tensor by (the
products of icerad's conductivities and extinctions, LF * RHO_W), seeded
float32 tensors divided by it with torch on the card against the product
with the double scalar's reciprocal rounded to float (`div_py` in
csrc/lake_ice_melt.cu) and with the reciprocal of the scalar's float
rounding (physics.cuh's `div_s`): the elements each differs on.
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
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from probe_libm import ulps  # noqa: E402

# IceResidual's fields after dt, then the bracket
FIELDS = ("ra", "z_ref", "roughness", "wind", "net_short", "longwave_in",
          "air_dens", "lv", "tair", "pressure", "vpd", "vp_air", "rain_m",
          "surf_water", "tcutoff", "avgcond", "sw_conducted", "blowing_flux",
          "lo", "hi")
SOURCE = r"""
#include "lake_ice_melt.cu"
namespace {
__global__ void probe(const __grid_constant__ LaneInputs in,
                      IceMeltParams p, float* o) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  const LaneRow row = lane_row(in, i);
  IceLane f;
  f.init(in, row, p);
  f.prologue(in, row, i, true, p);
  float lo, hi;
  f.bracket(&lo, &hi);
  const float v[] = {f.ra, f.z_ref, f.roughness, f.wind, f.net_short,
                     f.longwave_in, f.air_dens, f.lv, f.tair, f.pressure,
                     f.vpd, f.vp_air, f.rain_m, f.surf_water, f.tcutoff,
                     f.avgcond, f.sw_conducted, f.blowing_flux, lo, hi};
  for (int k = 0; k < 20; ++k) o[k * p.n + i] = v[k];
}
}  // namespace
extern "C" int run_probe(const int64_t* lanes, int nf, int h, float dt,
                         int n, float* scratch, float* o, void* stream) {
  LaneInputs in{};
  if (!fill_lane_inputs(&in, lanes, nf, kNumIn, 1, 1, h)) return -1;
  probe<<<(n + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      in, IceMeltParams{dt, n, scratch, nullptr}, o);
  return static_cast<int>(cudaGetLastError());
}
"""


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", type=int, default=32768)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import chip_smoke
    from profile_lake_close import captured_ice_melt
    from vic_tpu_torch import constants as c
    from vic_tpu_torch import kernels
    from vic_tpu_torch.kernels import build
    from vic_tpu_torch.physics import lake

    device = chip_smoke.device_phase()
    nvcc = build.find_nvcc()
    lakes = chip_smoke.capture_kernel_args(
        "lakes", ("lake_step",), device, record=chip_smoke.LAKES_RECORD,
        cells=args.cells)
    kw = captured_ice_melt(lake, *lakes["lake_step"])
    # the torch side: the Brent's arguments lake_ice_melt_plain forms
    seen = {}
    plain_brent = lake.lake_ice_brent_plain

    def brent(lo, hi, active, **k):
        seen.update(k, lo=lo, hi=hi)
        return plain_brent(lo, hi, active, **k)

    lake.lake_ice_brent_plain = brent
    try:
        lake.lake_ice_melt_plain(**kw)
    finally:
        lake.lake_ice_brent_plain = plain_brent
    named = dict(kw)
    bf = kw.get("blowing_flux", 0.0)
    named["blowing_flux"] = (bf if isinstance(bf, torch.Tensor)
                             else torch.full((), float(bf), device=device))
    shape = named["swq"].shape
    active = torch.ones(shape, dtype=torch.bool, device=device)
    table = kernels._lane_inputs(
        [(k, named[k], 0) for k in kernels.ICE_MELT_INPUTS],
        [("active", active, 0)], shape, device)
    n = shape[0]
    out = torch.empty((len(FIELDS), n), dtype=torch.float32, device=device)
    scratch = torch.empty(((9 + 11) * n,), dtype=torch.float32,
                          device=device)
    with tempfile.TemporaryDirectory() as tmp:
        cu, lib = Path(tmp) / "probe.cu", Path(tmp) / "probe.so"
        cu.write_text(SOURCE)
        subprocess.run([nvcc, *build.COMPILE_FLAGS, "-I", str(build.CSRC),
                        "-shared", "-o", str(lib), str(cu)], check=True,
                       capture_output=True)
        so = ctypes.CDLL(str(lib))
        so.run_probe.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_float, ctypes.c_int] + [
                                     ctypes.c_void_p] * 3
        so.run_probe.restype = ctypes.c_int
        err = so.run_probe(table.ctypes.data, len(kernels.ICE_MELT_INPUTS),
                           n, float(kw["dt_sec"]), n, scratch.data_ptr(),
                           out.data_ptr(),
                           torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
    if err:
        raise RuntimeError(f"probe failed: {err}")
    result = {"card": chip_smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], "lakes": n}
    for k, name in enumerate(FIELDS):
        ref = seen[name]
        ref = (ref if isinstance(ref, torch.Tensor)
               else torch.full((), float(ref), device=device))
        ref = ref.to(torch.float32).expand(shape)
        got = out[k]
        nan = torch.isnan(got) & torch.isnan(ref)
        differ = (got.view(torch.int32) != ref.contiguous().view(
            torch.int32)) & ~nan
        result[name] = {"differing": int(differ.sum()),
                        "max_ulps": int(ulps(got, ref.contiguous()).max())}
        print(f"  {name}: {result[name]['differing']} of {n} lakes differ, "
              f"at most {result[name]['max_ulps']} ulps", flush=True)
    x = torch.rand(1 << 22, generator=torch.Generator().manual_seed(15),
                   dtype=torch.float32).to(device) * 2.0 - 1.0
    for label, d in (("0.7*6.0", 0.7 * 6.0), ("2.3*1.5", 2.3 * 1.5),
                     ("0.7*20.0", 0.7 * 20.0), ("2.3*20.0", 2.3 * 20.0),
                     ("2.3*0.7", 2.3 * 0.7), ("LF*RHO_W", c.LF * c.RHO_W)):
        ref = (x / d).view(torch.int32)
        by_double = (x * float(np.float32(1.0 / d))).view(torch.int32)
        by_float = (x * float(np.float32(1.0) / np.float32(d))).view(
            torch.int32)
        result[f"divide by {label}"] = {
            "differ_from_div_py": int((ref != by_double).sum()),
            "differ_from_div_s": int((ref != by_float).sum()),
            "elements": x.numel()}
        print(f"  x / {label}: {result[f'divide by {label}']}", flush=True)
    text = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
