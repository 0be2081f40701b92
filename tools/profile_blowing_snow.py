"""K8 (`kernels.blowing_snow`) on one NVIDIA GPU, on the arguments the
smoke gives it: each call split into the wrapper's host time and the
device's time, with the kernel's registers and its SASS.

    cd <checkout> && python3 <path>/tools/profile_blowing_snow.py
        [--cells 32768] [--heavy-cells 8192] [--reps 20]
        [--dump FILE.pt] [--against FILE.pt] [--out FILE.json]

Like tools/profile_lake_close.py it builds and imports the kernels,
`vic_tpu_torch` and `chip_smoke` of the checkout it is run from, so two
trees are compared on one card by running it from each root in turn.
Cases (`chip_smoke.capture_kernel_args`): K8's call in blowing_close's
fourth record (`--cells` cells), heavy_nolakes' fourth and heavy's seventh
(`--heavy-cells`): its first call there (the HRU lanes) and, on heavy, its
second (the lake lanes); and the same calls in the first NaN record of the
smoke's NaN slices (`chip_smoke.nan_slice_phase`: CONTINUEONERROR, NaN air
in 64 cells from the fourth record) of blowing_close and heavy.

For each: the lanes and the snow-covered ones (snowdepth > 0), the
wrapper's host time (call to return) and the call's (call to
synchronize), medians of `--reps` calls after a warm-up; CUDA-event
milliseconds a call over `--reps` calls back to back; one call under
torch.profiler: the device's busy milliseconds and its events. Then
csrc/blowing_snow.cu compiled alone with the library's flags: ptxas'
registers and spills of each of its kernels and the SASS of each
(`cuobjdump -sass`): its instructions, its MUFU instructions by kind and
its CALLs;
and the SASS instructions of one accurate powf, expf, logf, sqrtf and
true division (probe kernels compiled with the library's flags, a copy
less their identity probe's), by which the libm calls of the source turn
into instructions.

--dump writes each case's arguments and (flux, transport); --against
reads such a file (another checkout's) and runs this checkout's K8 on its
arguments: the elements of flux and transport that differ bit for bit
(NaN equal to NaN).

Prints the card's name and power limit and, as its last line, one JSON
object with every number (also written to --out).
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, os.getcwd())
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from profile_fd_surface import _event_ms, _host_ms, _profiled  # noqa: E402
from profile_lake_close import move  # noqa: E402
from profile_lane_brent import ptxas_registers  # noqa: E402

# one libm call or division a probe kernel, and the identity it is
# measured against
PROBES = {"identity": "a[i] + b[i]", "powf": "powf(a[i], b[i])",
          "expf": "expf(a[i])", "logf": "logf(a[i])", "sqrtf": "sqrtf(a[i])",
          "division": "a[i] / b[i]"}


def sass_functions(path, cuobjdump):
    """{function name: [opcode, ...]} of a cubin or shared library."""
    text = subprocess.run([cuobjdump, "-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     line)
        if m and name:
            out[name].append(m.group(1))
    return out


def sass_counts(opcodes):
    """Instructions (NOPs left out), MUFU by kind and CALLs."""
    ops = [o for o in opcodes if o != "NOP"]
    mufu = collections.Counter(o for o in ops if o.startswith("MUFU"))
    return {"instructions": len(ops), "mufu": dict(mufu),
            "mufu_total": sum(mufu.values()),
            "calls": sum(o.startswith("CALL") for o in ops)}


def probe_instructions(nvcc, cuobjdump, flags):
    """SASS instructions of one of each PROBES call, less the identity's."""
    src = "".join(
        f'extern "C" __global__ void probe_{k}(const float* a, '
        f"const float* b, float* o) {{ int i = threadIdx.x; "
        f"o[i] = {expr}; }}\n" for k, expr in PROBES.items())
    with tempfile.TemporaryDirectory() as tmp:
        cu, cubin = Path(tmp) / "probe.cu", Path(tmp) / "probe.cubin"
        cu.write_text(src)
        subprocess.run([nvcc, *flags, "-cubin", "-o", str(cubin), str(cu)],
                       check=True, capture_output=True)
        funcs = sass_functions(cubin, cuobjdump)
    counts = {k.removeprefix("probe_"): sass_counts(v)
              for k, v in funcs.items()}
    base = counts.pop("identity")
    return {k: {"instructions": v["instructions"] - base["instructions"],
                "mufu": v["mufu"], "calls": v["calls"]}
            for k, v in counts.items()}


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

    device = chip_smoke.device_phase()
    build.build()
    build.load()
    result = {"root": os.getcwd(), "card": chip_smoke.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]}
    nvcc = build.find_nvcc()
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    # K8's source alone, with the library's flags, for ptxas and the SASS
    with tempfile.TemporaryDirectory() as tmp:
        obj = Path(tmp) / "blowing_snow.o"
        proc = subprocess.run(
            [nvcc, *build.COMPILE_FLAGS, "-Xptxas", "-v", "-I",
             str(build.CSRC), "-c", "-o", str(obj),
             str(build.CSRC / "blowing_snow.cu")],
            capture_output=True, text=True, check=True)
        result["ptxas"] = ptxas_registers(proc.stdout + proc.stderr)
        result["sass"] = {k: sass_counts(v) for k, v in
                          sass_functions(obj, cuobjdump).items()}
    result["libm_sass"] = probe_instructions(nvcc, cuobjdump,
                                             build.COMPILE_FLAGS)
    print("  ptxas:", json.dumps(result["ptxas"]))
    print("  sass:", json.dumps(result["sass"]))
    print("  one call's SASS instructions:", json.dumps(result["libm_sass"]),
          flush=True)

    name = "blowing_snow"
    cases = {}
    nan = chip_smoke.continue_on_error_build
    for label, config, cells, record, build_fn in (
            ("blowing_close", "blowing_close", args.cells,
             chip_smoke.BLOWING_RECORD, None),
            ("heavy_nolakes", "heavy_nolakes", args.heavy_cells,
             chip_smoke.HEAVY_RECORD, None),
            ("heavy", "heavy", args.heavy_cells,
             chip_smoke.HEAVY_LAKE_RECORD, None),
            # the smoke's NaN records: CONTINUEONERROR, NaN air in 64 cells
            ("blowing_close_nan", "blowing_close",
             chip_smoke.NAN_SLICES["blowing_close"], chip_smoke.NAN_FROM,
             nan("blowing_close", shift=0)),
            ("heavy_nan", "heavy", chip_smoke.NAN_SLICES["heavy"],
             chip_smoke.NAN_FROM, nan("heavy", shift=0))):
        cap = chip_smoke.capture_kernel_args(
            config, (name,), device, record=record, cells=cells,
            build=build_fn, also={name: (1,)} if config == "heavy" else None)
        cases[f"{name}/{label}"] = cap[name]
        if config == "heavy":
            cases[f"{name}/{label}_lake_lanes"] = cap[f"{name}@1"]

    calls, dumped = {}, {}
    for label, (a, kw) in cases.items():
        def fn(a=a, kw=kw):
            return kernels.blowing_snow(*a, **kw)
        out = fn()
        torch.cuda.synchronize()
        snow = (kw["snowdepth"] > 0.0).expand(out[0].shape)
        wrapper_ms, call_ms = _host_ms(fn, args.reps)
        calls[label] = fn
        result[label] = {"lanes": out[0].numel(),
                         "snow_lanes": int(snow.sum()),
                         "snow_share": float(snow.float().mean()),
                         "wrapper_host_ms": wrapper_ms, "call_ms": call_ms,
                         "cuda_event_ms": _event_ms(fn, args.reps)}
        dumped[label] = {"args": move(chip_smoke.clone_args((a, kw)), "cpu"),
                         "out": [x.cpu() for x in out]}
    _, prof = _profiled(calls)
    for label in cases:
        case = result[label]
        case.update({k: prof[label][k] for k in
                     ("device_events", "device_busy_ms", "by_kernel")})
        print(f"  {label}: {case['snow_lanes']} of {case['lanes']} lanes "
              f"under snow, wrapper {case['wrapper_host_ms']:.4f} ms on the "
              f"host, call {case['call_ms']:.4f} ms, CUDA events "
              f"{case['cuda_event_ms']:.4f} ms, device busy "
              f"{case['device_busy_ms']:.4f} ms in "
              f"{case['device_events']} events", flush=True)
    if args.dump:
        os.makedirs(os.path.dirname(os.path.abspath(args.dump)),
                    exist_ok=True)
        torch.save(dumped, args.dump)
    if args.against:
        other = torch.load(args.against, weights_only=False)
        for label, theirs in other.items():
            a, kw = move(theirs["args"], device)
            out = kernels.blowing_snow(*a, **kw)
            torch.cuda.synchronize()
            diff = {}
            for part, x, y in zip(("flux", "transport"), out, theirs["out"]):
                x = x.cpu()
                both_nan = torch.isnan(x) & torch.isnan(y)
                differ = (x.view(torch.int32) != y.view(torch.int32)) \
                    & ~both_nan
                diff[part] = {"differing": int(differ.sum()),
                              "nan": int(both_nan.sum()),
                              "elements": x.numel()}
            print(f"  {label} on {args.against}'s arguments: "
                  + json.dumps(diff), flush=True)
            result.setdefault(label, {})["against"] = diff
    text = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
