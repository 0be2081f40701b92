"""The lane driver's kernel instances of two checkouts, compiled and held
against each other: SASS instruction for instruction, and ptxas'
registers, stack frame and spills (needs nvcc and cuobjdump).

    python3 tools/compare_lane_sass.py <parent root> <change root>
        [--out FILE.json]

Compiles each source of the two checkouts that instantiates
csrc/lane_brent.cuh's lane_brent_kernel (K1-K3 in vic_kernels.cu, K5,
K12, K14) to a cubin with the library's flags and -Xptxas -v, and pairs
the instances by their demangled names, the driver's default stepper
argument (vicbrent::BrentLane) dropped, so a checkout that added the
stepper parameter pairs with one that had none. Prints one line an
instance and, as its last line, one JSON object: whether every instance's
SASS and ptxas figures are equal, and each instance's.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

SOURCES = ("vic_kernels.cu", "surface_brent.cu", "affine_surface_brent.cu",
           "lake_ice_melt.cu")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-fmad=false")


def demangle(names):
    out = subprocess.run(["c++filt"], input="\n".join(names),
                         capture_output=True, text=True,
                         check=True).stdout.splitlines()
    return [n.replace(", vicbrent::BrentLane>", ">") for n in out]


def compiled(root, src, cubin, nvcc):
    """({instance: [SASS instructions]}, {instance: ptxas figures}) of
    root's csrc/src compiled to `cubin`, by demangled name."""
    csrc = Path(root) / "vic_tpu_torch" / "csrc"
    log = subprocess.run([nvcc, *FLAGS, "-Xptxas", "-v", "-cubin", "-I",
                          str(csrc), "-o", str(cubin), str(csrc / src)],
                         capture_output=True, text=True)
    if log.returncode:
        raise RuntimeError(log.stderr)
    sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass",
                           str(cubin)], capture_output=True, text=True,
                          check=True).stdout
    funcs, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(.*?);", line)
        if m and name:
            funcs[name].append(m.group(1).strip())
    ptxas, name = {}, None
    for line in log.stderr.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            ptxas.setdefault(name, {})["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            ptxas.setdefault(name, {}).update(
                frame=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
    return (dict(zip(demangle(list(funcs)), funcs.values())),
            dict(zip(demangle(list(ptxas)), ptxas.values())))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.change)))
    from vic_tpu_torch.kernels import build
    nvcc = build.find_nvcc()
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        for src in SOURCES:
            (fp, rp), (fc, rc) = (
                compiled(root, src, Path(tmp) / f"{k}_{src}.cubin", nvcc)
                for k, root in enumerate((args.parent, args.change)))
            for name in sorted(set(fp) | set(fc)):
                if "lane_brent_kernel" not in name:
                    continue
                report[name] = dict(
                    sass_equal=fp.get(name) == fc.get(name),
                    instructions=[len(fp.get(name, ())),
                                  len(fc.get(name, ()))],
                    ptxas=[rp.get(name), rc.get(name)])
                print(f"  {src}: {name}: {report[name]}", flush=True)
    same_sass = all(r["sass_equal"] for r in report.values())
    same_ptxas = all(r["ptxas"][0] == r["ptxas"][1] for r in report.values())
    text = json.dumps({"instances": len(report), "sass_equal": same_sass,
                       "ptxas_equal": same_ptxas, "by_instance": report})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
