"""Build the CUDA kernels with nvcc into a plain-C shared library and load
it with ctypes.

The library is compiled at first use from `vic_tpu_torch/csrc/` into
`vic_tpu_torch/kernels/_build/` (listed in .gitignore), one nvcc process per
source started together, and rebuilt whenever a source is newer than it. A
failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
LIB_NAME = "libvic_kernels.so"
COMPILE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-fmad=false", "-Xcompiler", "-fPIC")


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME/bin, else PATH, else /usr/local/cuda/bin."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        candidates = [Path(home) / "bin" / "nvcc"]
    else:
        on_path = shutil.which("nvcc")
        candidates = ([Path(on_path)] if on_path else []) + [
            Path("/usr/local/cuda/bin/nvcc")]
    for cand in candidates:
        if cand.is_file() and os.access(cand, os.X_OK):
            return str(cand)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels of vic_tpu_torch cannot be built")


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def build(build_dir: Path = BUILD_DIR, extra_flags=()):
    """Compile each csrc/*.cu into an object, all nvcc processes at once,
    and link them into build_dir/libvic_kernels.so, unless an up-to-date
    library is there (extra nvcc flags always rebuild). Returns (library
    path, nvcc's output)."""
    build_dir = Path(build_dir)
    lib = build_dir / LIB_NAME
    sources = sorted(CSRC.glob("*.cu"))
    newest = max(p.stat().st_mtime
                 for p in sources + sorted(CSRC.glob("*.cuh")))
    if not extra_flags and lib.is_file() and lib.stat().st_mtime >= newest:
        return lib, ""
    nvcc = find_nvcc()
    build_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objects = [build_dir / f"{src.stem}.{tag}.o" for src in sources]
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        logs = list(pool.map(_run, [
            [nvcc, *COMPILE_FLAGS, *extra_flags, "-I", str(CSRC), "-c",
             "-o", str(obj), str(src)] for src, obj in zip(sources, objects)]))
    tmp = build_dir / f"{LIB_NAME}.{tag}"
    logs.append(_run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                      "-shared", "-o", str(tmp), *map(str, objects)]))
    for obj in objects:
        obj.unlink()
    os.replace(tmp, lib)
    return lib, "".join(logs)


# the lane table (kernels._lane_inputs) and its counts of float inputs and
# masks; _FLOATS for a kernel without masks
_LANES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
_FLOATS = [ctypes.c_void_p, ctypes.c_int]
# K3 on csrc/lane_brent.cuh: lo and hi are lane inputs
_LANE_BRENT_ARGTYPES = (_LANES + [ctypes.c_int, ctypes.c_float]
                        + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5)
# K2 on it: K3's, then the terms at 0 C and at the root and the melt test
_SNOWPACK_ARGTYPES = _LANE_BRENT_ARGTYPES + [ctypes.c_void_p] * 3
# K1 and K12 on it: K3's, then their floats (the terms and the rest) and
# their flags
_GLACIER_ARGTYPES = _LANE_BRENT_ARGTYPES + [ctypes.c_void_p] * 2
# K4: lanes per cell, layers, hours, lanes; the outputs, stream
_RUNOFF_ARGTYPES = (_FLOATS + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
# K5: lanes per cell, layers, dist; dt; the ground-flux type, frozen and
# the Brent's counts; its four outputs, the terms, the layer terms, stream
_SURFACE_ARGTYPES = (_LANES + [ctypes.c_int] * 3 + [ctypes.c_float]
                     + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 7)
_AFFINE_SURFACE_ARGTYPES = (_LANES + [ctypes.c_int] * 4 + [ctypes.c_float]
                            + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 5)
# the node solve of K6 and K7: the lane, geometry and frozen-soil pointers,
# the counts and switches, dt and its multiples, the scratch pointers
_NODE_SOLVE = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
               + [ctypes.c_float] * 3 + [ctypes.c_void_p])
# their grid, share group table and stream
_COOPERATIVE = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
_SWEEP_ARGTYPES = (_NODE_SOLVE + [ctypes.c_void_p] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 4 + _COOPERATIVE)
_FD_SURFACE_ARGTYPES = (_LANES + [ctypes.c_int] * 3 + [ctypes.c_float]
                        + [ctypes.c_int] * 4 + _NODE_SOLVE
                        + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                        + [ctypes.c_void_p] * 8 + _COOPERATIVE)
_BLOWING_ARGTYPES = (_LANES + [ctypes.c_int, ctypes.c_float]
                     + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                     + [ctypes.c_void_p] * 3)
# K9: lanes per cell, pass, lanes; tc_next, g, the accumulator and ticket,
# the device and host words of the largest change, stream
_CANOPY_AIR_ARGTYPES = (_LANES + [ctypes.c_int] * 3
                        + [ctypes.c_void_p] * 6)
_CANOPY_AIR_FINAL_ARGTYPES = (_LANES + [ctypes.c_int] * 2
                              + [ctypes.c_void_p] * 4)
_HOST_WORD_ARGTYPES = [ctypes.c_void_p] * 2
# lanes per lake, soil layers, dt_sec, lakes; the outputs, stream
_LAKE_BALANCE_ARGTYPES = (_LANES + [ctypes.c_int] * 2
                          + [ctypes.c_float, ctypes.c_int]
                          + [ctypes.c_void_p] * 5)
_LAKE_OPEN_ARGTYPES = (_LANES + [ctypes.c_int, ctypes.c_float,
                                  ctypes.c_int] + [ctypes.c_void_p] * 6)
_LAKE_ICE_ARGTYPES = (_LANES + [ctypes.c_int, ctypes.c_float,
                                 ctypes.c_int] + [ctypes.c_void_p] * 5)
_LAKE_DEPTH_ARGTYPES = (_FLOATS + [ctypes.c_int] * 2
                        + [ctypes.c_void_p] * 2)
# K17 on csrc/lane_brent.cuh: the residual, its lane table (lo and hi the
# last float inputs), lanes per cell, dt, n_iter, lanes; outputs, stream
_BISECTION_ARGTYPES = ([ctypes.c_int] + _LANES
                       + [ctypes.c_int, ctypes.c_float, ctypes.c_int,
                          ctypes.c_int] + [ctypes.c_void_p] * 5)
# K15: lanes per cell, rounds, lanes; the outputs' rows and row stride,
# stream
_MASS_RELEASE_ARGTYPES = (_FLOATS + [ctypes.c_int] * 3
                          + [ctypes.c_void_p, ctypes.c_int64,
                             ctypes.c_void_p])
# K16: the lane, geometry, surface and frozen-soil pointers, the counts
# and switches, relax and dt's, the outputs, stream, the rolled scratch
_IMPLICIT_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                      + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 4)

_lib = None
_loading = threading.Lock()


def load():
    """The loaded kernel library (built first if needed; once, whichever
    thread asks first)."""
    global _lib
    if _lib is not None:
        return _lib
    with _loading:
        return _load()


def _load():
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in (("lake_ice_melt", _GLACIER_ARGTYPES),
                               ("glacier_brent", _GLACIER_ARGTYPES),
                               ("canopy_brent", _LANE_BRENT_ARGTYPES),
                               ("snowpack_brent", _SNOWPACK_ARGTYPES),
                               ("runoff_hourly", _RUNOFF_ARGTYPES),
                               ("surface_brent", _SURFACE_ARGTYPES),
                               ("node_sweep", _SWEEP_ARGTYPES),
                               ("fd_surface_brent", _FD_SURFACE_ARGTYPES),
                               ("affine_surface_brent",
                                _AFFINE_SURFACE_ARGTYPES),
                               ("blowing_snow", _BLOWING_ARGTYPES),
                               ("canopy_air_step", _CANOPY_AIR_ARGTYPES),
                               ("canopy_air_final",
                                _CANOPY_AIR_FINAL_ARGTYPES),
                               ("canopy_air_host_word", _HOST_WORD_ARGTYPES),
                               ("lake_open_water", _LAKE_OPEN_ARGTYPES),
                               ("lake_under_ice", _LAKE_ICE_ARGTYPES),
                               ("lake_depth", _LAKE_DEPTH_ARGTYPES),
                               ("lake_water_balance",
                                _LAKE_BALANCE_ARGTYPES),
                               ("bisection", _BISECTION_ARGTYPES),
                               ("mass_release", _MASS_RELEASE_ARGTYPES),
                               ("mass_release_route",
                                _FLOATS + [ctypes.c_int] * 2),
                               ("implicit_profile", _IMPLICIT_ARGTYPES),
                               ("implicit_profile_scratch_rows",
                                [ctypes.c_int]),
                               ("share_votes_alloc",
                                [ctypes.c_int64, ctypes.c_void_p]),
                               ("share_votes_free", [ctypes.c_void_p])):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
