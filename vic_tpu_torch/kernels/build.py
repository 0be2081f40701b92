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


# (pointers, per-cell flags, count) of float inputs, then of masks
_INPUTS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
_BRENT_ARGTYPES = (_INPUTS * 2 + [ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_float]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5)
_RUNOFF_ARGTYPES = (_INPUTS + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4)
_SURFACE_ARGTYPES = (_INPUTS * 2 + [ctypes.c_int] * 3
                     + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float]
                     + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 5)
_AFFINE_SURFACE_ARGTYPES = (_INPUTS * 2 + [ctypes.c_int] * 4
                            + [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_float]
                            + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 5)
_SWEEP_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 9)
_FD_SURFACE_ARGTYPES = ([ctypes.c_int] + _INPUTS * 2 + [ctypes.c_int] * 3
                        + [ctypes.c_float] + [ctypes.c_int] * 2
                        + [ctypes.c_void_p] * 3 + [ctypes.c_int]
                        + [ctypes.c_void_p] + [ctypes.c_int]
                        + [ctypes.c_void_p] * 6)
_BLOWING_ARGTYPES = (_INPUTS * 2 + [ctypes.c_int, ctypes.c_float]
                     + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                     + [ctypes.c_void_p] * 3)
_CANOPY_AIR_ARGTYPES = (_INPUTS * 2 + [ctypes.c_int] * 3
                        + [ctypes.c_void_p] * 4)
_LAKE_OPEN_ARGTYPES = (_INPUTS * 2 + [ctypes.c_int, ctypes.c_float,
                                      ctypes.c_int] + [ctypes.c_void_p] * 6)
_LAKE_ICE_ARGTYPES = (_INPUTS * 2 + [ctypes.c_int, ctypes.c_float,
                                     ctypes.c_int] + [ctypes.c_void_p] * 5)
_LAKE_DEPTH_ARGTYPES = (_INPUTS + [ctypes.c_int] * 2
                        + [ctypes.c_void_p] * 2)
_BISECTION_ARGTYPES = ([ctypes.c_int] + _INPUTS * 2
                       + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_float, ctypes.c_int, ctypes.c_int]
                       + [ctypes.c_void_p] * 5)
_MASS_RELEASE_ARGTYPES = (_INPUTS + [ctypes.c_int] * 3
                          + [ctypes.c_void_p] * 5)
_IMPLICIT_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                      + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 3)

_lib = None


def load():
    """The loaded kernel library (built first if needed)."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        for name in ("glacier_brent", "snowpack_brent", "canopy_brent",
                     "lake_ice_brent"):
            fn = getattr(lib, name)
            fn.argtypes = _BRENT_ARGTYPES
            fn.restype = ctypes.c_int
        for name, argtypes in (("runoff_hourly", _RUNOFF_ARGTYPES),
                               ("surface_brent", _SURFACE_ARGTYPES),
                               ("node_sweep", _SWEEP_ARGTYPES),
                               ("fd_surface_brent", _FD_SURFACE_ARGTYPES),
                               ("affine_surface_brent",
                                _AFFINE_SURFACE_ARGTYPES),
                               ("blowing_snow", _BLOWING_ARGTYPES),
                               ("canopy_air_step", _CANOPY_AIR_ARGTYPES),
                               ("lake_open_water", _LAKE_OPEN_ARGTYPES),
                               ("lake_under_ice", _LAKE_ICE_ARGTYPES),
                               ("lake_depth", _LAKE_DEPTH_ARGTYPES),
                               ("bisection", _BISECTION_ARGTYPES),
                               ("mass_release", _MASS_RELEASE_ARGTYPES),
                               ("implicit_profile", _IMPLICIT_ARGTYPES)):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
