"""Build the port's native vicio shared library with g++ at first use.

The library is compiled from `vicio.cpp` beside this file into `_build/`
(listed in .gitignore), linked against the system libnetcdf where one of
`NETCDF_CANDIDATES` exists. Without it the NetCDF prototypes stay weak and
unresolved: the ASCII and binary readers work, and `io.native` refuses a
NetCDF request by name.

    python -m vic_tpu_torch.native.build     # force a rebuild, print the path
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "vicio.cpp")
BUILD_DIR = os.path.join(HERE, "_build")
OUT = os.path.join(BUILD_DIR, "_vicio.so")

NETCDF_CANDIDATES = (
    "/lib/x86_64-linux-gnu/libnetcdf.so.19",
    "/usr/lib/x86_64-linux-gnu/libnetcdf.so.19",
    "/usr/lib/libnetcdf.so",
)


def find_netcdf() -> str | None:
    for p in NETCDF_CANDIDATES:
        if os.path.exists(p):
            return p
    return None


def build(force: bool = False) -> str | None:
    """Compile _build/_vicio.so if missing or older than its source.
    Returns its path, or None when g++ fails. Several processes may build
    at once: each compiles to its own file and renames it into place."""
    if (not force and os.path.exists(OUT)
            and os.path.getmtime(OUT) >= os.path.getmtime(SRC)):
        return OUT
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", SRC, "-o", tmp]
    nc = find_netcdf()
    if nc:
        cmd += ["-Wl,--no-as-needed", nc]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        os.unlink(tmp)
        sys.stderr.write(f"vicio build failed: {e}\n")
        return None
    os.replace(tmp, OUT)
    return OUT


if __name__ == "__main__":
    print(build(force=True) or "BUILD FAILED")
