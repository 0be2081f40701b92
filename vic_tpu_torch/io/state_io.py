"""Checkpoint / restore of the model state: the save/load dispatch of
`vic_tpu/io/state_io.py` on the port's ModelState.

STATE_FORMAT ASCII (the default) and BINARY are the reference's legacy
formats (`io/state_legacy.py`); `load_state` sniffs the format from the
file's first bytes, so any reference-written state file warm-starts. The
NetCDF state schemas (vic_tpu's own and the reference's StateIONetCDF.c,
`vic_tpu/io/state_io.py`, `vic_tpu/io/state_netcdf_ref.py`) are not ported:
both directions are refused by name (ROADMAP.md queue 1, item 7).
"""
from __future__ import annotations

from ..state import ModelState

NETCDF_STATE = ("STATE_FORMAT NETCDF (vic_tpu/io/state_io.py and "
                "vic_tpu/io/state_netcdf_ref.py; ROADMAP.md queue 1, the "
                "NetCDF state item)")


def is_netcdf(path: str) -> bool:
    with open(path, "rb") as fh:
        magic = fh.read(8)
    return magic[:3] == b"CDF" or magic[:4] == b"\x89HDF"


def save_state(path: str, state: ModelState, gp, domain, date=None,
               fmt: str = "ASCII", geom=None, gmb=None, lake_params=None):
    """Write `state` at `path` in the reference's ASCII or BINARY format
    (write_model_state.c)."""
    fmt = fmt.upper()
    if fmt == "NETCDF":
        raise NotImplementedError(f"save_state: {NETCDF_STATE} is not "
                                  "ported; use ASCII or BINARY")
    from .state_legacy import write_state_legacy
    write_state_legacy(path, state, gp, domain, date=date, fmt=fmt,
                       geom=geom, gmb=gmb, lake_params=lake_params)


def load_state(path: str, gp, template: ModelState, domain) -> ModelState:
    """Read a reference-format state file into a ModelState shaped like
    `template`. The reference's ASCII header starts with the year's digits;
    anything else is its raw BINARY format (StateIOBinary.c:22-39)."""
    if is_netcdf(path):
        raise NotImplementedError(f"load_state: {NETCDF_STATE} is not "
                                  f"ported ({path})")
    with open(path, "rb") as fh:
        magic = fh.read(8)
    from .state_legacy import load_state_legacy
    is_ascii = all(c in b"0123456789 \t\r\n-" for c in magic)
    return load_state_legacy(path, gp, domain, template,
                             fmt="ASCII" if is_ascii else "BINARY")
