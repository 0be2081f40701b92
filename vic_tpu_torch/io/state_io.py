"""Checkpoint / restore of the full prognostic model state: a copy of
`vic_tpu/io/state_io.py` on the port's ModelState.

Formats, chosen by STATE_FORMAT (`save_state`) and sniffed from the file's
first bytes (`load_state`), so any state file the reference, vic_tpu or the
port wrote warm-starts:
- **ASCII** (the default) and **BINARY**: the reference's legacy formats
  (`io/state_legacy.py`, write_model_state.c);
- **NETCDF** with the run's domain: the reference's StateIONetCDF.c schema
  (`io/state_netcdf_ref.py`);
- **NETCDF** without a domain: vic_tpu's own schema, one NetCDF-4 file
  with dims (cell, n<size>...) and one array per ModelState field under the
  reference's StateIO.h variable names (SNOW_SWQ, LAYER_MOIST, ENERGY_T,
  ...); restoring it reproduces the run exactly (the file is the carried
  state);
- **npz** where libnetcdf was not found (`native.netcdf_found()`): NETCDF
  writes `path + ".npz"`, and a path that ends in `.npz` or does not exist
  is read as one.

The readers return CPU tensors shaped like the template's.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..state import ModelState

# ModelState field -> reference StateIO.h variable name
_NAME_MAP = {
    "moist": "LAYER_MOIST",
    "ice": "LAYER_SOIL_ICE",
    "wdew": "HRU_VEG_VAR_WDEW",
    # DIST_PRCP dry-fraction columns: the reference stores these under the
    # same variable IDs indexed by DIST_DIM (write_model_state.c:193-235);
    # this schema suffixes _DRY instead
    "moist_dry": "LAYER_MOIST_DRY",
    "ice_dry": "LAYER_SOIL_ICE_DRY",
    "wdew_dry": "HRU_VEG_VAR_WDEW_DRY",
    "snow_canopy": "SNOW_CANOPY",
    "swq": "SNOW_SWQ",
    "surf_temp": "SNOW_SURF_TEMP",
    "pack_temp": "SNOW_PACK_TEMP",
    "surf_water": "SNOW_SURF_WATER",
    "pack_water": "SNOW_PACK_WATER",
    "density": "SNOW_DENSITY",
    "depth": "SNOW_DEPTH",
    "albedo": "SNOW_ALBEDO",
    "last_snow": "SNOW_LAST_SNOW",
    "melting": "SNOW_MELTING",
    "coverage": "SNOW_COVERAGE",
    "cold_content": "SNOW_COLD_CONTENT",
    "snow_flag": "SNOW_SNOW",
    # SPATIAL_SNOW depletion-curve memory (StateIO.h:364-371)
    "snow_store_snow": "SNOW_STORE_SNOW",
    "snow_store_swq": "SNOW_STORE_SWQ",
    "snow_max_swq": "SNOW_MAX_SWQ",
    "snow_swq_slope": "SNOW_SWQ_SLOPE",
    "snow_store_coverage": "SNOW_STORE_COVERAGE",
    "node_temp": "ENERGY_T",
    "tfoliage": "ENERGY_TFOLIAGE",
    "long_under_out": "ENERGY_LONG_UNDER_OUT",
    "glac_water_storage": "GLAC_WATER_STORAGE",
    "glac_cum_mass_balance": "GLAC_CUM_MASS_BALANCE",
    "glac_surf_temp": "GLAC_SURF_TEMP",
    "surf_temp_fbcount": "SURF_TEMP_FBCOUNT",
    "snow_temp_fbcount": "SNOW_TEMP_FBCOUNT",
    "mu": "PRCP_MU",
    "still_storm": "INIT_STILL_STORM",
    "dry_time": "INIT_DRY_TIME",
    "cell_valid": "CELL_VALID",
    "lake_volume": "LAKE_VOLUME",
    "lake_temp": "LAKE_TEMP",
    "lake_ice_we": "LAKE_ICE_WATER_EQ",
    "lake_ice_area": "LAKE_AREAI",
    "lake_ice_height": "LAKE_HICE",
    "lake_swe": "LAKE_SWE",
    "lake_tempi": "LAKE_TEMPI",
    "lake_snow_surf_temp": "LAKE_SNOW_SURF_TEMP",
    "lake_snow_pack_temp": "LAKE_SNOW_PACK_TEMP",
    "lake_snow_surf_water": "LAKE_SNOW_SURF_WATER",
    "lake_snow_pack_water": "LAKE_SNOW_PACK_WATER",
    "lake_salbedo": "LAKE_SALBEDO",
    "lake_last_snow": "LAKE_SNOW_LAST_SNOW",
    "lake_melting": "LAKE_SNOW_MELTING",
}


def _host(state: ModelState) -> dict:
    """Every field of `state` named in _NAME_MAP as a host numpy array."""
    return {k: getattr(state, k).detach().cpu().numpy() for k in _NAME_MAP}


def _header(arrays: dict, gp, date=None) -> dict:
    n_cell, max_hru = arrays["swq"].shape
    return {
        "n_cell": int(n_cell), "max_hru": int(max_hru),
        "nlayer": int(arrays["moist"].shape[-1]),
        "nnode": int(arrays["node_temp"].shape[-1]),
        "date": list(date) if date else None,
        "format_version": 1,
    }


def save_state_netcdf(path: str, state: ModelState, gp, date=None):
    """Write the full state in vic_tpu's own NetCDF-4 schema."""
    from .native import NetCDFFile
    arrays = _host(state)
    hdr = _header(arrays, gp, date)
    for field, arr in arrays.items():
        if arr.dtype == bool:
            arr = arr.astype(np.int32)
        if arr.dtype not in (np.dtype(np.float32), np.dtype(np.float64),
                             np.dtype(np.int32)):
            arr = arr.astype(np.float64)
        arrays[field] = np.ascontiguousarray(arr)
    with NetCDFFile(path, "w") as f:
        f.def_dim("cell", hdr["n_cell"])
        defined = {}

        def dim_for(size):
            if size not in defined:
                name = f"n{size}"
                f.def_dim(name, size)
                defined[size] = name
            return defined[size]

        for field, ncname in _NAME_MAP.items():
            arr = arrays[field]
            dims = ("cell",) + tuple(dim_for(s) for s in arr.shape[1:])
            f.def_var(ncname, arr.dtype, dims)
        f.put_att("vic_tpu_state_header", json.dumps(hdr))
        f.enddef()
        for field, ncname in _NAME_MAP.items():
            f.put(ncname, arrays[field])


def load_state_netcdf(path: str, gp, template: ModelState) -> ModelState:
    """Restore a state of vic_tpu's own schema; the cell count and every
    per-variable dimension must match the run's (check_state_file.c:11)."""
    from .native import NetCDFFile
    tmpl = _host(template)
    with NetCDFFile(path) as f:
        n_cell = f.dim_len("cell")
        if n_cell != tmpl["swq"].shape[0]:
            raise ValueError(
                f"state file has {n_cell} cells, run domain has "
                f"{tmpl['swq'].shape[0]}")
        for dim_size in {s for k in tmpl for s in tmpl[k].shape[1:]}:
            name = f"n{dim_size}"
            try:
                if f.dim_len(name) != dim_size:
                    raise ValueError(f"state dim {name} size mismatch")
            except OSError:
                raise ValueError(
                    f"state file missing dimension {name}; "
                    "Nlayer/Nnode/max_hru mismatch with run options")
        fields = {}
        names = set(f.var_names())
        for field, ncname in _NAME_MAP.items():
            ref = tmpl[field]
            if ncname not in names:
                # a field added after the file was written: keep the
                # template's (re-derived) value
                fields[field] = torch.from_numpy(ref.copy())
                continue
            got = f.get(ncname, [0] * ref.ndim, list(ref.shape), np.float64)
            fields[field] = torch.from_numpy(
                got > 0.5 if ref.dtype == bool else got.astype(ref.dtype))
        return ModelState(**fields)


def save_state_npz(path: str, state: ModelState, gp, date=None):
    arrays = _host(state)
    arrays["__header__"] = np.frombuffer(
        json.dumps(_header(arrays, gp, date)).encode(), np.uint8)
    np.savez_compressed(path, **arrays)


def load_state_npz(path: str, gp, template: ModelState) -> ModelState:
    tmpl = _host(template)
    fields = {}
    with np.load(path) as z:
        for k, ref in tmpl.items():
            if k not in z.files:
                fields[k] = torch.from_numpy(ref.copy())
                continue
            arr = z[k]
            if arr.shape != ref.shape:
                raise ValueError(f"state var {k}: shape {arr.shape} != "
                                 f"{ref.shape}")
            fields[k] = torch.from_numpy(arr.astype(ref.dtype))
    return ModelState(**fields)


def _magic(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read(8)


def is_netcdf(path: str) -> bool:
    magic = _magic(path)
    return magic[:3] == b"CDF" or magic[:8] == b"\x89HDF\r\n\x1a\n"


def save_state(path: str, state: ModelState, gp, domain=None, date=None,
               fmt: str = "ASCII", geom=None, gmb=None, lake_params=None):
    """Write `state` at `path` in STATE_FORMAT `fmt` (vic_tpu's dispatch,
    state_io.py:202-221): ASCII or BINARY with a domain, the reference's
    NetCDF schema with a domain, vic_tpu's own without one, else npz at
    `path + ".npz"` (NETCDF where libnetcdf was not found, or a legacy
    format without a domain)."""
    from . import native
    fmt = fmt.upper()
    if fmt in ("ASCII", "BINARY") and domain is not None:
        from .state_legacy import write_state_legacy
        write_state_legacy(path, state, gp, domain, date=date, fmt=fmt,
                           geom=geom, gmb=gmb, lake_params=lake_params)
    elif fmt == "NETCDF" and native.netcdf_found() and domain is not None:
        from .state_netcdf_ref import write_state_netcdf_ref
        write_state_netcdf_ref(path, state, gp, domain, date=date,
                               geom=geom, gmb=gmb, lake_params=lake_params)
    elif fmt == "NETCDF" and native.netcdf_found():
        save_state_netcdf(path, state, gp, date)
    else:
        save_state_npz(npz_path(path), state, gp, date)


def npz_path(path: str) -> str:
    """Where the npz fallback writes and reads the state of `path`."""
    return path if path.endswith(".npz") else path + ".npz"


def load_state(path: str, gp, template: ModelState,
               domain=None) -> ModelState:
    """Read a state file of any format into a ModelState of CPU tensors
    shaped like `template` (vic_tpu's dispatch, state_io.py:224-245): a
    path ending in `.npz` or not there is read as npz; NetCDF magic is the
    reference's schema (with a domain) or vic_tpu's own; else, with a
    domain, the reference's ASCII header starts with the year's digits and
    anything else is its raw BINARY format (StateIOBinary.c:22-39)."""
    if path.endswith(".npz") or not os.path.exists(path):
        return load_state_npz(npz_path(path), gp, template)
    if is_netcdf(path):
        from .state_netcdf_ref import (is_ref_netcdf_state,
                                       load_state_netcdf_ref)
        if domain is not None and is_ref_netcdf_state(path):
            return load_state_netcdf_ref(path, gp, domain, template)
        return load_state_netcdf(path, gp, template)
    if domain is not None:
        from .state_legacy import load_state_legacy
        is_ascii = all(c in b"0123456789 \t\r\n-" for c in _magic(path))
        return load_state_legacy(path, gp, domain, template,
                                 fmt="ASCII" if is_ascii else "BINARY")
    return load_state_netcdf(path, gp, template)
