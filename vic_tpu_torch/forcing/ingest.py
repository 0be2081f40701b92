"""Forcing ingest: per-cell ASCII/binary files or a single NetCDF file into
dense [n_rec, n_cell] arrays, with the reference's variable-name mapping and
unit conventions.

A copy of `vic_tpu/forcing/ingest.py`: the reference's read_forcing_data.c:8
+ read_atmos_data.c:123-457 and the filename convention
``<prefix><lat>_<lng>`` (make_in_and_outfiles.c:30-45). The byte-level
parsing runs in the port's native vicio library. Forcing stays float64 on
the host through MTCLIM and the disaggregation; it becomes float32 only
when `model.make_forcing_stack` moves it to the device.

Supported supplied-variable sets (initialize_atmos.c:7-120 combinations):
- full sub-daily set: PREC, AIR_TEMP, WIND [, SHORTWAVE, LONGWAVE, PRESSURE,
  VP, DENSITY] at the model step — used directly (missing radiation/humidity
  estimated by the estimators in forcing.mtclim);
- daily minimum set: PREC, TMAX, TMIN [, WIND] — runs the MTCLIM pipeline
  (forcing.mtclim + disagg) to synthesize the rest.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from ..constants import ForceFormat
from .disagg import resample_forcing_series  # noqa: F401

# forcing-name -> CF-ish NetCDF name (variable_mapping.c:17-48)
NETCDF_FORCING_NAMES = {
    "AIR_TEMP": "tas", "LONGWAVE": "rlds", "PREC": "pr", "PRESSURE": "ps",
    "QAIR": "huss", "REL_HUMID": "rhs", "SHORTWAVE": "rsds", "SNOWF": "prs",
    "TMAX": "tasmax", "TMIN": "tasmin", "TSKC": "clt", "WIND": "wind",
    "WIND_E": "uas", "WIND_N": "vas", "VP": "VP", "DENSITY": "DENSITY",
    "RAINF": "RAINF", "ALBEDO": "ALBEDO", "CRAINF": "CRAINF",
    "CSNOWF": "CSNOWF", "LSRAINF": "LSRAINF", "LSSNOWF": "LSSNOWF",
    "CHANNEL_IN": "CHANNEL_IN",
}


def cell_forcing_path(prefix: str, lat: float, lng: float,
                      grid_decimal: int) -> str:
    fmt = f"%.{grid_decimal}f"
    return f"{prefix}{fmt % lat}_{fmt % lng}"


def read_cell_file(path: str, fmt: ForceFormat, types, max_recs: int
                   ) -> Dict[str, np.ndarray]:
    """Read one cell's forcing file. types: list of (NAME, extra) from
    FORCE_TYPE config; for BINARY extra = (SIGNED|UNSIGNED, multiplier)."""
    from ..io import native
    names = [t[0] for t in types]
    if fmt == ForceFormat.BINARY:
        signed = []
        mult = []
        for name, extra in types:
            signed.append(len(extra) > 0 and str(extra[0]).upper() == "SIGNED")
            mult.append(float(extra[1]) if len(extra) > 1 else 1.0)
        data = native.read_vic_binary(path, signed, mult, max_recs)
        return {n: data[i] for i, n in enumerate(names)}
    table = native.read_ascii_table(path, len(names), max_rows=max_recs)
    return {n: table[:, i] for i, n in enumerate(names)}


def read_netcdf_forcing(path: str, var_names, lats, lons, n_rec: int,
                        name_map=None) -> Dict[str, np.ndarray]:
    """Read a single all-cells NetCDF forcing file: vars [time, lat, lon]
    (read_atmos_data.c NETCDF path; per-cell hyperslabs become one gather)."""
    from ..io import native
    name_map = name_map or NETCDF_FORCING_NAMES
    out = {}
    with native.NetCDFFile(path) as f:
        lat_axis = f.get("lat", (0,), (f.dim_len("lat"),))
        lon_axis = f.get("lon", (0,), (f.dim_len("lon"),))
        li = np.searchsorted(lat_axis, np.asarray(lats))
        gi = np.searchsorted(lon_axis, np.asarray(lons))
        li = np.clip(li, 0, len(lat_axis) - 1)
        gi = np.clip(gi, 0, len(lon_axis) - 1)
        nt = min(n_rec, f.dim_len("time"))
        for name in var_names:
            nc_name = name_map.get(name, name)
            grid = f.get(nc_name, (0, 0, 0),
                         (nt, len(lat_axis), len(lon_axis)), np.float64)
            # optional packed-variable scaling (read_atmos_data.c:180-210)
            try:
                sf = f.get_att(nc_name, "scale_factor")
            except OSError:
                sf = None
            arr = grid[:, li, gi]
            if sf is not None and sf not in (0.0, 1.0):
                arr = arr * sf
            out[name] = arr
    return out


def ingest_forcing(gp, domain, timeaxis, device="cpu"
                   ) -> Dict[str, np.ndarray]:
    """Read all configured forcing inputs and produce the model forcing dict
    (prec/air_temp/wind/shortwave/longwave/pressure/vp/density at the model
    step), synthesizing what is not supplied (initialize_atmos.c pipeline).

    Fully-specified (pattern A: AIR_TEMP+PREC) forcings supplied at a time
    step different from gp.dt are re-timed here — this is what makes
    SNOW_STEP < TIME_STEP sub-stepping correct for supplied sub-daily
    forcing (the driver re-times gp.dt to SNOW_STEP before ingest).
    Daily TMAX/TMIN sets stay on their daily axis for the MTCLIM
    disaggregation path (pattern B), whose solar geometry runs on
    `device`."""
    n_rec = timeaxis.nrecs
    soil = domain.soil
    n_cell = soil.n_cell
    supplied: Dict[str, np.ndarray] = {}
    var_dt: Dict[str, int] = {}

    for fi in gp.forcing:
        if not fi.prefix or not fi.types:
            continue
        names = [t[0] for t in fi.types]
        # file records covering the simulation span
        recs_needed = -(-n_rec * gp.dt // fi.dt)
        if fi.format == ForceFormat.NETCDF:
            got = read_netcdf_forcing(fi.prefix, names, soil.lat, soil.lng,
                                      recs_needed)
            for k, v in got.items():
                supplied[k] = v
                var_dt[k] = fi.dt
        else:
            cols = {n: np.zeros((recs_needed, n_cell)) for n in names
                    if n != "SKIP"}
            for ci in range(n_cell):
                path = cell_forcing_path(fi.prefix, soil.lat[ci], soil.lng[ci],
                                         gp.grid_decimal)
                got = read_cell_file(path, fi.format, fi.types, recs_needed)
                for k, v in got.items():
                    if k == "SKIP":
                        continue
                    m = min(len(v), recs_needed)
                    cols[k][:m, ci] = v[:m]
            supplied.update(cols)
            for k in cols:
                var_dt[k] = fi.dt

    if "AIR_TEMP" in supplied and "PREC" in supplied:
        # pattern A: everything must land on the model time axis
        supplied = {k: resample_forcing_series(v, k, var_dt.get(k, gp.dt),
                                               gp.dt)
                    for k, v in supplied.items()}

    from .disagg import build_model_forcing
    return build_model_forcing(supplied, gp, domain, timeaxis, device)


def forcing_stats(forcing: dict) -> dict:
    """QC statistics per forcing variable (calc_forcing_stats.c: mean/sigma/
    min/max over the record). Returns {var: {mean, std, min, max}}."""
    out = {}
    for k, v in forcing.items():
        a = np.asarray(v, np.float64)
        out[k] = {"mean": float(a.mean()), "std": float(a.std()),
                  "min": float(a.min()), "max": float(a.max())}
    return out
