"""Elevation snow-band file reader (read_snowband.c:40-117), a copy of
`vic_tpu/io/snowband.py`.

File format: one line per cell: ``cellnum  AreaFract x nband  BandElev x nband
[Pfactor x nband -- ignored: PCIC derives Pfactor from PGRAD]``.

Derived per-band quantities (read_snowband.c:66-117):
  Tfactor[b] = (elev - BandElev[b]) / 1000 * T_LAPSE     (additive C)
  Pfactor[b] = (1 + PGRAD*(BandElev[b] - elev)) * AreaFract[b], renormalized to
               sum 1, then divided by AreaFract[b]       (multiplicative)
"""
from __future__ import annotations

import numpy as np

from ..params import BandParams, SoilParams, derive_band_factors


def default_bands(soil: SoilParams, n_band: int) -> BandParams:
    """Single-band (or uniform) default: all area in band 0 at cell elevation."""
    n_cell = soil.n_cell
    area = np.zeros((n_cell, n_band))
    area[:, 0] = 1.0
    elev = np.tile(soil.elevation[:, None], (1, n_band))
    return derive_band_factors(soil, area, elev)


def read_snowband_file(path: str, soil: SoilParams, n_band: int) -> BandParams:
    if n_band == 1:
        return default_bands(soil, 1)
    table = {}
    with open(path) as f:
        for line in f:
            toks = line.split()
            if not toks:
                continue
            cellnum = int(float(toks[0]))
            vals = [float(t) for t in toks[1:]]
            area = np.asarray(vals[:n_band])
            elev = np.asarray(vals[n_band:2 * n_band])
            s = area.sum()
            if s > 0 and abs(s - 1.0) > 1e-12:
                area = area / s          # renormalize (read_snowband.c:70-75)
            table[cellnum] = (area, elev)

    n_cell = soil.n_cell
    area_fract = np.zeros((n_cell, n_band))
    band_elev = np.tile(soil.elevation[:, None], (1, n_band))
    area_fract[:, 0] = 1.0
    elevation = soil.elevation.copy()
    for ci, cellnum in enumerate(soil.gridcel):
        if int(cellnum) in table:
            area, elev = table[int(cellnum)]
            area_fract[ci] = area
            band_elev[ci] = elev
            # reset cell elevation to area-weighted band elevation when they
            # disagree by > 1 m (read_snowband.c:86-89)
            avg = float((area * elev).sum())
            if abs(avg - elevation[ci]) > 1.0:
                elevation[ci] = avg
    soil.elevation[:] = elevation
    return derive_band_factors(soil, area_fract, band_elev)
