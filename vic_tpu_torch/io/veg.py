"""Vegetation library and per-cell vegetation parameter readers, a copy of
`vic_tpu/io/veg.py`.

- `read_veglib` parses the reference veg library table (read_veglib.c:46-117:
  class, overstory, rarc, rmin, 12xLAI, 12xalbedo, 12xroughness, 12xdisplacement,
  wind_h, RGL, rad_atten, wind_atten, trunk_ratio) and appends the 4 PET
  reference-surface rows exactly as read_veglib.c:118-135 does.
- `read_vegparam` parses the per-cell tile list (read_vegparam.c:83-120:
  "cellnum Nveg" header then per tile "vegclass Cv  zd1 zf1 zd2 zf2 ...
  [sigma lag fetch] [LAI x12]") and constructs the padded HRU mosaic: each veg
  tile replicated across the SNOW_BAND elevation bands, glacier tiles flagged by
  vegClass == GLACIER_ID, and an artificial bare-soil tile appended when
  sum(Cv) < 1 (read_vegparam.c:313-339).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..params import (LAI_WATER_FACTOR, HruParams, VegLib,
                      append_ref_surfaces, compute_root_fractions)


def read_veglib(path: str) -> VegLib:
    rows = []
    with open(path) as f:
        for line in f:
            toks = line.split()
            if not toks or not toks[0][0].isdigit():
                continue
            rows.append(toks)
    n = len(rows)
    veg_class = np.zeros(n, np.int32)
    overstory = np.zeros(n, bool)
    rarc = np.zeros(n)
    rmin = np.zeros(n)
    lai = np.zeros((n, 12))
    albedo = np.zeros((n, 12))
    roughness = np.zeros((n, 12))
    displacement = np.zeros((n, 12))
    wind_h = np.zeros(n)
    rgl = np.zeros(n)
    rad_atten = np.zeros(n)
    wind_atten = np.zeros(n)
    trunk_ratio = np.zeros(n)
    for i, toks in enumerate(rows):
        vals = [float(t) for t in toks[:4 + 48 + 5]]
        veg_class[i] = int(vals[0])
        overstory[i] = vals[1] != 0
        rarc[i], rmin[i] = vals[2], vals[3]
        lai[i] = vals[4:16]
        albedo[i] = vals[16:28]
        roughness[i] = vals[28:40]
        displacement[i] = vals[40:52]
        wind_h[i] = vals[52]
        rgl[i] = vals[53]
        rad_atten[i] = vals[54]
        wind_atten[i] = vals[55]
        trunk_ratio[i] = vals[56]

    return append_ref_surfaces(VegLib(
        veg_class=veg_class, overstory=overstory, rarc=rarc, rmin=rmin,
        lai=lai, wdmax=LAI_WATER_FACTOR * lai, albedo=albedo,
        roughness=roughness, displacement=displacement, wind_h=wind_h, rgl=rgl,
        rad_atten=rad_atten, wind_atten=wind_atten, trunk_ratio=trunk_ratio))


@dataclass
class VegTile:
    veg_class: int
    cv: float
    zone_depth: list
    zone_fract: list
    sigma_slope: float = 0.0
    lag_one: float = 0.0
    fetch: float = 2500.0
    lai: list = None  # 12 monthly values if VEGPARAM_LAI
    band_index: int = -1  # PCIC explicit band (read_vegparam.c:186); -1 =
    #                       classic 4.1.2 replication across all bands


def read_vegparam_cell_tiles(path: str, gp):
    """Parse the veg parameter file into {cellnum: [VegTile, ...]}."""
    cells = {}
    with open(path) as f:
        lines = [ln.split() for ln in f if ln.strip()]
    i = 0
    while i < len(lines):
        cellnum, nveg = int(lines[i][0]), int(lines[i][1])
        i += 1
        tiles = []
        for _ in range(nveg):
            toks = [float(t) for t in lines[i]]
            i += 1
            k = 2
            zd, zf = [], []
            for _ in range(gp.root_zones):
                zd.append(toks[k]); zf.append(toks[k + 1]); k += 2
            tile = VegTile(veg_class=int(toks[0]), cv=toks[1],
                           zone_depth=zd, zone_fract=zf)
            if gp.blowing:
                tile.sigma_slope, tile.lag_one, tile.fetch = toks[k:k + 3]
                k += 3
            if len(toks) > k:
                # trailing PCIC bandIndex column (read_vegparam.c:186-187)
                tile.band_index = int(toks[k])
            if gp.vegparam_lai:
                tile.lai = [float(t) for t in lines[i]]
                i += 1
            tiles.append(tile)
        cells[cellnum] = tiles
    return cells


def build_hru_params(cell_tiles: dict, cell_order, veglib: VegLib, gp,
                     layer_depth: np.ndarray) -> HruParams:
    """Construct the padded [n_cell, max_hru] HRU mosaic.

    cell_order: sequence of cell ids defining the cell axis (soil-file order).
    layer_depth: [n_cell, n_layer] soil layer thicknesses for root fractions.
    """
    n_band = gp.snow_band
    # FIRST match within the REAL library rows only (getVegIndex,
    # read_vegparam.c:33-41 scans j < num_veg_types and breaks) — the 4
    # appended PET reference surfaces carry classes Nveg+1..Nveg+4 that can
    # COLLIDE with real classes in sparse numbering (e.g. a library with
    # classes {1,4,3}: appended 4..7 shadow the real conifer 4); a
    # last-match dict silently resolved the close-config conifer to a PET
    # surface with overstory=FALSE, disabling the overstory path entirely
    n_real = len(veglib.veg_class) - 4
    class_to_idx = {}
    for j, vc in enumerate(veglib.veg_class[:n_real]):
        class_to_idx.setdefault(int(vc), j)
    nl = layer_depth.shape[1]

    per_cell = []
    for ci, cellnum in enumerate(cell_order):
        tiles = list(cell_tiles.get(int(cellnum), []))
        # normalize Cv / append artificial bare soil (read_vegparam.c:301-339)
        cv_sum = sum(t.cv for t in tiles)
        if cv_sum > 1.0:
            for t in tiles:
                t.cv /= cv_sum
            cv_sum = 1.0
        bare_cv = max(0.0, 1.0 - cv_sum)
        # PCIC grammar always carries an explicit bandIndex column
        # (read_vegparam.c:233); with SNOW_BAND=1 both interpretations are
        # identical (AreaFract=[1.0]) and we take the explicit branch.
        explicit = (n_band == 1
                    or all(t.band_index >= 0 for t in tiles) and tiles)
        hrus = []
        for t in tiles:
            root = compute_root_fractions(t.zone_depth, t.zone_fract,
                                          layer_depth[ci])
            if t.band_index >= 0 and n_band > 1:
                # PCIC: one HRU at the tile's declared band whose Cv is the
                # full cell-area share (read_vegparam.c:186-187,233;
                # put_data.c:789 weights by Cv alone)
                hrus.append((t, t.band_index, root, False, t.cv, True))
            else:
                # classic 4.1.2: tile replicated across the snow bands; the
                # cell share of each replica is cv * AreaFract[band]
                # (applied in prepare_domain, which owns the band table)
                for b in range(n_band):
                    hrus.append((t, b, root, False, t.cv, False))
        if bare_cv > 1e-10:
            if explicit:
                # artificial bare soil split equally across bands
                # (read_vegparam.c:313-320: CvPerBand=(1-Cv_sum)/SNOW_BAND)
                for b in range(n_band):
                    hrus.append((None, b, np.ones(nl) / nl, True,
                                 bare_cv / n_band, True))
            else:
                for b in range(n_band):
                    hrus.append((None, b, np.ones(nl) / nl, True,
                                 bare_cv, False))
        per_cell.append(hrus)

    max_hru = max((len(h) for h in per_cell), default=1)
    n_cell = len(cell_order)
    P = lambda *s: np.zeros((n_cell, max_hru) + s)
    mask = np.zeros((n_cell, max_hru), bool)
    veg_idx = np.zeros((n_cell, max_hru), np.int32)
    cv = P()
    band = np.zeros((n_cell, max_hru), np.int32)
    is_glacier = np.zeros((n_cell, max_hru), bool)
    is_bare = np.zeros((n_cell, max_hru), bool)
    root = P(nl)
    lai_vp = P(12)
    sigma_slope = P()
    lag_one = P()
    fetch = np.full((n_cell, max_hru), 2500.0)

    band_explicit = np.zeros((n_cell, max_hru), bool)
    for ci, hrus in enumerate(per_cell):
        for hi, (t, b, r, bare, cv_h, expl) in enumerate(hrus):
            mask[ci, hi] = True
            band[ci, hi] = b
            root[ci, hi] = r
            band_explicit[ci, hi] = expl
            cv[ci, hi] = cv_h
            if bare:
                is_bare[ci, hi] = True
                # bare soil uses the last veglib row semantics? reference treats
                # artificial bare HRUs with no veg library entry; index 0 is a
                # placeholder — physics gates on is_bare.
                veg_idx[ci, hi] = 0
                lai_vp[ci, hi] = 0.0
            else:
                vidx = class_to_idx[t.veg_class]
                veg_idx[ci, hi] = vidx
                is_glacier[ci, hi] = (t.veg_class == gp.glacier_id)
                lai_vp[ci, hi] = (np.asarray(t.lai) if t.lai is not None
                                  else veglib.lai[vidx])
                sigma_slope[ci, hi] = t.sigma_slope
                lag_one[ci, hi] = t.lag_one
                fetch[ci, hi] = t.fetch

    return HruParams(mask=mask, veg_idx=veg_idx, cv=cv, band=band,
                     is_glacier=is_glacier, is_bare=is_bare, root=root,
                     lai_vegparam=lai_vp, wdmax=LAI_WATER_FACTOR * lai_vp,
                     sigma_slope=sigma_slope, lag_one=lag_one, fetch=fetch,
                     band_explicit=band_explicit)
