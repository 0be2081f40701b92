"""Host-side (numpy) parameter containers for the port.

Plain-dataclass copies of `vic_tpu.params` (`SoilParams`, `VegLib`,
`HruParams`, `BandParams`, `Domain`) and of the two helpers the synthetic
domain needs from `vic_tpu.io` (`derive_band_factors`, the veg library's
appended PET reference surfaces). They carry the same fields with the same
meaning; see `vic_tpu/params.py` for the reference-file provenance of each.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import constants as c

LAI_WATER_FACTOR = 0.2  # user_def.h:111


@dataclass
class SoilParams:
    """Per-cell soil/terrain parameters: [n_cell] or [n_cell, n_layer]."""
    lat: np.ndarray
    lng: np.ndarray
    gridcel: np.ndarray
    b_infilt: np.ndarray
    ds: np.ndarray
    dsmax: np.ndarray
    ws: np.ndarray
    c_expt: np.ndarray
    expt: np.ndarray
    ksat: np.ndarray
    phi_s: np.ndarray
    init_moist: np.ndarray
    elevation: np.ndarray
    depth: np.ndarray
    avg_temp: np.ndarray
    dp: np.ndarray
    bubble: np.ndarray
    quartz: np.ndarray
    organic: np.ndarray
    bulk_density: np.ndarray
    soil_density: np.ndarray
    off_gmt: np.ndarray
    rough: np.ndarray
    snow_rough: np.ndarray
    annual_prec: np.ndarray
    resid_moist: np.ndarray
    fs_active: np.ndarray
    avg_july_air_temp: np.ndarray
    porosity: np.ndarray
    max_moist: np.ndarray
    max_infil: np.ndarray
    wcr: np.ndarray
    wpwp: np.ndarray
    cell_area: np.ndarray
    new_snow_alb: np.ndarray
    snow_alb_accum_a: np.ndarray
    snow_alb_accum_b: np.ndarray
    snow_alb_thaw_a: np.ndarray
    snow_alb_thaw_b: np.ndarray
    min_rain_temp: np.ndarray
    max_snow_temp: np.ndarray
    padj_r: np.ndarray
    padj_s: np.ndarray
    t_lapse: np.ndarray
    pgrad: np.ndarray
    glac_surf_thick: np.ndarray
    glac_surf_we: np.ndarray
    glac_kmin: np.ndarray
    glac_dk: np.ndarray
    glac_a: np.ndarray
    glac_albedo: np.ndarray
    glac_rough: np.ndarray
    depth_full_snow_cover: np.ndarray

    @property
    def n_cell(self) -> int:
        return self.lat.shape[0]


@dataclass
class VegLib:
    """Vegetation library rows (+4 appended PET reference surfaces)."""
    veg_class: np.ndarray
    overstory: np.ndarray
    rarc: np.ndarray
    rmin: np.ndarray
    lai: np.ndarray
    wdmax: np.ndarray
    albedo: np.ndarray
    roughness: np.ndarray
    displacement: np.ndarray
    wind_h: np.ndarray
    rgl: np.ndarray
    rad_atten: np.ndarray
    wind_atten: np.ndarray
    trunk_ratio: np.ndarray

    @property
    def n_class(self) -> int:
        return self.veg_class.shape[0]


@dataclass
class HruParams:
    """The padded [n_cell, max_hru] HRU mosaic with its validity mask."""
    mask: np.ndarray
    veg_idx: np.ndarray
    cv: np.ndarray
    band: np.ndarray
    is_glacier: np.ndarray
    is_bare: np.ndarray
    root: np.ndarray
    lai_vegparam: np.ndarray
    wdmax: np.ndarray
    sigma_slope: np.ndarray
    lag_one: np.ndarray
    fetch: np.ndarray
    band_explicit: np.ndarray = None

    @property
    def max_hru(self) -> int:
        return self.mask.shape[1]


@dataclass
class BandParams:
    """Elevation snow bands [n_cell, n_band]."""
    area_fract: np.ndarray
    band_elev: np.ndarray
    tfactor: np.ndarray
    pfactor: np.ndarray


@dataclass
class Domain:
    soil: SoilParams
    veglib: VegLib
    hru: HruParams
    bands: BandParams
    cell_valid: np.ndarray = None

    def __post_init__(self):
        if self.cell_valid is None:
            self.cell_valid = np.ones(self.soil.n_cell, bool)

    @property
    def n_cell(self) -> int:
        return self.soil.n_cell


def derive_band_factors(soil: SoilParams, area_fract: np.ndarray,
                        band_elev: np.ndarray) -> BandParams:
    """Tfactor/Pfactor per band (read_snowband.c:66-117)."""
    elev = soil.elevation[:, None]
    tfactor = (elev - band_elev) / 1000.0 * soil.t_lapse[:, None]
    pfactor = (1.0 + soil.pgrad[:, None] * (band_elev - elev)) * area_fract
    tot = pfactor.sum(axis=1, keepdims=True)
    tot = np.where(tot <= 0, 1.0, tot)
    pfactor = pfactor / tot
    with np.errstate(divide="ignore", invalid="ignore"):
        pfactor = np.where(area_fract > 0, pfactor / area_fract, 0.0)
    return BandParams(area_fract=area_fract, band_elev=band_elev,
                      tfactor=tfactor, pfactor=pfactor)


def append_ref_surfaces(lib: VegLib) -> VegLib:
    """Append the 4 PET reference surfaces (read_veglib.c:118-135)."""
    n, m = lib.n_class, 4
    ones12 = np.ones((m, 12))

    def cat(a, b):
        return np.concatenate([a, np.asarray(b)])

    def cat12(a, ref):
        return np.concatenate([a, np.array(ref)[:, None] * ones12])

    return VegLib(
        veg_class=cat(lib.veg_class,
                      np.arange(n + 1, n + m + 1, dtype=np.int32)),
        overstory=cat(lib.overstory, np.array(c.REF_VEG_OVER)),
        rarc=cat(lib.rarc, np.array(c.REF_VEG_RARC)),
        rmin=cat(lib.rmin, np.array(c.REF_VEG_RMIN)),
        lai=cat12(lib.lai, c.REF_VEG_LAI),
        wdmax=np.concatenate(
            [lib.wdmax,
             LAI_WATER_FACTOR * np.array(c.REF_VEG_LAI)[:, None] * ones12]),
        albedo=cat12(lib.albedo, c.REF_VEG_ALBEDO),
        roughness=cat12(lib.roughness, c.REF_VEG_ROUGH),
        displacement=cat12(lib.displacement, c.REF_VEG_DISPL),
        wind_h=cat(lib.wind_h, np.array(c.REF_VEG_WIND_H)),
        rgl=cat(lib.rgl, np.array(c.REF_VEG_RGL)),
        rad_atten=cat(lib.rad_atten, np.array(c.REF_VEG_RAD_ATTEN)),
        wind_atten=cat(lib.wind_atten, np.array(c.REF_VEG_WIND_ATTEN)),
        trunk_ratio=cat(lib.trunk_ratio, np.array(c.REF_VEG_TRUNK_RATIO)),
    )
