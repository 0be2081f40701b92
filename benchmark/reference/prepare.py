"""Host-side preparation: Domain -> dense per-HRU parameter tensors.

Counterpart of `vic_tpu/prepare.py`: veg-library rows are gathered by each
HRU's veg class and band factors by each HRU's band into `[n_cell,
max_hru(, ...)]` tensors, so the step only indexes the month.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .params import Domain
from .tensors import TensorDataclass


@dataclass
class DeviceParams(TensorDataclass):
    """Static per-HRU/per-cell parameters. [c,h] = [n_cell, max_hru]."""
    mask: torch.Tensor            # [c,h] bool
    weight: torch.Tensor          # [c,h] HRU cell share
    cv: torch.Tensor
    is_glacier: torch.Tensor
    is_bare: torch.Tensor
    root: torch.Tensor            # [c,h,nl]
    band: torch.Tensor            # [c,h] int32
    tfactor: torch.Tensor
    pfactor: torch.Tensor
    sigma_slope: torch.Tensor
    lag_one: torch.Tensor
    fetch: torch.Tensor
    overstory: torch.Tensor       # [c,h] bool
    lai_m: torch.Tensor           # [c,h,12]
    wdmax_m: torch.Tensor
    albedo_m: torch.Tensor
    roughness_m: torch.Tensor
    displacement_m: torch.Tensor
    rmin: torch.Tensor
    rarc: torch.Tensor
    rgl: torch.Tensor
    rad_atten: torch.Tensor
    wind_atten: torch.Tensor
    trunk_ratio: torch.Tensor
    wind_h: torch.Tensor
    veg_height: torch.Tensor
    elevation: torch.Tensor       # [c]
    lat: torch.Tensor
    b_infilt: torch.Tensor
    ds: torch.Tensor
    dsmax: torch.Tensor
    ws: torch.Tensor
    c_expt: torch.Tensor
    expt: torch.Tensor            # [c,nl]
    ksat: torch.Tensor
    depth: torch.Tensor
    max_moist: torch.Tensor
    resid_moist: torch.Tensor
    wcr: torch.Tensor
    wpwp: torch.Tensor
    bubble: torch.Tensor
    quartz: torch.Tensor
    organic: torch.Tensor
    bulk_density: torch.Tensor
    soil_density: torch.Tensor
    bulk_dens_min: torch.Tensor
    soil_dens_min: torch.Tensor
    dp: torch.Tensor              # [c]
    avg_temp: torch.Tensor
    rough: torch.Tensor
    snow_rough: torch.Tensor
    fs_active: torch.Tensor       # [c] bool
    max_infil: torch.Tensor
    annual_prec: torch.Tensor
    cell_area: torch.Tensor
    new_snow_alb: torch.Tensor
    snow_alb_accum_a: torch.Tensor
    snow_alb_accum_b: torch.Tensor
    snow_alb_thaw_a: torch.Tensor
    snow_alb_thaw_b: torch.Tensor
    min_rain_temp: torch.Tensor
    max_snow_temp: torch.Tensor
    padj_r: torch.Tensor
    padj_s: torch.Tensor
    glac_surf_thick: torch.Tensor
    glac_surf_we: torch.Tensor
    glac_kmin: torch.Tensor
    glac_dk: torch.Tensor
    glac_a: torch.Tensor
    glac_albedo: torch.Tensor
    glac_rough: torch.Tensor
    depth_full_snow_cover: torch.Tensor
    band_elev: torch.Tensor       # [c,h]

    @property
    def n_cell(self):
        return self.mask.shape[0]

    @property
    def max_hru(self):
        return self.mask.shape[1]


def prepare_domain(domain: Domain, gp, device,
                   above_treeline: np.ndarray = None) -> DeviceParams:
    """Gather the domain's parameters into per-HRU tensors on `device`
    (vic_tpu/prepare.py:127-231).

    above_treeline: optional [n_cell, n_band] bool (compute_treeline):
    overstory HRUs in above-treeline bands are excluded from the mosaic and
    the remaining weights in those bands are rescaled by the TreeAdjustFactor
    1/(1 - sum(Cv_excluded)) (put_data.c:196-211, read_vegparam.c:301)."""
    hru, soil, lib, bands = domain.hru, domain.soil, domain.veglib, domain.bands
    vi = hru.veg_idx

    def band_gather(a):
        return np.take_along_axis(a, hru.band, axis=1)

    band_af = band_gather(bands.area_fract)
    explicit = (hru.band_explicit if hru.band_explicit is not None
                else np.zeros_like(hru.mask))
    weight = hru.cv * np.where(explicit, 1.0, band_af)
    weight = np.where(hru.mask & (band_af > 0.0), weight, 0.0)
    mask = hru.mask & (band_af > 0.0)
    no_veg = hru.is_bare | hru.is_glacier

    if above_treeline is not None:
        hru_above = np.take_along_axis(np.asarray(above_treeline), hru.band,
                                       axis=1)
        excluded = np.where(no_veg, False, lib.overstory[vi]) & hru_above \
            & mask
        if excluded.any():
            # TreeAdjustFactor per band: 1/(1 - sum Cv_excluded_in_band)
            for b in range(bands.area_fract.shape[1]):
                in_band = (hru.band == b) & mask
                cv_excl = np.where(excluded & in_band, hru.cv, 0.0).sum(1)
                adj = 1.0 / np.maximum(1.0 - cv_excl, 1e-10)
                keep = in_band & ~excluded
                weight = np.where(keep, weight * adj[:, None], weight)
            weight = np.where(excluded, 0.0, weight)
            mask = mask & ~excluded

    arrays = dict(
        mask=mask, weight=weight, cv=hru.cv, is_glacier=hru.is_glacier,
        is_bare=hru.is_bare, root=hru.root, band=hru.band,
        tfactor=band_gather(bands.tfactor), pfactor=band_gather(bands.pfactor),
        sigma_slope=hru.sigma_slope, lag_one=hru.lag_one, fetch=hru.fetch,
        overstory=np.where(no_veg, False, lib.overstory[vi]),
        lai_m=np.where(no_veg[..., None], 0.0, hru.lai_vegparam),
        wdmax_m=np.where(no_veg[..., None], 0.0, hru.wdmax),
        albedo_m=lib.albedo[vi], roughness_m=lib.roughness[vi],
        displacement_m=lib.displacement[vi],
        rmin=lib.rmin[vi], rarc=lib.rarc[vi], rgl=lib.rgl[vi],
        rad_atten=lib.rad_atten[vi], wind_atten=lib.wind_atten[vi],
        trunk_ratio=lib.trunk_ratio[vi], wind_h=lib.wind_h[vi],
        # calc_veg_params.c: height = displacement / 0.67
        veg_height=lib.displacement[vi].max(-1) / 0.67,
        bulk_dens_min=soil.bulk_density, soil_dens_min=soil.soil_density,
        band_elev=band_gather(bands.band_elev),
    )
    for name in ("elevation", "lat", "b_infilt", "ds", "dsmax", "ws",
                 "c_expt", "expt", "ksat", "depth", "max_moist",
                 "resid_moist", "wcr", "wpwp", "bubble", "quartz", "organic",
                 "bulk_density", "soil_density", "dp", "avg_temp", "rough",
                 "snow_rough", "fs_active", "max_infil", "annual_prec",
                 "cell_area", "new_snow_alb", "snow_alb_accum_a",
                 "snow_alb_accum_b", "snow_alb_thaw_a", "snow_alb_thaw_b",
                 "min_rain_temp", "max_snow_temp", "padj_r", "padj_s",
                 "glac_surf_thick", "glac_surf_we", "glac_kmin", "glac_dk",
                 "glac_a", "glac_albedo", "glac_rough",
                 "depth_full_snow_cover"):
        arrays[name] = getattr(soil, name)
    return device_params_from_numpy(arrays, device)


def device_params_from_numpy(arrays: dict, device) -> DeviceParams:
    """DeviceParams from one numpy array per field (floats become float32,
    masks bool, indices int32)."""
    return DeviceParams.from_numpy(arrays, device)
