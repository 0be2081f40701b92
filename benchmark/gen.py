"""The benchmark's inputs from its seed: a synthetic domain and its forcing.

A frozen copy of `vic_tpu_torch.testing`'s `synthetic_veglib`,
`synthetic_soil`, `synthetic_domain` and `synthetic_forcing` (the same
random streams and parameter ranges), built on the reference's parameter
classes. The harness hands the same arrays to the program (as the
program's own classes) and to the reference, so a later change to the
program's generators cannot move the benchmark's inputs.
"""
from __future__ import annotations

import datetime

import numpy as np

from .reference import constants as c
from .reference.params import (LAI_WATER_FACTOR, Domain, HruParams,
                               SoilParams, VegLib, append_ref_surfaces,
                               derive_band_factors)


def synthetic_veglib() -> VegLib:
    """Two veg classes: 1=conifer overstory, 2=short grass."""
    lai = np.array([
        [3.4, 3.4, 3.5, 3.7, 4.0, 4.4, 4.4, 4.2, 4.0, 3.7, 3.5, 3.4],
        [0.5, 0.5, 0.8, 1.2, 2.0, 2.6, 2.6, 2.2, 1.5, 0.9, 0.6, 0.5],
    ])
    return append_ref_surfaces(VegLib(
        veg_class=np.array([1, 2], np.int32),
        overstory=np.array([True, False]),
        rarc=np.array([60.0, 25.0]),
        rmin=np.array([250.0, 150.0]),
        lai=lai,
        wdmax=LAI_WATER_FACTOR * lai,
        albedo=np.full((2, 12), 0.12) + np.array([[0.0], [0.08]]),
        roughness=np.stack([np.full(12, 1.2), np.full(12, 0.03)]),
        displacement=np.stack([np.full(12, 8.0), np.full(12, 0.2)]),
        wind_h=np.array([12.0, 2.0]),
        rgl=np.array([30.0, 100.0]),
        rad_atten=np.array([0.5, 0.0]),
        wind_atten=np.array([0.5, 0.0]),
        trunk_ratio=np.array([0.2, 0.0]),
    ))


def synthetic_soil(n_cell: int, n_layer: int = 3, seed: int = 0) -> SoilParams:
    rng = np.random.default_rng(seed)

    def U(lo, hi, *s):
        return rng.uniform(lo, hi, (n_cell,) + tuple(s))

    depth = np.stack([np.full(n_cell, 0.1), U(0.3, 0.8), U(0.5, 2.0)],
                     1)[:, :n_layer]
    bulk_density = U(1200.0, 1500.0, n_layer)
    soil_density = np.full((n_cell, n_layer), 2685.0)
    porosity = 1.0 - bulk_density / soil_density
    max_moist = depth * porosity * 1000.0
    resid = np.full((n_cell, n_layer), 0.02)
    init_moist = 0.7 * max_moist
    b_infilt = U(0.1, 0.4)
    wcr_fract = np.full((n_cell, n_layer), 0.7 * 0.6)
    wpwp_fract = np.full((n_cell, n_layer), 0.3)
    lat = 51.0 + 0.125 * (np.arange(n_cell) % 16)
    lng = -116.0 - 0.125 * (np.arange(n_cell) // 16)
    elevation = U(800.0, 2500.0)
    max_infil = ((1.0 + b_infilt) * (max_moist[:, 0] + max_moist[:, 1])
                 if n_layer >= 3 else (1.0 + b_infilt) * max_moist[:, 0])

    def g(v):
        return np.full(n_cell, v)

    return SoilParams(
        lat=lat, lng=lng, gridcel=np.arange(n_cell, dtype=np.int32),
        b_infilt=b_infilt, ds=U(0.001, 0.3), dsmax=U(5.0, 30.0),
        ws=U(0.7, 0.95), c_expt=g(2.0),
        expt=U(8.0, 14.0, n_layer), ksat=U(100.0, 1000.0, n_layer),
        phi_s=np.full((n_cell, n_layer), -999.0),
        init_moist=init_moist, elevation=elevation, depth=depth,
        avg_temp=U(-2.0, 8.0), dp=g(4.0),
        bubble=U(4.0, 30.0, n_layer), quartz=U(0.2, 0.7, n_layer),
        organic=np.zeros((n_cell, n_layer)),
        bulk_density=bulk_density, soil_density=soil_density,
        off_gmt=g(-120.0), rough=g(0.001), snow_rough=g(0.0005),
        annual_prec=U(300.0, 2000.0), resid_moist=resid,
        fs_active=np.ones(n_cell, bool),
        avg_july_air_temp=U(10.0, 18.0),
        porosity=porosity, max_moist=max_moist, max_infil=max_infil,
        wcr=wcr_fract * max_moist, wpwp=wpwp_fract * max_moist,
        cell_area=g(1.2e8),
        new_snow_alb=g(c.SNOW_NEW_SNOW_ALB),
        snow_alb_accum_a=g(c.SNOW_ALB_ACCUM_A),
        snow_alb_accum_b=g(c.SNOW_ALB_ACCUM_B),
        snow_alb_thaw_a=g(c.SNOW_ALB_THAW_A),
        snow_alb_thaw_b=g(c.SNOW_ALB_THAW_B),
        min_rain_temp=g(-0.5), max_snow_temp=g(0.5),
        padj_r=g(1.0), padj_s=g(1.0), t_lapse=g(6.5), pgrad=g(0.0),
        glac_surf_thick=g(100.0), glac_surf_we=g(91.7),
        glac_kmin=g(0.01), glac_dk=g(0.24), glac_a=g(20.0),
        glac_albedo=g(0.3), glac_rough=g(0.002),
        depth_full_snow_cover=g(0.1),
    )


def synthetic_domain(n_cell: int = 8, n_layer: int = 3, n_band: int = 1,
                     with_glacier: bool = False, seed: int = 0) -> Domain:
    """2-3 HRU tiles per band: conifer (Cv 0.5), grass (0.3), bare (0.2),
    plus an optional glacier HRU carved out of the bare fraction."""
    soil = synthetic_soil(n_cell, n_layer, seed)
    veglib = synthetic_veglib()

    if n_band > 1:
        spread = np.linspace(-400.0, 400.0, n_band)
        band_elev = soil.elevation[:, None] + spread[None, :]
        area = np.full((n_cell, n_band), 1.0 / n_band)
        bands = derive_band_factors(soil, area, band_elev)
    else:
        bands = derive_band_factors(
            soil, np.ones((n_cell, 1)), soil.elevation[:, None].copy())

    tiles = [(0, 0.5, False, False), (1, 0.3, False, False)]
    if with_glacier:
        tiles += [(0, 0.1, False, True), (0, 0.1, True, False)]
    else:
        tiles += [(0, 0.2, True, False)]

    shape = (n_cell, len(tiles) * n_band)
    veg_idx = np.zeros(shape, np.int32)
    cv = np.zeros(shape)
    band = np.zeros(shape, np.int32)
    is_glacier = np.zeros(shape, bool)
    is_bare = np.zeros(shape, bool)
    root = np.zeros(shape + (n_layer,))
    lai_vp = np.zeros(shape + (12,))
    root_frac = np.array([0.3, 0.5, 0.2])[:n_layer]
    hi = 0
    for vi, tcv, bare, glac in tiles:
        for b in range(n_band):
            veg_idx[:, hi] = vi
            cv[:, hi] = tcv
            band[:, hi] = b
            is_bare[:, hi] = bare
            is_glacier[:, hi] = glac
            root[:, hi] = root_frac / root_frac.sum()
            lai_vp[:, hi] = 0.0 if (bare or glac) else veglib.lai[vi]
            hi += 1

    hru = HruParams(mask=np.ones(shape, bool), veg_idx=veg_idx, cv=cv,
                    band=band, is_glacier=is_glacier, is_bare=is_bare,
                    root=root, lai_vegparam=lai_vp,
                    wdmax=LAI_WATER_FACTOR * lai_vp,
                    sigma_slope=np.full(shape, 0.005),
                    lag_one=np.full(shape, 0.95),
                    fetch=np.full(shape, 2500.0))
    return Domain(soil=soil, veglib=veglib, hru=hru, bands=bands)


def synthetic_forcing(n_rec: int, n_cell: int, dt_hours: int = 24,
                      seed: int = 3, start_doy: int = 1):
    """Met forcing dict of [n_rec, n_cell] float64 arrays: prec (mm/step),
    air_temp (C), wind (m/s), shortwave, longwave (W/m^2), pressure, vp (Pa),
    density (kg/m^3). A seasonal cycle plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_rec)[:, None] * (dt_hours / 24.0)
    doy = (start_doy - 1 + t) % 365.25
    season = np.cos(2 * np.pi * (doy - 200.0) / 365.25)
    air_temp = 2.0 + 12.0 * season + rng.normal(0, 2.5, (n_rec, n_cell))
    prec = np.where(rng.random((n_rec, n_cell)) < 0.35,
                    rng.gamma(1.5, 4.0, (n_rec, n_cell)),
                    0.0) * (dt_hours / 24.0)
    wind = np.clip(rng.gamma(2.0, 1.3, (n_rec, n_cell)), 0.2, None)
    shortwave = np.clip(180.0 + 160.0 * season
                        + rng.normal(0, 30.0, (n_rec, n_cell)), 0.0, None)
    svp = 610.78 * np.exp(17.269 * air_temp / (237.3 + air_temp))
    vp = np.clip(svp * rng.uniform(0.4, 0.95, (n_rec, n_cell)), 10.0, None)
    pressure = np.full((n_rec, n_cell), 85000.0)
    density = pressure / (287.0 * (273.15 + air_temp))
    longwave = 0.85 * 5.6696e-8 * (air_temp + 273.15) ** 4
    return {
        "prec": prec, "air_temp": air_temp, "wind": wind,
        "shortwave": shortwave, "longwave": longwave,
        "pressure": pressure, "vp": vp, "density": density,
    }


def run_seeds(seed: int):
    """(soil seed, forcing seed, check seed) of a run's --seed: the
    program's generators take soil seed 0 and forcing seed 3 by default,
    so seed s gives s and s + 3; any whole number is taken modulo 2**64."""
    s = seed % 2 ** 64
    return s, s + 3, s + 7


def day_of_year(start) -> int:
    return datetime.date(*start).timetuple().tm_yday


def cell_domain(cfg: dict, traffic: dict, seed: int):
    """A cell's domain: the configuration's layout over the traffic's
    cells."""
    lay = cfg["domain"]
    return synthetic_domain(n_cell=traffic["n_cell"], n_layer=lay["n_layer"],
                            n_band=lay["n_band"],
                            with_glacier=lay["with_glacier"],
                            seed=run_seeds(seed)[0])


def cell_forcing(cfg: dict, traffic: dict, seed: int):
    """One block of a cell's forcing from the traffic's start date."""
    return synthetic_forcing(traffic["block_records"], traffic["n_cell"],
                             dt_hours=cfg["global_params"]["dt"],
                             seed=run_seeds(seed)[1],
                             start_doy=day_of_year(traffic["start"]))


def cell_inputs(cfg: dict, traffic: dict, seed: int):
    """(domain, forcing) of a cell."""
    return cell_domain(cfg, traffic, seed), cell_forcing(cfg, traffic, seed)
