"""Synthetic domain and forcing builders (numpy only, seeded), the spring
snowpack of the spatial_snow configuration, and the rules a lakes run is
compared with vic_tpu's by.

The builders are counterparts of `vic_tpu.testing`: the same random streams
and the same parameter ranges, so both packages build identical inputs
from a seed.
"""
from __future__ import annotations

import datetime

import numpy as np

from . import constants as c
from .params import (LAI_WATER_FACTOR, Domain, HruParams, SoilParams, VegLib,
                     append_ref_surfaces, derive_band_factors)


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


# The spatial_snow configuration starts on 1 May (day 121) with a melting
# spring pack, so its coverage leaves {0, 1} within the first records: a
# pack under 5 cm (dfsc/2 of the synthetic soil) that melts covers
# depth/old_depth of its lane (calc_snow_coverage.c:82-141)
SPRING_START = (1995, 5, 1)
SPRING_DOY = datetime.date(*SPRING_START).timetuple().tm_yday


def spring_pack(mask, seed: int = 7) -> dict:
    """A ripe spring snowpack on the lanes of `mask` ([n_cell, max_hru]
    bool, numpy): 5-120 mm of water equivalent at 250-350 kg/m^3 and 0 C,
    fully covering, aged 5 days at albedo 0.7, melting. Returns the
    ModelState fields it sets, as numpy arrays that both packages' states
    take (float32, int32, bool)."""
    rng = np.random.default_rng(seed)
    mask = np.asarray(mask, bool)
    swq = np.where(mask, rng.uniform(0.005, 0.12, mask.shape), 0.0)
    density = np.where(mask, rng.uniform(250.0, 350.0, mask.shape), 0.0)
    depth = np.where(mask, 1000.0 * swq / np.maximum(density, 1.0), 0.0)
    f32 = np.float32
    return dict(swq=swq.astype(f32), density=density.astype(f32),
                depth=depth.astype(f32), coverage=mask.astype(f32),
                albedo=np.where(mask, 0.7, 0.0).astype(f32),
                last_snow=np.where(mask, 5, 0).astype(np.int32),
                melting=mask.copy(), snow_flag=mask.copy(),
                snow_store_coverage=mask.astype(f32))


# --------------------------------------------------------------------------
# Comparing a lakes run with vic_tpu's (the tests and chip_smoke.py)
# --------------------------------------------------------------------------

# the seeded lakes of ice_melt_inputs, by what each group is made to do:
# melt at 0 C into the pack (case 1), into the surface layer (case 2),
# into the lake ice (case 3) or through all of it (the complete melt); a
# thin pack; a subfreezing surface solved by the Brent; the same masked
# out of the solve (the fallback to old_tsurf); NaN air temperature
ICE_MELT_KINDS = ("melt_pack", "melt_surface", "melt_into_ice", "melt_all",
                  "thin", "brent", "masked", "nan")


def ice_melt_inputs(n_lake: int = 64, seed: int = 15):
    """Keyword arguments of lake_ice_melt over n_lake lakes (a multiple of
    len(ICE_MELT_KINDS)) as float32 numpy arrays, one group of lakes a kind
    of ICE_MELT_KINDS in turn (`kinds`, the kind of each lake), drawn from
    `seed`: masses in m over the ice, vapour pressures and pressure in Pa,
    daily steps. Returns (kwargs, kinds); kwargs holds dt_sec and the
    `active` mask (False on the "masked" lakes)."""
    rng = np.random.default_rng(seed)
    kinds = np.repeat(np.arange(len(ICE_MELT_KINDS)),
                      n_lake // len(ICE_MELT_KINDS))
    name = np.array(ICE_MELT_KINDS)[kinds]

    def u(lo, hi):
        return rng.uniform(lo, hi, n_lake)

    melting = kinds <= 3
    # snow, lake ice and liquid water of each kind (m over the ice)
    swq = np.select([name == "melt_pack", name == "melt_surface",
                     name == "melt_into_ice", name == "melt_all",
                     name == "thin"],
                    [u(0.25, 0.32), u(0.07, 0.10), u(0.015, 0.025),
                     u(0.002, 0.004), u(0.0002, 0.0006)], u(0.08, 0.2))
    lake_ice_m = np.select([name == "melt_all", name == "thin"],
                           [u(0.005, 0.012), np.zeros(n_lake)],
                           u(0.25, 0.45))
    surf_water = np.where(melting, u(0.0, 0.002), u(0.0, 0.0005))
    pack_water = np.where(name == "melt_pack", u(0.0, 0.003), 0.0)
    tair = np.where(melting, u(3.0, 8.0), u(-22.0, -4.0))
    tair = np.where(name == "melt_all", u(10.0, 14.0), tair)
    surf_temp = np.where(melting, u(-0.8, 0.0), u(-16.0, -3.0))
    pack_temp = np.where(melting, u(-0.6, 0.0), u(-12.0, -2.0))
    net_short = np.where(melting, u(180.0, 320.0), u(20.0, 110.0))
    net_short = np.where(name == "melt_all", u(380.0, 450.0), net_short)
    longwave_in = np.where(melting, u(300.0, 335.0), u(170.0, 250.0))
    # svp (evap.svp) in Pa at tair, 70-90% humid air
    svp = 610.78 * np.exp(17.269 * tair / (237.3 + tair))
    svp = np.where(tair < 0.0, svp * (1.0 + 0.00972 * tair
                                      + 0.000042 * tair * tair), svp)
    vp_air = svp * u(0.7, 0.9)
    blowing = np.where(name == "brent", u(-3e-6, 0.0), 0.0)
    kw = dict(
        swq=swq, surf_temp=surf_temp, pack_temp=pack_temp,
        surf_water=surf_water, pack_water=pack_water, lake_ice_m=lake_ice_m,
        hice=u(0.25, 0.6), rainfall_mm=np.where(melting, u(0.0, 4.0), 0.0),
        snowfall_mm=np.where(name == "brent", u(0.0, 25.0), 0.0),
        tair=np.where(name == "nan", np.nan, tair), wind=u(1.5, 7.0),
        vp_air=vp_air, vpd=svp - vp_air, pressure=u(90000.0, 101000.0),
        air_dens=u(1.15, 1.35), longwave_in=longwave_in,
        net_short=net_short, tcutoff=np.zeros(n_lake), ra=u(80.0, 300.0),
        z_ref=np.full(n_lake, 2.005), roughness=np.full(n_lake, 0.005),
        blowing_flux=blowing)
    kw = {k: np.asarray(v, np.float32) for k, v in kw.items()}
    kw.update(dt_sec=86400.0, active=name != "masked")
    return kw, name


# Two kinds of lake leaf cannot agree at a fixed tolerance between two
# float32 programs that round differently (ROADMAP.md queue 3):
# - the storage residuals OUT_LAKE_ENERGY_ERROR and OUT_LAKE_WATER_ERROR
#   are differences of float32 sums of ~1e16 J and ~1e8 m^3; they are held
#   within LAKE_ENERGY_ULPS ulps of the column energy over (area x dt) and
#   LAKE_WATER_ULPS ulps of the lake volume over the area;
# - the convective mix near 4 C compares neighbouring layers' densities
#   that differ by about one float32 ulp, so an ulp of difference in a
#   temperature can decide whether a pair mixes: a lake temperature may
#   differ only inside a run of adjacent layers whose densities lie within
#   LAKE_RHO_BAND of each other, by at most that run's temperature spread.
# The m^3 leaves (OUT_LAKE_*_V) are compared in mm over the cell, the unit
# of their mm twins.
LAKE_ENERGY_ULPS = 20
LAKE_WATER_ULPS = 32
LAKE_RHO_BAND = 2.5e-4     # kg/m^3, four float32 ulps at 1000 kg/m^3


def mixed_column_excess(got, ref, tol):
    """(row, layer) of the lake temperatures [..., n_layer], flattened to
    rows of layers, that differ from `ref` beyond tol and are not explained
    by a mix that fell the other way (see LAKE_RHO_BAND)."""
    import torch

    from .physics.lake import water_density
    got = np.asarray(got).reshape(-1, np.shape(ref)[-1])
    ref = np.asarray(ref, np.float32).reshape(got.shape)
    rho = water_density(torch.from_numpy(ref)).numpy()
    diff = np.abs(got - ref)
    bad = []
    for c_, k in zip(*np.nonzero(diff > tol + tol * np.abs(ref))):
        lo = hi = k
        while lo > 0 and abs(rho[c_, lo - 1] - rho[c_, k]) <= LAKE_RHO_BAND:
            lo -= 1
        while hi < ref.shape[1] - 1 and \
                abs(rho[c_, hi + 1] - rho[c_, k]) <= LAKE_RHO_BAND:
            hi += 1
        spread = ref[c_, lo:hi + 1].max() - ref[c_, lo:hi + 1].min()
        if hi == lo or diff[c_, k] > spread + tol:
            bad.append((int(c_), int(k)))
    return bad


def _failed(ref: dict, got: dict, ok_of) -> list:
    """Keys of `ref` whose value in `got` has another shape or dtype,
    differs where it is not a float, or fails ok_of(key, ref value, got
    value), a bool array of the elements that agree, anywhere."""
    failed = []
    for key, a in ref.items():
        a, b = np.asarray(a), np.asarray(got[key])
        if a.shape != b.shape or a.dtype != b.dtype:
            failed.append(key)
        elif a.dtype.kind != "f":
            if not np.array_equal(a, b):
                failed.append(key)
        elif not ok_of(key, a, b).all():
            failed.append(key)
    return failed


def _lake_ok(ref: dict, tol: float, cell_area, dt_sec: float):
    """ok_of (see _failed) of the lakes' rule: rtol = atol = tol, the
    lakes' leaves held as above."""
    bounds = {}
    if "out/OUT_LAKE_VOLUME" in ref:
        vol = np.asarray(ref["out/OUT_LAKE_VOLUME"], np.float64)
        area = np.maximum(np.asarray(ref["out/OUT_LAKE_SURF_AREA"],
                                     np.float64), 1.0)
        energy = (vol * 1000.0 * 4220.0 * 300.0).astype(np.float32)
        bounds = {
            "out/OUT_LAKE_ENERGY_ERROR":
                LAKE_ENERGY_ULPS * np.spacing(energy) / (area * dt_sec) + tol,
            "out/OUT_LAKE_WATER_ERROR":
                LAKE_WATER_ULPS * np.spacing(vol.astype(np.float32)) / area
                * 1000.0 + tol}
    to_mm = 1000.0 / np.asarray(cell_area, np.float64)

    def ok(key, a, b):
        if key in bounds:
            return np.abs(b - a) <= bounds[key]
        if key == "state/lake_temp":
            good = np.ones(a.shape, bool)
            rows = good.reshape(-1, a.shape[-1])
            for row, layer in mixed_column_excess(b, a, tol):
                rows[row, layer] = False
            return good
        if key.startswith("out/OUT_LAKE_") and key.endswith("_V"):
            return np.isclose(b * to_mm, a * to_mm, rtol=tol, atol=tol)
        return np.isclose(b, a, rtol=tol, atol=tol)
    return ok


def lake_run_failures(ref: dict, got: dict, tol: float, cell_area,
                      dt_sec: float = 86400.0) -> list:
    """Keys of `ref` ({"out/OUT_*": [n_rec, n_cell, ...], "state/<field>":
    ...}, the golden fixtures' layout) whose value in `got` differs beyond
    rtol = atol = tol, the lakes' leaves held as above. cell_area: [n_cell]
    m^2."""
    return _failed(ref, got, _lake_ok(ref, tol, cell_area, dt_sec))


# --------------------------------------------------------------------------
# Comparing a run with FROZEN_SOIL's fusion term in its surface balance on
# daily steps (frozen_exp, frozen_quick) with vic_tpu's (the tests and
# chip_smoke.py)
# --------------------------------------------------------------------------

# Brent stops a lane anywhere inside its final bracket (|c - b| <= 2*tol_i,
# tol_i = 2*FLT_EPSILON*|b| + 1e-4 C), so two programs whose residuals
# differ by ulps accept surface temperatures up to ~4e-4 C apart. The
# fusion term reads the unfrozen-water curve, steep below 0 C, at the mean
# of Ts and T1 and weighs it by d1/dt: ~10-20 W/m^2 per C on the cold cells
# of the two daily configurations, so OUT_FUSION, and OUT_ENERGY_ERROR,
# the residual at the accepted root that carries it, differ by up to
# 3.6e-3 W/m^2 (measured, frozen_exp on CPU) where every other leaf
# agrees within 1e-4. Those two leaves are held within FUSION_ROOT_ATOL,
# the layer ice (the same curve) at rtol FROZEN_ICE_RTOL as on the frozen
# configuration, every other leaf at rtol = atol = tol.
FUSION_ROOT_ATOL = 1e-2    # W/m^2
FUSION_ROOT_LEAVES = ("OUT_FUSION", "OUT_ENERGY_ERROR")
FROZEN_ICE_RTOL = 1e-3


def frozen_run_failures(ref: dict, got: dict, tol: float) -> list:
    """Keys of `ref` (the golden fixtures' layout, see heavy_run_failures)
    whose value in `got` differs beyond rtol = atol = tol, the fusion
    leaves and the layer ice held as above; integer and boolean leaves
    equal everywhere."""
    def ok(key, a, b):
        name = key.split("/", 1)[1]
        atol, rtol = tol, tol
        if name in FUSION_ROOT_LEAVES:
            atol = max(tol, FUSION_ROOT_ATOL)
        elif key == "state/ice":
            rtol = max(tol, FROZEN_ICE_RTOL)
        return np.abs(b - a) <= atol + rtol * np.abs(a)
    return _failed(ref, got, ok)


# --------------------------------------------------------------------------
# Comparing a heavy run (3-hourly steps, frozen soil on finite-difference
# nodes) with vic_tpu's (the tests and chip_smoke.py)
# --------------------------------------------------------------------------

# On a cell whose frozen top soil sits at the thaw edge, the fusion term
# reads the unfrozen-water curve where it is steepest, just below 0 C, and
# at 3-hourly steps weighs it by d1/dt, eight times the daily weight: one
# float32 ulp of a node temperature moves it by up to ~1 W/m^2, and the
# layer ice, the node profile and the fluxes follow over the records. The
# port's own run moves that much when its carried node temperatures or soil
# moisture move by one ulp (ROADMAP.md queue 3), so two programs that round
# differently cannot agree there at a fixed 1e-4. On such thaw-edge cells
# -- OUT_FUSION nonzero and the cell's top node within THAW_BAND of 0 C in
# some record of the reference -- the energy fluxes (W/m^2,
# THAW_FLUX_LEAVES and their band twins) are held within THAW_FLUX_ATOL,
# about twice the largest spread measured (1.56 W/m^2 after one ulp on CPU,
# 2.32 on an H100 against vic_tpu's fixture), and every other float leaf
# within THAW_ATOL + THAW_RTOL*|ref|; every other cell at rtol = atol = tol,
# but OUT_ENERGY_ERROR, the residual at an accepted Brent root, within
# ROOT_RESIDUAL_ATOL as on the frozen configuration's daily steps.
# OUT_WATER_ERROR is held at tol on every cell: the port reproduces
# vic_tpu's own DIST_PRCP closure residual cell for cell.
THAW_BAND = 2.0            # C
THAW_FLUX_ATOL = 5.0       # W/m^2
THAW_ATOL = 1e-2           # C, mm, cm
THAW_RTOL = 1e-3
ROOT_RESIDUAL_ATOL = 1e-3  # W/m^2
THAW_FLUX_LEAVES = (
    "OUT_FUSION", "OUT_ENERGY_ERROR", "OUT_DELTAH", "OUT_GRND_FLUX",
    "OUT_LATENT", "OUT_LATENT_SUB", "OUT_SENSIBLE", "OUT_SNOW_FLUX",
    "OUT_NET_LONG", "OUT_NET_SHORT", "OUT_R_NET", "OUT_ADVECTION",
    "OUT_DELTACC", "OUT_RFRZ_ENERGY", "OUT_MELT_ENERGY")


def thaw_edge_cells(ref: dict) -> np.ndarray:
    """bool [n_cell]: the thaw-edge cells of a reference run (see
    THAW_BAND), from its out/OUT_FUSION and out/OUT_SOIL_TNODE."""
    fusion = np.abs(np.asarray(ref["out/OUT_FUSION"])).max(0) > 0.0
    top = np.abs(np.asarray(ref["out/OUT_SOIL_TNODE"])[..., 0]).min(0)
    return fusion & (top <= THAW_BAND)


def _on_cells(key: str, a, cells):
    """cells (bool [n_cell]) shaped to broadcast over the value `a` of
    `key`: the cell axis of [n_rec, n_cell, ...] outputs and [n_cell, ...]
    state."""
    shape = [1] * a.ndim
    shape[1 if key.startswith("out/") else 0] = cells.size
    return cells.reshape(shape)


def _heavy_ok(ref: dict, tol: float):
    """ok_of (see _failed) of the heavy rule: rtol = atol = tol, the
    thaw-edge cells held as above."""
    edge = thaw_edge_cells(ref)

    def ok(key, a, b):
        on_edge = _on_cells(key, a, edge)
        name = key.split("/", 1)[1].removesuffix("_BAND")
        if name == "OUT_WATER_ERROR":
            edge_atol, edge_rtol = tol, tol
        elif name in THAW_FLUX_LEAVES:
            edge_atol, edge_rtol = THAW_FLUX_ATOL, tol
        else:
            edge_atol, edge_rtol = THAW_ATOL, THAW_RTOL
        atol = max(tol, ROOT_RESIDUAL_ATOL) if name == "OUT_ENERGY_ERROR" \
            else tol
        limit = np.where(on_edge, edge_atol + edge_rtol * np.abs(a),
                         atol + tol * np.abs(a))
        return np.abs(b - a) <= limit
    return ok


def heavy_run_failures(ref: dict, got: dict, tol: float) -> list:
    """Keys of `ref` ({"out/OUT_*": [n_rec, n_cell, ...], "state/<field>":
    [n_cell, ...]}, the golden fixtures' layout) whose value in `got`
    differs beyond rtol = atol = tol, the thaw-edge cells held as above;
    integer and boolean leaves equal everywhere."""
    return _failed(ref, got, _heavy_ok(ref, tol))


# The heavy configuration with LAKES couples the two: the lake's storage,
# held at ulp bounds above, sets the lake fraction whose change moves every
# lane's soil water (the area-change advection), and the thaw-edge soil
# under the wetland lane sets the lake-bed moisture. Three leaves follow
# that neither rule above holds (ROADMAP.md queue 3):
# - the energy fluxes (THAW_FLUX_LEAVES and their band twins) of cells off
#   the thaw edge, within HEAVY_LAKE_FLUX_ATOL: 1.7e-3 W/m^2 measured on a
#   band's flux of -5.5 W/m^2 summed from lane fluxes of up to ~400 W/m^2,
#   tens of ulps of those terms;
# - OUT_LAKE_SURF_TEMP, the top lake layer, within HEAVY_LAKE_SKIN_ATOL
#   while a lake cools to freezing before its first ice: 5.2e-4 C
#   measured, grown over the records from 1.4e-5 C that solve_lake leaves
#   on the same inputs in one step;
# - OUT_SOIL_TNODE_WL on the thaw-edge cells, one lane's nodes where
#   THAW_ATOL holds cell means, within HEAVY_LAKE_WL_NODE_ATOL: 0.016 C
#   measured against vic_tpu, 0.026 C between the port's own runs a
#   float32 ulp of the starting lake volume apart.
# tools/heavy_lake_leaves.py measures each of them.
HEAVY_LAKE_FLUX_ATOL = 1e-2    # W/m^2
HEAVY_LAKE_SKIN_ATOL = 2e-3    # C
HEAVY_LAKE_WL_NODE_ATOL = 5e-2  # C


def heavy_lake_run_failures(ref: dict, got: dict, tol: float, cell_area,
                            dt_sec: float) -> list:
    """Keys of `ref` (as heavy_run_failures) whose value in `got` fails
    the heavy rule (the thaw-edge cells), the lakes' rule (the lakes'
    leaves) and the coupled leaves above somewhere: an element agrees if
    it agrees under any of them, each at its own bound. For the heavy
    configuration with LAKES."""
    heavy_ok = _heavy_ok(ref, tol)
    lake_ok = _lake_ok(ref, tol, cell_area, dt_sec)
    edge = thaw_edge_cells(ref)

    def coupled_ok(key, a, b):
        name = key.split("/", 1)[1].removesuffix("_BAND")
        diff = np.abs(b - a)
        if name in THAW_FLUX_LEAVES:
            return diff <= max(tol, HEAVY_LAKE_FLUX_ATOL) + tol * np.abs(a)
        if name == "OUT_LAKE_SURF_TEMP":
            return diff <= max(tol, HEAVY_LAKE_SKIN_ATOL) + tol * np.abs(a)
        if name == "OUT_SOIL_TNODE_WL":
            return diff <= np.where(_on_cells(key, a, edge),
                                    HEAVY_LAKE_WL_NODE_ATOL, tol) \
                + tol * np.abs(a)
        return np.zeros(a.shape, bool)

    return _failed(ref, got, lambda key, a, b: heavy_ok(key, a, b)
                   | lake_ok(key, a, b) | coupled_ok(key, a, b))


# ---------------------------------------------------------------------------
# A run in the reference's file formats, for the driver
# ---------------------------------------------------------------------------

# veg library rows: conifer (overstory, excluded above the treeline),
# grassland, glacier (GLACIER_ID 99)
_VEGLIB_ROWS = (
    (1, 1, 60.0, 250.0, 3.4, 0.12, 1.476, 8.04, 20.0, 30.0, 0.5, 0.5, 0.2),
    (10, 0, 2.0, 120.0, 2.2, 0.20, 0.0738, 0.402, 2.0, 100.0, 0.0, 0.0, 0.0),
    (99, 0, 2.0, 100.0, 0.0, 0.30, 0.002, 0.01, 2.0, 100.0, 0.0, 0.0, 0.0),
)
# (class, Cv) of each cell's tiles; the rest is bare soil
_TILES = ((1, 0.35), (10, 0.3), (99, 0.2))
DRIVER_OUTVARS = (  # (name, OUT_TYPE); OUT_SURF_TEMP as truncated int16
    ("OUT_PREC", "OUT_TYPE_FLOAT"), ("OUT_EVAP", "OUT_TYPE_FLOAT"),
    ("OUT_RUNOFF", "OUT_TYPE_FLOAT"), ("OUT_BASEFLOW", "OUT_TYPE_FLOAT"),
    ("OUT_SWE", "OUT_TYPE_FLOAT"), ("OUT_SOIL_MOIST", "OUT_TYPE_FLOAT"),
    ("OUT_SURF_TEMP", "OUT_TYPE_SINT"), ("OUT_GLAC_MELT", "OUT_TYPE_FLOAT"),
    ("OUT_SWE_BAND", "OUT_TYPE_FLOAT"), ("OUT_ZWT", "OUT_TYPE_FLOAT"),
    ("OUT_SNOW_MELT", "OUT_TYPE_FLOAT"), ("OUT_WATER_ERROR", "OUT_TYPE_DOUBLE"),
)
# VIC BINARY forcing: (FORCE_TYPE, SIGNED/UNSIGNED, multiplier)
_BINARY_TYPES = (("PREC", "UNSIGNED", 40.0), ("TMAX", "SIGNED", 100.0),
                 ("TMIN", "SIGNED", 100.0), ("WIND", "UNSIGNED", 100.0))


def write_driver_run(root, n_cell: int, start=(1995, 10, 1), n_day: int = 370,
                     accum_start=(1995, 10, 1), july_tavg=None,
                     snow_step: int = 24, output_format: str = "BINARY",
                     fixdir: str = None, seed: int = 0) -> str:
    """Write a run of the main path (FULL_ENERGY, QUICK_FLUX, a glacier
    tile, 2 snow bands, daily records) in the reference's formats under
    `root` and return the global file's path: a glacier-format soil file,
    a veg library and veg parameters with conifer, grass and glacier tiles,
    a snow-band file, daily PREC/TMAX/TMIN/WIND per cell in VIC BINARY (so
    MTCLIM and the disaggregation run), COMPUTE_TREELINE, an OUTFILE
    section (`DRIVER_OUTVARS`), an ASCII state file at the end and the
    glacier mass-balance accumulation from `accum_start`, every year.

    Cells lie on a 1/16-degree grid. july_tavg: None takes the July mean
    from the forcing (the run must hold a July); a (lo, hi) range gives
    each cell a supplied July mean (JULY_TAVG_SUPPLIED, the soil file's
    column). fixdir: the directory the global file names (default `root`,
    e.g. "@FIXDIR@" for a relocatable fixture)."""
    import os

    from .io.soil import GLACIER_COLS, GLACIER_DEFAULTS
    root = str(root)
    fixdir = root if fixdir is None else fixdir
    os.makedirs(os.path.join(root, "forcing"), exist_ok=True)
    if fixdir == root:
        os.makedirs(os.path.join(root, "results"), exist_ok=True)
    rng = np.random.default_rng(seed)
    n_lon = max(1, int(np.sqrt(n_cell / 2)))
    idx = np.arange(n_cell)
    lat = 49.03125 + 0.0625 * (idx // n_lon)
    lon = -120.96875 + 0.0625 * (idx % n_lon)
    elev = rng.uniform(900.0, 2600.0, n_cell)
    glac = " ".join(repr(GLACIER_DEFAULTS[k]) for k in GLACIER_COLS)
    july = (None if july_tavg is None
            else rng.uniform(july_tavg[0], july_tavg[1], n_cell))

    with open(os.path.join(root, "soil.txt"), "w") as f:
        for ci in range(n_cell):
            cols = [1, ci + 1, f"{lat[ci]:.5f}", f"{lon[ci]:.5f}",
                    f"{rng.uniform(0.1, 0.4):.4f}", 0.02, 12.0, 0.8, 2.0,
                    10.0, 10.0, 12.0, 400.0, 300.0, 200.0, -999, -999, -999,
                    20.0, 90.0, 250.0, f"{elev[ci]:.1f}", 0.1, 0.4, 1.2,
                    4.0, 4.0, 20.0, 20.0, 20.0, 0.5, 0.5, 0.5,
                    1400.0, 1400.0, 1450.0, 2685.0, 2685.0, 2685.0, -8,
                    0.42, 0.42, 0.42, 0.25, 0.25, 0.25, 0.01, 0.0005, 800.0,
                    0.02, 0.02, 0.02, 1]
            if july is not None:
                cols.append(f"{july[ci]:.3f}")
            f.write(" ".join(str(c) for c in cols) + " " + glac + "\n")
    with open(os.path.join(root, "veglib.txt"), "w") as f:
        f.write("#class over rarc rmin LAI*12 albedo*12 rough*12 displ*12 "
                "wind_h RGL rad_atten wind_atten trunk_ratio\n")
        for (vc, over, rarc, rmin, lai, alb, rough, displ, wh, rgl, ra, wa,
             tr) in _VEGLIB_ROWS:
            vals = [vc, over, rarc, rmin] + [lai] * 12 + [alb] * 12 \
                + [rough] * 12 + [displ] * 12 + [wh, rgl, ra, wa, tr]
            f.write(" ".join(str(v) for v in vals) + "\n")
    with open(os.path.join(root, "vegparam.txt"), "w") as f:
        for ci in range(n_cell):
            f.write(f"{ci + 1} {len(_TILES)}\n")
            for vc, cv in _TILES:
                f.write(f"{vc} {cv} 0.3 0.6 0.7 0.4\n")
    with open(os.path.join(root, "snowbands.txt"), "w") as f:
        # area-weighted band elevation = the cell's, so no reset
        for ci in range(n_cell):
            f.write(f"{ci + 1} 0.6 0.4 {elev[ci] - 200.0:.1f} "
                    f"{elev[ci] + 300.0:.1f}\n")

    # daily forcing: a seasonal cycle (coldest in late January) offset per
    # cell, wet days with gamma amounts, gusty wind
    day = np.arange(n_day)
    doy = (np.datetime64(f"{start[0]:04d}-{start[1]:02d}-{start[2]:02d}")
           - np.datetime64(f"{start[0]:04d}-01-01")).astype(int) + day
    season = -np.cos(2.0 * np.pi * (doy - 25) / 365.25)
    for ci in range(n_cell):
        tmean = 1.0 + 12.0 * season + rng.uniform(-6.0, 2.0) \
            + rng.normal(0.0, 2.5, n_day)
        rang = rng.uniform(6.0, 14.0, n_day)
        prec = np.where(rng.random(n_day) < 0.35,
                        rng.gamma(1.5, 5.0, n_day), 0.0)
        wind = rng.gamma(2.0, 1.5, n_day) + 0.3
        data = np.stack([prec, tmean + rang / 2, tmean - rang / 2, wind], 1)
        raw = np.empty((n_day, 4), "<u2")
        for k, (_, sign, mult) in enumerate(_BINARY_TYPES):
            v = np.round(data[:, k] * mult)
            raw[:, k] = (v.astype("<i2").view("<u2") if sign == "SIGNED"
                         else np.clip(v, 0, 65535).astype("<u2"))
        raw.tofile(os.path.join(
            root, "forcing", f"data_{lat[ci]:.5f}_{lon[ci]:.5f}"))

    end = np.datetime64(f"{start[0]:04d}-{start[1]:02d}-{start[2]:02d}") \
        + np.timedelta64(n_day - 1, "D")
    ey, em, ed = (int(x) for x in str(end).split("-"))
    outvars = "\n".join(f"OUTVAR {name} %.4f {kind} 1"
                        for name, kind in DRIVER_OUTVARS)
    ftypes = "\n".join(f"FORCE_TYPE {n} {s} {m:g}"
                       for n, s, m in _BINARY_TYPES)
    text = f"""# a run of the main path in the reference's formats
NLAYER 3
NODES 3
TIME_STEP 24
SNOW_STEP {snow_step}
STARTYEAR {start[0]}
STARTMONTH {start[1]:02d}
STARTDAY {start[2]:02d}
STARTHOUR 00
ENDYEAR {ey}
ENDMONTH {em:02d}
ENDDAY {ed:02d}
FULL_ENERGY TRUE
FROZEN_SOIL FALSE
QUICK_FLUX TRUE
COMPUTE_TREELINE TRUE
JULY_TAVG_SUPPLIED {"FALSE" if july is None else "TRUE"}
GRID_DECIMAL 5
RESOLUTION 0.0625
SNOW_BAND 2 {fixdir}/snowbands.txt
GLACIER_ID 99
GLACIER_ACCUM_START_YEAR {accum_start[0]}
GLACIER_ACCUM_START_MONTH {accum_start[1]}
GLACIER_ACCUM_START_DAY {accum_start[2]}
GLACIER_ACCUM_INTERVAL 1
SOIL {fixdir}/soil.txt
VEGLIB {fixdir}/veglib.txt
VEGPARAM {fixdir}/vegparam.txt
ROOT_ZONES 2
FORCING1 {fixdir}/forcing/data_
FORCE_FORMAT BINARY
FORCE_ENDIAN LITTLE
FORCE_DT 24
N_TYPES {len(_BINARY_TYPES)}
{ftypes}
FORCEYEAR {start[0]}
FORCEMONTH {start[1]:02d}
FORCEDAY {start[2]:02d}
RESULT_DIR {fixdir}/results
OUTPUT_FORMAT {output_format}
OUT_STEP 24
STATENAME {fixdir}/results/state
STATE_FORMAT ASCII
N_OUTFILES 1
OUTFILE fluxes {len(DRIVER_OUTVARS)}
{outvars}
"""
    path = os.path.join(root, "global.txt")
    with open(path, "w") as f:
        f.write(text)
    return path


def relocate_run(src, dest) -> str:
    """Copy a run written with fixdir="@FIXDIR@" (its files under `src`) to
    `dest` with a results directory, the global file pointing there, and
    return the global file's path."""
    import os
    import shutil
    shutil.copytree(src, dest, dirs_exist_ok=True)
    os.makedirs(os.path.join(dest, "results"), exist_ok=True)
    path = os.path.join(dest, "global.txt")
    with open(path) as f:
        text = f.read().replace("@FIXDIR@", str(dest))
    with open(path, "w") as f:
        f.write(text)
    return path


def run_arrays(res) -> dict:
    """A driver RunResult of either package as flat arrays: "out/<OUT_*>"
    (aggregated), "state/<field>" (final state), "gmb/<b0|b1|b2>"
    ([n_interval, n_cell])."""
    arrays = {f"out/{k}": np.asarray(v) for k, v in res.outputs.items()}
    final = res.final_state
    arrays.update({f"state/{f}": np.asarray(getattr(final, f))
                   for f in final.__dataclass_fields__})
    for k in ("b0", "b1", "b2"):
        arrays[f"gmb/{k}"] = np.array([getattr(r, k)
                                       for r in res.gmb_results])
    return arrays


def binary_readback_error(path, outputs: dict, ci: int, var_names) -> float:
    """Largest |value in the packed BINARY flux file `path` - the run's
    aggregated value packed the same way| over cell `ci`'s columns: the
    writer's variables are `outputs`' keys (in their order) that
    `var_names` names; an integer type truncates, as the writer does. 0 when
    the file holds the run's outputs."""
    from .output import read_binary_output
    meta, dates, cols = read_binary_output(path)
    want = []
    for name in (k for k in outputs if k in set(var_names)):
        v = np.asarray(outputs[name])[:, ci]
        want += list(v.reshape(v.shape[0], -1).T)
    if len(want) != len(cols) or meta["nrecs"] != len(dates):
        return float("inf")
    err = 0.0
    for col, v in zip(cols, want):
        packed = np.trunc(v) if col.dtype.kind in "iu" else v
        err = max(err, float(np.abs(col.astype(np.float64)
                                    - packed.astype(col.dtype)).max()))
    return err


def water_closure(outputs: dict, tol: float = 1e-2):
    """The water balance as vic_tpu closes it, from a run's daily
    OUT_WATER_ERROR, OUT_SWE and OUT_SNOW_MELT: |error| <= tol (mm) on
    every record, but on records where snow melts, vic_tpu's snow budget
    drops the liquid water of a lane's pack that melts out within the
    record (its complete-melt branch, vic_tpu/physics/snow.py:420-429),
    which the liquid-water capacity bounds; there the bound is tol +
    SNOW_LIQUID_WATER_CAPACITY x the previous record's OUT_SWE (ROADMAP.md
    queue 3). Returns (largest excess over the bound, the number of
    elements on melt records above tol, the largest |error| there, the
    largest |error| elsewhere)."""
    err = np.abs(np.asarray(outputs["OUT_WATER_ERROR"], np.float64))
    swe = np.asarray(outputs["OUT_SWE"], np.float64)
    swe_before = np.concatenate([np.zeros_like(swe[:1]), swe[:-1]])
    melt = np.asarray(outputs["OUT_SNOW_MELT"]) > 0.0
    bound = tol + np.where(melt, c.SNOW_LIQUID_WATER_CAPACITY * swe_before,
                           0.0)
    return (float((err - bound).max()), int((melt & (err > tol)).sum()),
            float(err[melt].max(initial=0.0)),
            float(err[~melt].max(initial=0.0)))


# The energy terms K2 (snowpack_brent), K5 (surface_brent) and K1
# (glacier_brent) hand back (physics.snow.SnowEBTerms,
# physics.surface.SurfEBResult, physics.glacier.GlacierEBTerms and the
# GlacierSolve fields formed from them), against their plain versions' or
# vic_tpu's: each field within TERMS_RTOL*|ref| plus an absolute limit in
# its own unit. Energies (W/m^2, K1's melt_energy and cold content in J/m^2
# too) and temperatures (C) at TERMS_ATOL; the water depths at
# TERMS_WATER_ATOL_M of water, in metres for the vapour fluxes (m a step,
# ~1e-4-1e-3 m on the daily configurations, so an atol of 1e-4 would pass
# a flux 10% off; K1's vapor_flux, its loss too) and in millimetres for the
# evaporation, canopy water and K1's melt (mm a step). The residual at the
# root (K5's error, K2's and K1's rest) is held at TERMS_RESIDUAL_ATOL: ~0
# by construction, it moves by the residual's slope (20-200 W/m^2/C) times
# a few ulps of the root.
TERMS_RTOL = 1e-4
TERMS_ATOL = 1e-4            # W/m^2, C
TERMS_WATER_ATOL_M = 1e-8    # m of water
TERMS_RESIDUAL_ATOL = 1e-3   # W/m^2
TERMS_IN_M = ("vapor_flux", "inc_vapor_flux")
TERMS_IN_MM = ("evap", "layer_evap", "canopy_evap_mm", "throughfall",
               "wdew_new", "evap_dry", "layer_evap_dry",
               "canopy_evap_mm_dry", "throughfall_dry", "wdew_new_dry",
               "melt_mm")


def terms_atol(field: str, residual: str) -> float:
    """The absolute limit of a terms field; `residual` names the field
    that is the residual at the root."""
    if field == residual:
        return TERMS_RESIDUAL_ATOL
    if field in TERMS_IN_M:
        return TERMS_WATER_ATOL_M
    if field in TERMS_IN_MM:
        return TERMS_WATER_ATOL_M * 1e3
    return TERMS_ATOL


# K12 (kernels.lake_ice_melt) against lake_ice_melt_plain: the Brent's
# flags equal and its roots within the final bracket of each other (two
# runs whose residuals differ by ulps may stop anywhere inside it); every
# other field against the plain version run at the kernel's own roots
# (ice_melt_at_roots), NaN at the same elements, within TERMS_RTOL and its
# unit's absolute limit: the snow, ice, water and vapour depths at
# TERMS_WATER_ATOL_M m, qnet and the terms' rest (the residual at the root)
# at TERMS_RESIDUAL_ATOL, the rest at TERMS_ATOL (W/m^2, C; cold content in
# J/m^2).
ICE_MELT_IN_M = ("swq", "surf_water", "pack_water", "melt_m", "ice_melt_m",
                 "lake_ice_m", "vapor_flux")
BRENT_TOL = 1e-4           # C, the solver's tol addend


def ice_melt_at_roots(kwargs, solve):
    """lake_ice_melt_plain(**kwargs) with its Brent's outputs replaced by
    `solve` (a kernel's RootResult): the plain state update at the kernel's
    accepted temperatures."""
    from .physics import lake
    plain_brent = lake.lake_ice_brent_plain
    lake.lake_ice_brent_plain = lambda *a, **k: solve
    try:
        return lake.lake_ice_melt_plain(**kwargs)
    finally:
        lake.lake_ice_brent_plain = plain_brent


def ice_melt_failures(got, plain, at_roots) -> list:
    """What of K12's IceMeltResult `got` breaks the rule above against
    lake_ice_melt_plain's result `plain` (its Brent) and `at_roots`
    (ice_melt_at_roots at got's roots); [] where none."""
    import torch
    bad = []
    g, p = got.solve, plain.solve
    for k in ("converged", "bracketed"):
        n = int((getattr(g, k) != getattr(p, k)).sum())
        if n:
            bad.append(f"solve.{k}: {n} lakes differ")
    both = g.converged & p.converged
    bracket = 2.0 * (2.0 * torch.finfo(torch.float32).eps * g.root.abs()
                     + BRENT_TOL)
    n = int((both & ((g.root - p.root).abs() > bracket)).sum())
    if n:
        bad.append(f"solve.root: {n} lakes beyond the final bracket")
    if not torch.equal(got.surf_temp_fbflag, at_roots.surf_temp_fbflag):
        bad.append("surf_temp_fbflag differs")
    fields = [(f, getattr(got, f), getattr(at_roots, f))
              for f in got._fields if f not in ("terms", "solve",
                                                "surf_temp_fbflag")]
    fields += [(f"terms.{f}", getattr(got.terms, f),
                getattr(at_roots.terms, f)) for f in got.terms._fields]
    for name, a, b in fields:
        field = name.split(".")[-1]
        atol = (TERMS_RESIDUAL_ATOL if field in ("rest", "qnet")
                else TERMS_WATER_ATOL_M if field in ICE_MELT_IN_M
                else TERMS_ATOL)
        b = b.expand(a.shape)
        na, nb = torch.isnan(a), torch.isnan(b)
        diff = torch.where(~na & ~nb, (a - b).abs(), 0.0)
        over = int((diff > atol + TERMS_RTOL * b.abs()).sum())
        apart = int((na != nb).sum())
        if over or apart:
            bad.append(f"{name}: {over} outside, {apart} NaN apart, max "
                       f"|diff| {float(diff.max()):.3e}")
    return bad


def cell_share(obj, start: int, stop: int, n_cell: int, device=None):
    """Cells [start, stop) of a kernel's arguments: every tensor whose
    leading axis has the n_cell cells, through tuples, NamedTuples (a
    NodeSolve), dicts and dataclasses (a NodeGeometry), every tensor moved
    to `device` if given; other leaves as they are."""
    import dataclasses

    import torch

    def share(x):
        return cell_share(x, start, stop, n_cell, device)
    if isinstance(obj, torch.Tensor):
        x = obj[start:stop] if obj.dim() and obj.shape[0] == n_cell else obj
        return x if device is None else x.to(device)
    if isinstance(obj, tuple):
        items = [share(v) for v in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)
    if isinstance(obj, dict):
        return {k: share(v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: share(getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    return obj


def with_votes(name, kwargs, votes):
    """K6's (`node_sweep`) or K7's (`fd_surface_brent`) keyword arguments
    with share `votes` (a parallel.votes.Member)."""
    if name == "node_sweep":
        return dict(kwargs, votes=votes)
    eb = kwargs["eb_kwargs"]
    return dict(kwargs, eb_kwargs=dict(
        eb, fd_solve=eb["fd_solve"]._replace(votes=votes)))


def split_kernel_call(name, args, kwargs, devices, timeout_s=None,
                      before=None):
    """K6 (`node_sweep`) or K7 (`fd_surface_brent`) on arguments of n_cell
    cells cut into len(devices) equal shares of a parallel.votes.ShareGroup,
    share i on devices[i] (a device named twice runs two shares side by
    side), its arguments moved there, each launched from a host thread of
    its own on a CUDA stream of its own, as the driver runs a split block;
    before(i), if given, runs in share i's thread, on its stream, just
    before its launch. Returns the shares' results."""
    import functools

    import torch

    from . import kernels
    from .parallel.votes import VOTE_TIMEOUT_S, ShareGroup
    n_cell = args[0].shape[0]
    k = n_cell // len(devices)
    if k * len(devices) != n_cell:
        raise ValueError(f"{n_cell} cells do not split over {devices}")
    group = ShareGroup(len(devices), devices,
                       timeout_s=timeout_s or VOTE_TIMEOUT_S)
    streams = [torch.cuda.Stream(d) for d in devices]
    results = [None] * len(devices)
    shares = [cell_share((args, kwargs), i * k, (i + 1) * k, n_cell, d)
              for i, d in enumerate(devices)]

    def job(i):
        a, kw = shares[i]
        kw = with_votes(name, kw, group.member(i))
        with torch.cuda.device(devices[i]), torch.cuda.stream(streams[i]):
            if before is not None:
                before(i)
            results[i] = getattr(kernels, name)(*a, **kw)

    for d in dict.fromkeys(devices):
        torch.cuda.synchronize(d)
    try:
        group.run([functools.partial(job, i)
                   for i in range(len(devices))])
    finally:
        for d in dict.fromkeys(devices):
            torch.cuda.synchronize(d)
        group.close()
    return results
