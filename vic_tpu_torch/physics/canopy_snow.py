"""Canopy snow interception and the foliage energy balance.

Counterpart of `vic_tpu/physics/canopy_snow.py` (snow_intercept.c:81-500,
func_canopy_energy_bal.c:9-150). The foliage temperature is a Brent root of
`canopy_energy_terms`: on the CPU through `canopy_brent_plain`, on a CUDA
device through the `canopy_brent` kernel (`csrc/vic_kernels.cu`).

`vic_tpu`'s `mass_release` has no counterpart: no code calls it, the
single-pass release inside `snow_intercept` is what runs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants as c
from .. import kernels
from ..ops.rootfind import batched_brent
from .evap import svp, wet_canopy_evap


class CanopySnowResult(NamedTuple):
    int_snow: torch.Tensor          # m
    int_rain: torch.Tensor          # m
    snow_throughfall: torch.Tensor  # m
    rain_throughfall: torch.Tensor  # m
    tfoliage: torch.Tensor
    vapor_flux: torch.Tensor        # m/step, loss positive
    temp_int_storage: torch.Tensor
    fbflag: torch.Tensor
    latent: torch.Tensor
    latent_sub: torch.Tensor
    sensible: torch.Tensor
    net_long_over: torch.Tensor
    net_short_over: torch.Tensor
    canopy_evap_mm: torch.Tensor


def canopy_energy_terms(tfoliage, *, dt, lai_ra_over, air_dens, vp_air,
                        pressure, le, tcanopy, vpd, rainfall_m,
                        net_short_over, long_over_in, long_under_out,
                        int_rain, has_csnow, ra_plain, wdew_mm, prec_mm,
                        wdmax_mm, rarc, elevation):
    """CanopyEnergyBal terms at candidate Tfoliage
    (func_canopy_energy_bal.c:30-150) under AR_406_FULL.

    has_csnow lanes (snow in or falling on the canopy) take the
    intercepted-snow branch at lai_ra_over = 10 x the overstory resistance;
    the others take the snow-free branch, whose latent term is the wet-canopy
    evaporation canopy_evap(CALC_EVAP=FALSE) of the pre-interception dew
    wdew_mm and rain prec_mm at the candidate's net radiation, air
    temperature tcanopy and resistance ra_plain (entered with the
    reference's positive sign, :110). The CUDA residual `CanopyResidual` in
    csrc/vic_kernels.cu is a line-for-line copy."""
    tkelv = tfoliage + c.KELVIN
    tk2 = tkelv * tkelv
    long_over_out = c.STEFAN_B * (tk2 * tk2)
    net_rad = (net_short_over + long_over_in + long_under_out
               - 2.0 * long_over_out)
    net_long_over = long_over_in - long_over_out

    ra_snow = lai_ra_over
    es = svp(tfoliage)
    vmf = air_dens * (c.EPS_RATIO / pressure) * (vp_air - es) / ra_snow \
        / c.RHO_W
    vmf = torch.where((vpd == 0.0) & (vmf < 0.0), 0.0, vmf)
    ls = (677.0 - 0.07 * tfoliage) * c.JOULES_PER_CAL * c.GRAMS_PER_KG
    latent_sub_snow = ls * vmf * c.RHO_W

    cevap_mm, _, thru_mm, wdew_new_mm = wet_canopy_evap(
        wdew_mm, prec_mm, wdmax_mm, rarc, net_rad, vpd, tcanopy, elevation,
        ra_plain, dt)
    latent_liq = le * (cevap_mm / 1000.0 / dt) * c.RHO_W
    latent = torch.where(has_csnow, 0.0, latent_liq)
    latent_sub = torch.where(has_csnow, latent_sub_snow, 0.0)
    vapor_flux = torch.where(has_csnow, vmf * dt, 0.0)
    ra_over = torch.where(has_csnow, ra_snow, ra_plain)
    cevap_mm = torch.where(has_csnow, 0.0, cevap_mm)

    sensible = air_dens * c.CP * (tcanopy - tfoliage) / ra_over
    advected = 4186.8 * tcanopy * rainfall_m / dt
    refreeze = int_rain * c.LF * c.RHO_W / dt

    rest = sensible + latent + latent_sub + net_rad + advected
    melt_branch = (tfoliage == 0.0) & (rest > -refreeze) & has_csnow
    rest_plus = torch.where(has_csnow, rest + refreeze, rest)
    return dict(rest=torch.where(melt_branch, 0.0, rest_plus),
                refreeze=torch.where(melt_branch, -rest, refreeze),
                vapor_flux=vapor_flux, latent=latent, latent_sub=latent_sub,
                sensible=sensible, net_long_over=net_long_over,
                advected=advected, canopy_evap_mm=cevap_mm,
                liq_throughfall_mm=thru_mm, liq_wdew_mm=wdew_new_mm)


def canopy_brent_plain(lo, hi, active, *, dt, max_iter, max_tries, **inputs):
    """Plain version of the `canopy_brent` kernel: expand-then-Brent on
    `canopy_energy_terms(t)["rest"]` (canopy_snow.py:270 of the JAX
    package)."""
    return batched_brent(
        lambda t: canopy_energy_terms(t, dt=dt, **inputs)["rest"], lo, hi,
        max_iter=max_iter, max_tries=max_tries, active=active)


def snow_intercept(*, snowfall_mm, rainfall_mm, int_snow_m, int_rain_m,
                   tfoliage_old, temp_int_storage, lai, wdmax_mm, air_dens,
                   vp_air, vpd, pressure, le, tcanopy, net_short_over,
                   net_short_over_nosnow, long_over_in, long_under_out,
                   ra_overstory, wind_over, liquid_evap, dt_sec,
                   max_iter: int = 30, active_mask=None) -> CanopySnowResult:
    """Snow interception + foliage energy balance on overstory lanes
    (snow_intercept.c:81-500); *_mm inputs in mm/step, storages in m.

    liquid_evap: dict(wdew_mm, prec_mm, rarc, elevation) -- the
    pre-interception dew and rainfall, and the veg/site terms, of the
    snow-free-canopy branch's canopy_evap(CALC_EVAP=FALSE)."""
    W = torch.where
    snowfall = snowfall_mm / 1000.0
    rainfall = rainfall_mm / 1000.0
    max_int = wdmax_mm / 1000.0
    int_snow = int_snow_m
    int_rain = int_rain_m

    # interception capacity (Kobayashi 1986; snow_intercept.c:105-130)
    imax1 = 4.0 * c.LAI_SNOW_MULTIPLIER * lai
    max_snow_int_f = W(tfoliage_old > -1.0, 4.0,
                       W(tfoliage_old > -3.0, tfoliage_old * 1.5 + 5.5, 1.0))
    max_snow_int = torch.clamp(max_snow_int_f * c.LAI_SNOW_MULTIPLIER * lai,
                               min=1e-10)
    delta = (1.0 - int_snow / max_snow_int) * snowfall
    delta = torch.minimum(torch.clamp(delta, min=0.0),
                          torch.clamp(max_snow_int - int_snow, min=0.0))
    blown = W((tfoliage_old < -3.0) & (delta > 0.0) & (wind_over > 1.0),
              torch.minimum((0.2 * wind_over - 0.2) * delta, delta), 0.0)
    delta = delta - blown
    delta = W(int_snow + delta > imax1, 0.0, delta)

    # full canopy cover (F = 1, snow_intercept.c:81)
    snow_thru = snowfall - delta
    dump = (snowfall == 0.0) & (int_snow < c.MIN_SWQ_EB_THRES)
    snow_thru = snow_thru + W(dump, int_snow, 0.0)
    int_snow = W(dump, 0.0, int_snow + delta)

    # rain interception (snow_intercept.c:157-176)
    max_water = c.SNOW_LIQUID_WATER_CAPACITY * int_snow + max_int
    fits = (int_rain + rainfall) <= max_water
    rain_thru = W(fits, 0.0, int_rain + rainfall - max_water)
    int_rain = W(fits, int_rain + rainfall, max_water)
    dump_r = (rainfall == 0.0) & (int_rain < c.MIN_SWQ_EB_THRES)
    rain_thru = rain_thru + W(dump_r, int_rain, 0.0)
    int_rain = W(dump_r, 0.0, int_rain)

    # structural overload (snow_intercept.c:186-196)
    total = int_rain + int_snow
    over = torch.clamp(total - imax1, min=0.0)
    frac_rain = W(total > 0.0, int_rain / torch.clamp(total, min=1e-12), 0.0)
    rain_thru = rain_thru + over * frac_rain
    snow_thru = snow_thru + over * (1.0 - frac_rain)
    int_rain = int_rain - over * frac_rain
    int_snow = int_snow - over * (1.0 - frac_rain)

    # foliage energy balance (two-pass 0 C + Brent), branch by canopy snow
    has_csnow = (int_snow > 0.0) | (snowfall > 0.0)
    ns_over = W(has_csnow, net_short_over, net_short_over_nosnow)
    term_kwargs = dict(
        dt=dt_sec, lai_ra_over=ra_overstory * 10.0, air_dens=air_dens,
        vp_air=vp_air, pressure=pressure, le=le, tcanopy=tcanopy, vpd=vpd,
        rainfall_m=rainfall, net_short_over=ns_over,
        long_over_in=long_over_in, long_under_out=long_under_out,
        int_rain=int_rain, has_csnow=has_csnow, ra_plain=ra_overstory,
        wdmax_mm=wdmax_mm, **liquid_evap)

    t0 = canopy_energy_terms(torch.zeros_like(tfoliage_old), **term_kwargs)
    melt_cond = (t0["rest"] == 0.0) & has_csnow
    brent_active = ~melt_cond if active_mask is None \
        else ~melt_cond & active_mask
    # snow branch: [Tfol-SNOW_DT (or -SNOW_DT), 0]; snow-free branch:
    # symmetric (snow_intercept.c:344-360)
    t_lower = W(has_csnow,
                W(tfoliage_old <= 0.0, tfoliage_old - c.SNOW_DT,
                  torch.full_like(tfoliage_old, -c.SNOW_DT)),
                tfoliage_old - c.SNOW_DT)
    t_upper = W(has_csnow, 0.0, tfoliage_old + c.SNOW_DT)
    solve = (canopy_brent_plain if tfoliage_old.device.type == "cpu"
             else kernels.canopy_brent)
    res = solve(t_lower, t_upper, brent_active, max_iter=max_iter,
                max_tries=5, **term_kwargs)
    t_cold = W(res.converged, res.root, tfoliage_old)
    fbflag = ~melt_cond & ~res.converged
    tfoliage = W(melt_cond, 0.0, t_cold)
    terms = canopy_energy_terms(tfoliage, **term_kwargs)

    refreeze_j = terms["refreeze"] * dt_sec
    vflux = terms["vapor_flux"]
    vflux = W(-vflux > int_snow, -int_snow, vflux)
    int_snow = torch.clamp(int_snow + vflux, min=0.0)

    # melt / drip / structural release / refreeze (snow_intercept.c:300-420)
    melting = tfoliage == 0.0
    melt_eff = W(melting & (refreeze_j < 0.0),
                 torch.minimum(-refreeze_j / (c.LF * c.RHO_W), int_snow), 0.0)
    int_snow = int_snow - melt_eff
    int_rain = int_rain + melt_eff
    max_water = c.SNOW_LIQUID_WATER_CAPACITY * int_snow + max_int
    drip = torch.clamp(int_rain - max_water, min=0.0)
    int_rain = int_rain - drip
    ripe = ((int_snow > c.MIN_INTERCEPTION_STORAGE)
            & (drip + melt_eff >= 0.10 * int_snow))
    released = W(ripe,
                 torch.minimum(torch.clamp(int_snow
                                           - c.MIN_INTERCEPTION_STORAGE,
                                           min=0.0),
                               0.17 * int_snow), 0.0)
    int_snow = int_snow - released
    frozen = W(~melting,
               torch.minimum(torch.clamp(-refreeze_j, min=0.0)
                             / (c.LF * c.RHO_W), int_rain), 0.0)
    int_rain = int_rain - frozen
    int_snow = int_snow + frozen

    # snow-free-canopy lanes: canopy_evap's liquid bookkeeping replaces the
    # interception result (snow_intercept.c:424-425)
    nb = ~has_csnow
    rain_thru_total = W(nb, terms["liq_throughfall_mm"] / 1000.0,
                        rain_thru + drip)
    int_rain = W(nb, terms["liq_wdew_mm"] / 1000.0, int_rain)
    int_snow = W(nb, 0.0, int_snow)
    tstore = W(nb, 0.0, W(melting, temp_int_storage + melt_eff, 0.0))
    cevap_mm = W(nb, terms["canopy_evap_mm"], 0.0)
    vflux = W(has_csnow, vflux, 0.0)

    return CanopySnowResult(
        int_snow=int_snow, int_rain=int_rain,
        snow_throughfall=snow_thru + released,
        rain_throughfall=rain_thru_total, tfoliage=tfoliage,
        vapor_flux=-vflux, temp_int_storage=tstore, fbflag=fbflag,
        latent=terms["latent"], latent_sub=terms["latent_sub"],
        sensible=terms["sensible"], net_long_over=terms["net_long_over"],
        net_short_over=ns_over, canopy_evap_mm=cevap_mm)
