"""Soil-surface energy balance residual and its Brent solve.

Counterpart of `vic_tpu/physics/surface.py` (func_surf_energy_bal.c,
calc_surf_energy_bal.c:7-520): ground heat from estimate_T1 (QUICK_FLUX) or
from the finite-difference node profile solved at each candidate
temperature (QUICK_FLUX off), the deltaH storage and frozen-soil fusion
terms, evapotranspiration inside the residual, a stability-corrected
resistance and the per-lane INCLUDE_SNOW fold of thin packs.

The Brent solve of a CUDA tensor: on the QUICK_FLUX path the
`surface_brent` kernel (one thread per lane, `csrc/surface_brent.cu`); on
the finite-difference path, whose residual runs the batch-wide node sweep,
the `fd_surface_brent` kernel sequence (`csrc/fd_surface_brent.cu`). On the
CPU the plain batch loop `surface_brent_plain`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants as c
from .. import kernels
from ..ops.rootfind import batched_brent
from .evap import arno_evap, canopy_evap
from .snow import latent_heat_from_snow, stability_correction
from .soil_thermal import estimate_t1, maximum_unfrozen_water


class SurfEBResult(NamedTuple):
    error: torch.Tensor
    t1: torch.Tensor
    grnd_flux: torch.Tensor
    delta_h: torch.Tensor
    fusion: torch.Tensor
    latent_heat: torch.Tensor
    latent_heat_sub: torch.Tensor
    sensible_heat: torch.Tensor
    snow_flux: torch.Tensor
    net_long_bare: torch.Tensor
    net_short_bare: torch.Tensor
    evap: torch.Tensor            # mm/step
    layer_evap: torch.Tensor      # [..., nl] mm/step
    canopy_evap_mm: torch.Tensor
    throughfall: torch.Tensor
    wdew_new: torch.Tensor
    refreeze_energy: torch.Tensor
    delta_cc: torch.Tensor
    inc_vapor_flux: torch.Tensor
    # finite-difference path: the node profile solved at this Ts
    # (func_surf_energy_bal.c:190-228) and its per-node TFALLBACK counts
    t_nodes: torch.Tensor = None
    node_fbcount: torch.Tensor = None


def surf_energy_terms(
        ts, *, ts_old, t1_old, t2, d1, d2, kappa1, kappa2, cs1, cs2, dp,
        delta_t, tair, vpd, vp_air, shortwave_net_bare, long_bare_in,
        atmos_density, atmos_pressure, elevation, latent_heat_le, ra_under,
        z_ref, displacement, roughness, wind, overstory_snowing, is_veg, lai,
        wdew, wdmax, rmin, rgl, rarc, root, ra_canopy, rainfall, moist_l,
        ice_l, wcr, wpwp, depth_l, resid_moist0, b_infilt, max_moist_l,
        snow_coverage, surf_atten, kappa_snow, tsnow_surf, melt_energy,
        evap_pre, inc_mask, inc_terms, grnd_flux_type: int = 1,
        frozen_soil: bool = False, moist0_vol=None, max_moist0_vol=None,
        ice0_vol=None, bubble0=None, expt0=None, fs_active=None,
        fd_solve=None) -> SurfEBResult:
    """Every term of the surface energy balance at candidate Ts
    (func_surf_energy_bal.c:calculate). inc_mask lanes fold a thin pack
    into this balance; inc_terms keys: swq, surf_water, density, old_tsurf,
    advection0, lw_snow_in, net_short_snow_cov, cov and, optionally,
    blowing_flux (the BLOWING option's mass flux, kg/m2/s).

    Finite-difference path: fd_solve(Ts) solves the node profile with Ts as
    the node-0 boundary condition; ground heat then comes from nodes 1 and
    2. frozen_soil adds
    the fusion term of the top node pair, from moist0_vol, max_moist0_vol,
    ice0_vol, bubble0, expt0 and fs_active."""
    W = torch.where
    tmean = ts
    tkelv = tmean + c.KELVIN
    tk2 = tkelv * tkelv
    tk4 = tk2 * tk2

    # pack -> soil conduction; none on INCLUDE_SNOW lanes (:148-161)
    snow_flux = W(inc_mask, 0.0, kappa_snow * (tsnow_surf - tmean))

    cover_atten = snow_coverage + (1.0 - snow_coverage) * surf_atten
    t_nodes = node_fbcount = None
    if fd_solve is not None:
        # node profile at this Ts; no exp(-D1/dp) damping (:185-240)
        prof = fd_solve(tmean)
        t_nodes, node_fbcount = prof.temp, prof.fbcount
        t1 = t_nodes[..., 1]
        lower_flux = kappa2 / d2 * (t_nodes[..., 2] - t1)
    else:
        # quick-flux ground heat (func_surf_energy_bal.c:171-181)
        t1 = estimate_t1(tmean, t1_old, t2, d1, d2, kappa1, kappa2, cs1, cs2,
                         dp, delta_t)
        lower_flux = kappa2 / d2 * (1.0 - torch.exp(-d1 / dp)) * (t2 - t1)
    if grnd_flux_type == 0:  # GF_406
        grnd_flux = cover_atten * (kappa1 / d1 * (t1 - tmean))
    else:  # GF_410 / GF_FULL
        grnd_flux = cover_atten * (kappa1 / d1 * (t1 - tmean)
                                   + lower_flux) / 2.0

    # heat storage between nodes 0 and 1 (:249-254)
    delta_h = cs1 * ((ts_old + t1_old) - (tmean + t1)) * d1 / delta_t / 2.0
    if grnd_flux_type == 2:
        delta_h = cover_atten * delta_h
    if frozen_soil:
        # fusion of the top node pair's ice (:260-275)
        tavg01 = (tmean + t1) / 2.0
        unfrozen = maximum_unfrozen_water(tavg01, max_moist0_vol, bubble0,
                                          expt0)
        ice_new = W(tavg01 < 0.0, torch.clamp(moist0_vol - unfrozen, min=0.0),
                    0.0)
        fusion = -c.ICE_DENSITY * c.LF * (ice0_vol - ice_new) * d1 / delta_t
        if grnd_flux_type == 2:
            fusion = cover_atten * fusion
        fusion = W(fs_active, fusion, 0.0)
    else:
        fusion = torch.zeros_like(tmean)

    # INCLUDE_SNOW pack cold content / refreeze (:279-286), Lf * snow
    # DENSITY as the reference writes it (:284)
    i_sw = inc_terms["surf_water"]
    i_dry = inc_terms["swq"] - i_sw
    cov_i = inc_terms["cov"]
    dcc_i = W(tmean > 0.0,
              c.CH_ICE * i_dry * (0.0 - inc_terms["old_tsurf"]) / delta_t,
              c.CH_ICE * i_dry * (tmean - inc_terms["old_tsurf"]) / delta_t)
    rfz_i = (i_sw * c.LF * inc_terms["density"]) / delta_t
    delta_cc = W(inc_mask, dcc_i * cov_i, 0.0)
    refreeze_energy = W(inc_mask, rfz_i * cov_i, 0.0)

    # net radiation on the snow-free area (:291-295)
    net_long_bare = long_bare_in - (1.0 - snow_coverage) * (c.STEFAN_B * tk4)
    net_bare_rad = (shortwave_net_bare + net_long_bare + grnd_flux + delta_h
                    + fusion)

    # stability-corrected resistance (:298-310)
    d_eff = W(overstory_snowing, 0.0, displacement)
    ra_used = W(wind > 0.0,
                ra_under / stability_correction(z_ref, d_eff, tmean, tair,
                                                wind, roughness),
                c.HUGE_RESIST)

    # evapotranspiration inside the residual (:320-336)
    evap_veg, layer_evap_veg, cevap_veg, thrufall_veg, wdew_veg = \
        canopy_evap(moist_l, ice_l, wcr, wpwp, root, wdew, rainfall, wdmax,
                    rmin, rgl, lai, rarc, net_bare_rad, shortwave_net_bare,
                    vpd, tair, elevation, ra_canopy, delta_t, pre=evap_pre)
    evap_bare = arno_evap(moist_l[..., 0], ice_l[..., 0], max_moist_l[..., 0],
                          depth_l[..., 0], resid_moist0, b_infilt,
                          net_bare_rad, tair, vpd, elevation, ra_used,
                          delta_t, beta=evap_pre["arno_beta"],
                          coeffs=evap_pre["coeffs"])
    veg = is_veg & (lai > 0.0)
    evap = W(veg, evap_veg, evap_bare)
    layer_evap = W(veg[..., None], layer_evap_veg,
                   torch.cat([evap_bare[..., None],
                              torch.zeros_like(layer_evap_veg[..., 1:])], -1))
    canopy_evap_mm = W(veg, cevap_veg, 0.0)
    throughfall = W(veg, thrufall_veg, rainfall)
    wdew_new = W(veg, wdew_veg, wdew)

    # latent heat (:339-363); evap mm/step -> m/s
    latent_heat = (-c.RHO_W * latent_heat_le * (evap / 1000.0 / delta_t)
                   * (1.0 - snow_coverage))
    lat_i, lat_sub_i, vmf_i = latent_heat_from_snow(
        atmos_density, vp_air, latent_heat_le, atmos_pressure, ra_used,
        tmean, vpd, inc_terms.get("blowing_flux", 0.0))
    latent_heat = W(inc_mask, lat_i * cov_i, latent_heat)
    latent_heat_sub = W(inc_mask, lat_sub_i * cov_i, 0.0)
    # m water-equivalent/step via the reference's ice-density roundtrip
    inc_vapor_flux = W(inc_mask, vmf_i * delta_t / c.ICE_DENSITY, 0.0)

    # sensible heat (:366-372); unscaled on INCLUDE_SNOW lanes
    sensible_raw = atmos_density * c.CP * (tair - tmean) / ra_used
    sensible = W(snow_coverage >= 1.0, 0.0,
                 sensible_raw * (1.0 - snow_coverage))
    sensible = W(inc_mask, sensible_raw, sensible)

    error = (net_bare_rad + sensible + latent_heat + latent_heat_sub
             + snow_flux * snow_coverage - delta_cc) + melt_energy
    # pack terms of the joint balance (:378-387) and the refreeze two-pass
    # at TMean == 0 (:388-397)
    nls_i = inc_terms["lw_snow_in"] - cov_i * c.STEFAN_B * tk4
    inc_extra = (inc_terms["advection0"] + inc_terms["net_short_snow_cov"]
                 + nls_i - melt_energy)
    error = error + W(inc_mask, inc_extra, 0.0)
    melt_i = inc_mask & (tmean == 0.0) & (error > -refreeze_energy)
    refreeze_energy = W(melt_i, -error, refreeze_energy)
    error = W(melt_i, 0.0, W(inc_mask, error + refreeze_energy, error))

    return SurfEBResult(
        error=error, t1=t1, grnd_flux=grnd_flux, delta_h=delta_h,
        fusion=fusion, latent_heat=latent_heat,
        latent_heat_sub=latent_heat_sub, sensible_heat=sensible,
        snow_flux=snow_flux, net_long_bare=net_long_bare,
        net_short_bare=shortwave_net_bare, evap=evap, layer_evap=layer_evap,
        canopy_evap_mm=canopy_evap_mm, throughfall=throughfall,
        wdew_new=wdew_new, refreeze_energy=refreeze_energy, delta_cc=delta_cc,
        inc_vapor_flux=inc_vapor_flux, t_nodes=t_nodes,
        node_fbcount=node_fbcount)


def surface_brent_plain(lo, hi, active, *, max_iter: int, eb_kwargs):
    """Plain version of the `surface_brent` kernel: the batch-wide Brent
    (ops/rootfind.py) on surf_energy_terms(t, **eb_kwargs).error."""
    return batched_brent(lambda t: surf_energy_terms(t, **eb_kwargs).error,
                         lo, hi, max_iter=max_iter, active=active)


def solve_surface_temperature(kwargs, t0_old, tair, max_iter: int = 30,
                              active=None):
    """Full-energy surface temperature: Brent on mid +/- SURF_DT with
    mid = 0.5*(T0_old + Tair), or [T0_old - SURF_DT, 0] on INCLUDE_SNOW
    lanes (calc_surf_energy_bal.c:277-346); TFALLBACK to T0_old.
    CUDA tensors take the `surface_brent` kernel on the QUICK_FLUX
    residual and `fd_surface_brent` on the finite-difference one; the CPU
    takes `surface_brent_plain`. Returns (Ts, fbflag)."""
    mid = 0.5 * (t0_old + tair)
    inc = kwargs["inc_mask"]
    t_lower = torch.where(inc, t0_old - c.SURF_DT, mid - c.SURF_DT)
    t_upper = torch.where(inc, 0.0, mid + c.SURF_DT)
    if active is None:
        active = torch.ones_like(inc)
    if t0_old.device.type == "cpu":
        solve = surface_brent_plain
    elif kwargs.get("fd_solve") is None:
        solve = kernels.surface_brent
    else:
        solve = kernels.fd_surface_brent
    res = solve(t_lower, t_upper, active, max_iter=max_iter,
                eb_kwargs=kwargs)
    ts = torch.where(res.converged, res.root, t0_old)  # TFALLBACK
    return ts, ~res.converged
