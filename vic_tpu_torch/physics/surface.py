"""Soil-surface energy balance residual and its Brent solve.

Counterpart of `vic_tpu/physics/surface.py` (func_surf_energy_bal.c,
calc_surf_energy_bal.c:7-520): ground heat from estimate_T1 (QUICK_FLUX) or
from the finite-difference node profile solved at each candidate
temperature (QUICK_FLUX off), the deltaH storage and frozen-soil fusion
terms, evapotranspiration inside the residual, a stability-corrected
resistance and the per-lane INCLUDE_SNOW fold of thin packs.

With DIST_PRCP the ET inside the residual is evaluated on the wet and the
dry column and the latent term sees their mu-weighted sum
(canopy_evap.c:124-206).

The Brent solve of a CUDA tensor: on the QUICK_FLUX path the
`surface_brent` kernel (`csrc/surface_brent.cu` on `csrc/lane_brent.cuh`),
which also writes the balance's terms at the accepted temperature; on the
finite-difference path, whose residual runs the batch-wide node sweep, the
`fd_surface_brent` kernel (`csrc/fd_surface_brent.cu`, one cooperative
launch); on the affine two-probe form of that residual (fd_affine) the
`affine_surface_brent` kernel (`csrc/affine_surface_brent.cu` on
`csrc/lane_brent.cuh`). On the CPU the plain batch loop: on the QUICK_FLUX
path `surface_brent_plain` (the terms at the root too), elsewhere
`surface_root_plain`.
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
    # DIST_PRCP: the dry column's ET (canopy_evap.c:124-146); evap above is
    # then the mu-weighted total
    layer_evap_dry: torch.Tensor = None
    canopy_evap_mm_dry: torch.Tensor = None
    throughfall_dry: torch.Tensor = None
    wdew_new_dry: torch.Tensor = None
    evap_dry: torch.Tensor = None


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
        fd_solve=None, fd_interp=None, dist_dry=None, evap_pre_dry=None,
        mu_wet=None) -> SurfEBResult:
    """Every term of the surface energy balance at candidate Ts
    (func_surf_energy_bal.c:calculate). inc_mask lanes fold a thin pack
    into this balance; inc_terms keys: swq, surf_water, density, old_tsurf,
    advection0, lw_snow_in, net_short_snow_cov, cov and, optionally,
    blowing_flux (the BLOWING option's mass flux, kg/m2/s).

    Finite-difference path: fd_solve(Ts) solves the node profile with Ts as
    the node-0 boundary condition, or fd_interp = (ts_a, t_a, ts_b, t_b)
    interpolates it affinely between two profiles solved at ts_a and ts_b
    (surface.py:155-158 of vic_tpu); ground heat then comes from nodes 1
    and 2. frozen_soil adds the fusion term of the top node pair, from
    moist0_vol, max_moist0_vol, ice0_vol, bubble0, expt0 and fs_active.

    DIST_PRCP: dist_dry (the dry column's moist_l, ice_l, wdew, rainfall),
    evap_pre_dry (its build_evap_pre terms) and mu_wet, the wet fraction;
    the latent term then sees mu*evap_wet + (1-mu)*evap_dry."""
    W = torch.where
    tmean = ts
    tkelv = tmean + c.KELVIN
    tk2 = tkelv * tkelv
    tk4 = tk2 * tk2

    # pack -> soil conduction; none on INCLUDE_SNOW lanes (:148-161)
    snow_flux = W(inc_mask, 0.0, kappa_snow * (tsnow_surf - tmean))

    cover_atten = snow_coverage + (1.0 - snow_coverage) * surf_atten
    t_nodes = node_fbcount = None
    if fd_interp is not None:
        # the profile interpolated between the two probes
        ts_a, t_a, ts_b, t_b = fd_interp
        wq = ((tmean - ts_a) / (ts_b - ts_a))[..., None]
        t_nodes = t_a + wq * (t_b - t_a)
    elif fd_solve is not None:
        # node profile at this Ts
        prof = fd_solve(tmean)
        t_nodes, node_fbcount = prof.temp, prof.fbcount
    if t_nodes is not None:
        # ground heat from nodes 1-2, no exp(-D1/dp) damping (:185-240)
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

    # evapotranspiration inside the residual (:320-336), of one column
    veg = is_veg & (lai > 0.0)

    def column_evap(moist_c, ice_c, wdew_c, rainfall_c, pre):
        evap_veg, layer_evap_veg, cevap_veg, thrufall_veg, wdew_veg = \
            canopy_evap(moist_c, ice_c, wcr, wpwp, root, wdew_c, rainfall_c,
                        wdmax, rmin, rgl, lai, rarc, net_bare_rad,
                        shortwave_net_bare, vpd, tair, elevation, ra_canopy,
                        delta_t, pre=pre)
        evap_bare = arno_evap(moist_c[..., 0], ice_c[..., 0],
                              max_moist_l[..., 0], depth_l[..., 0],
                              resid_moist0, b_infilt, net_bare_rad, tair, vpd,
                              elevation, ra_used, delta_t,
                              beta=pre["arno_beta"], coeffs=pre["coeffs"])
        layer_bare = torch.cat([evap_bare[..., None], torch.zeros_like(
            layer_evap_veg[..., 1:])], -1)
        return (W(veg, evap_veg, evap_bare),
                W(veg[..., None], layer_evap_veg, layer_bare),
                W(veg, cevap_veg, 0.0), W(veg, thrufall_veg, rainfall_c),
                W(veg, wdew_veg, wdew_c))

    evap, layer_evap, canopy_evap_mm, throughfall, wdew_new = column_evap(
        moist_l, ice_l, wdew, rainfall, evap_pre)
    dry = {}
    if dist_dry is not None:
        evap_d, *rest = column_evap(dist_dry["moist_l"], dist_dry["ice_l"],
                                    dist_dry["wdew"], dist_dry["rainfall"],
                                    evap_pre_dry)
        dry = dict(zip(("layer_evap_dry", "canopy_evap_mm_dry",
                        "throughfall_dry", "wdew_new_dry"), rest),
                   evap_dry=evap_d)
        # the latent term sees the mu-weighted ET (canopy_evap.c:206)
        evap = mu_wet * evap + (1.0 - mu_wet) * evap_d

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
        node_fbcount=node_fbcount, **dry)


class SurfaceSolve(NamedTuple):
    """The QUICK_FLUX surface solve: the Brent's result
    (ops.rootfind.RootResult's fields) and the balance's terms at the
    accepted temperature, the root or, where the lane did not converge,
    TFALLBACK's carried surface temperature eb_kwargs["ts_old"]."""
    root: torch.Tensor
    converged: torch.Tensor
    bracketed: torch.Tensor
    iterations: torch.Tensor
    terms: SurfEBResult


def surface_root_plain(lo, hi, active, *, max_iter: int, eb_kwargs):
    """Plain version of the `fd_surface_brent` and `affine_surface_brent`
    kernels: the batch-wide Brent (ops/rootfind.py) on
    surf_energy_terms(t, **eb_kwargs).error."""
    return batched_brent(lambda t: surf_energy_terms(t, **eb_kwargs).error,
                         lo, hi, max_iter=max_iter, active=active)


def surface_brent_plain(lo, hi, active, *, max_iter: int, eb_kwargs):
    """Plain version of the `surface_brent` kernel: surface_root_plain, then
    surf_energy_terms at the accepted temperature (TFALLBACK to
    eb_kwargs["ts_old"]). A SurfaceSolve."""
    res = surface_root_plain(lo, hi, active, max_iter=max_iter,
                             eb_kwargs=eb_kwargs)
    ts = torch.where(res.converged, res.root, eb_kwargs["ts_old"])
    return SurfaceSolve(*res, terms=surf_energy_terms(ts, **eb_kwargs))


def solve_surface_temperature(kwargs, t0_old, tair, max_iter: int = 30,
                              active=None, fd_affine: bool = False):
    """Full-energy surface temperature: Brent on mid +/- SURF_DT with
    mid = 0.5*(T0_old + Tair), or [T0_old - SURF_DT, 0] on INCLUDE_SNOW
    lanes (calc_surf_energy_bal.c:277-346); TFALLBACK to T0_old.

    fd_affine (finite-difference nodes only): the node profile is solved
    once at each bracket end, both from the carried temperatures, and the
    residual interpolates it affinely between the two (vic_tpu/physics/
    surface.py:421-433); the returned fd_interp lets the caller evaluate
    the accepted root's terms on the same profile.

    CUDA tensors take the `surface_brent` kernel on the QUICK_FLUX
    residual, `fd_surface_brent` on the finite-difference one and
    `affine_surface_brent` on its affine form; the CPU takes
    `surface_brent_plain` on the QUICK_FLUX residual, `surface_root_plain`
    on the others. t0_old is the balance's own carried temperature,
    kwargs["ts_old"]. Returns (Ts, fbflag, fd_interp or None, the terms at
    Ts on the QUICK_FLUX path or None)."""
    mid = 0.5 * (t0_old + tair)
    inc = kwargs["inc_mask"]
    t_lower = torch.where(inc, t0_old - c.SURF_DT, mid - c.SURF_DT)
    t_upper = torch.where(inc, 0.0, mid + c.SURF_DT)
    if active is None:
        active = torch.ones_like(inc)
    fd_interp = None
    if fd_affine and kwargs.get("fd_solve") is not None:
        fd_solve = kwargs["fd_solve"]
        fd_interp = (t_lower, fd_solve(t_lower).temp, t_upper,
                     fd_solve(t_upper).temp)
        kwargs = dict(kwargs, fd_solve=None, fd_interp=fd_interp)
    quick = fd_interp is None and kwargs.get("fd_solve") is None
    if t0_old.device.type == "cpu":
        solve = surface_brent_plain if quick else surface_root_plain
    elif quick:
        solve = kernels.surface_brent
    elif fd_interp is not None:
        solve = kernels.affine_surface_brent
    else:
        solve = kernels.fd_surface_brent
    res = solve(t_lower, t_upper, active, max_iter=max_iter,
                eb_kwargs=kwargs)
    ts = torch.where(res.converged, res.root, t0_old)  # TFALLBACK
    return ts, ~res.converged, fd_interp, res.terms if quick else None
