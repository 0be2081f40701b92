"""Glacier bare-ice surface energy balance and ablation.

Counterpart of `vic_tpu/physics/glacier.py` (GlacierEnergyBalance.c,
glacier_melt.c:65-205). The balance at 0 C (the melt test), the Brent root
of `glacier_energy_terms` that gives the subfreezing ice-surface
temperature and the balance at the accepted temperature are one call: on
the CPU `glacier_brent_plain`, on a CUDA device the `glacier_brent` kernel
(`csrc/vic_kernels.cu`), which also forms what `glacier_ablation` returns.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants as c
from .. import kernels
from ..ops.rootfind import batched_brent
from .evap import svp
from .snow import stability_correction


class GlacierEBTerms(NamedTuple):
    rest: torch.Tensor
    melt_energy: torch.Tensor
    vapor_flux: torch.Tensor      # m/step
    latent: torch.Tensor
    latent_sub: torch.Tensor
    sensible: torch.Tensor
    advection: torch.Tensor
    delta_cc: torch.Tensor
    grnd_flux: torch.Tensor
    net_long: torch.Tensor


def glacier_energy_terms(tsurf, *, dt, ra, z_ref, roughness, air_dens, vp_air,
                         longwave_in, lv, pressure, rain_m, net_short, vpd,
                         wind, old_tsurf, ice_depth_mm, tair) -> GlacierEBTerms:
    """Glacier surface EB terms at candidate tsurf, ice body at GLAC_TEMP
    (GlacierEnergyBalance.c:calculate). The CUDA residual
    `GlacierResidual` in csrc/pack_residuals.cuh is a line-for-line copy."""
    tgrnd = c.GLAC_TEMP
    tmean = (tsurf + tgrnd) / 2.0
    old_tmean = (old_tsurf + tgrnd) / 2.0
    ice_depth = ice_depth_mm / 1000.0
    ra_corr = torch.where(
        wind > 0.0,
        ra / stability_correction(z_ref, 0.0, tsurf, tair, wind, roughness),
        c.HUGE_RESIST)
    tkelv = tsurf + c.KELVIN
    tk2 = tkelv * tkelv
    net_long = longwave_in - c.STEFAN_B * (tk2 * tk2)
    net_rad = net_short + net_long
    sensible = air_dens * c.CP * (tair - tsurf) / ra_corr

    # latent_heat_from_glacier.c
    es = svp(tsurf)
    vmf = air_dens * (c.EPS_RATIO / pressure) * (vp_air - es) / ra_corr
    vmf = torch.where((vpd == 0.0) & (vmf < 0.0), 0.0, vmf)
    ls = (677.0 - 0.07 * tsurf) * c.JOULES_PER_CAL * c.GRAMS_PER_KG
    latent = torch.where(tsurf >= 0.0, lv * vmf, 0.0)
    latent_sub = torch.where(tsurf >= 0.0, 0.0, ls * vmf)

    advection = torch.where(tsurf == 0.0, c.CH_WATER * tair * rain_m / dt, 0.0)
    delta_cc = c.CH_ICE * ice_depth * (tmean - old_tmean) / dt
    grnd_flux = (c.GLAC_K_ICE + tsurf * (-0.0142)) * (tgrnd - tsurf) \
        / torch.clamp(ice_depth, min=1e-6)
    rest = net_rad + sensible + latent + latent_sub + advection \
        - delta_cc + grnd_flux
    return GlacierEBTerms(
        rest=torch.where((tsurf == 0.0) & (rest >= 0.0), 0.0, rest),
        melt_energy=rest, vapor_flux=vmf * dt / c.RHO_W, latent=latent,
        latent_sub=latent_sub, sensible=sensible, advection=advection,
        delta_cc=delta_cc, grnd_flux=grnd_flux, net_long=net_long)


class GlacierSolve(NamedTuple):
    """glacier_ablation's solve of the bare-ice balance: the Brent's result
    (ops.rootfind.RootResult's fields), the melt test (the balance at 0 C
    is 0) and its melt, and at the accepted temperature (0 C where the ice
    melts, else the root, else old_tsurf) the temperature, the cold
    content, the vapour loss (m/step, loss positive), the fallback flag and
    the balance's terms."""
    root: torch.Tensor
    converged: torch.Tensor
    bracketed: torch.Tensor
    iterations: torch.Tensor
    melt_cond: torch.Tensor
    fbflag: torch.Tensor
    melt_mm: torch.Tensor
    surf_temp: torch.Tensor
    cold_content: torch.Tensor
    vapor_flux: torch.Tensor
    terms: GlacierEBTerms


def glacier_brent_plain(lo, hi, active, *, dt, max_iter, max_tries,
                        **inputs):
    """Plain version of the `glacier_brent` kernel: glacier_energy_terms at
    0 C, its melt test and melt (glacier.py:117-123 of the JAX package),
    expand-then-Brent on `glacier_energy_terms(t).rest` on the lanes of
    `active` (None: every lane) that do not melt (:130), and the terms at
    the accepted temperature (:135-140). A GlacierSolve."""
    terms0 = glacier_energy_terms(torch.zeros_like(lo), dt=dt, **inputs)
    melt_cond = terms0.rest == 0.0
    melt_mm = torch.where(melt_cond,
                          torch.clamp(terms0.melt_energy, min=0.0)
                          / (c.LF * c.RHO_W) * dt * 1000.0, 0.0)
    solved = ~melt_cond if active is None else ~melt_cond & active
    res = batched_brent(
        lambda t: glacier_energy_terms(t, dt=dt, **inputs).rest, lo, hi,
        max_iter=max_iter, max_tries=max_tries, active=solved)
    t_cold = torch.where(res.converged, res.root,
                         inputs["old_tsurf"])   # TFALLBACK
    surf_temp = torch.where(melt_cond, 0.0, t_cold)
    terms = glacier_energy_terms(surf_temp, dt=dt, **inputs)
    cold_content = torch.where(
        melt_cond, 0.0,
        c.CH_ICE * surf_temp * inputs["ice_depth_mm"] / 1000.0)
    return GlacierSolve(
        *res, melt_cond=melt_cond, fbflag=~melt_cond & ~res.converged,
        melt_mm=melt_mm, surf_temp=surf_temp, cold_content=cold_content,
        vapor_flux=-terms.vapor_flux, terms=terms)


class GlacierAblationResult(NamedTuple):
    melt_mm: torch.Tensor
    surf_temp: torch.Tensor
    cold_content: torch.Tensor
    vapor_flux: torch.Tensor    # m/step, loss positive
    fbflag: torch.Tensor
    terms: GlacierEBTerms


def glacier_ablation(*, tair, net_short, longwave_in, wind, vp_air, vpd,
                     air_dens, pressure, le, rain_mm, ra, z_ref, roughness,
                     old_tsurf, glac_surf_thick, dt_sec, max_iter: int = 30,
                     active_mask=None) -> GlacierAblationResult:
    """Bare-ice ablation on glacier HRU lanes (glacier_melt.c:65-205).
    glac_surf_thick: the surface-layer thickness (mm) used as IceDepth.
    The balance at 0 C, the Brent solve and the balance at the accepted
    temperature are one call (K1 on the card, glacier_brent_plain on the
    CPU)."""
    solve = (glacier_brent_plain if tair.device.type == "cpu"
             else kernels.glacier_brent)
    res = solve(old_tsurf - c.SNOW_DT, old_tsurf + c.SNOW_DT, active_mask,
                dt=dt_sec, max_iter=max_iter, max_tries=1, ra=ra,
                z_ref=z_ref, roughness=roughness, air_dens=air_dens,
                vp_air=vp_air, longwave_in=longwave_in, lv=le,
                pressure=pressure, rain_m=rain_mm / 1000.0,
                net_short=net_short, vpd=vpd, wind=wind, old_tsurf=old_tsurf,
                ice_depth_mm=glac_surf_thick, tair=tair)
    return GlacierAblationResult(
        melt_mm=res.melt_mm, surf_temp=res.surf_temp,
        cold_content=res.cold_content, vapor_flux=res.vapor_flux,
        fbflag=res.fbflag, terms=res.terms)
