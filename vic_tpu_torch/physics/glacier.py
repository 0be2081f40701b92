"""Glacier bare-ice surface energy balance and ablation.

Counterpart of `vic_tpu/physics/glacier.py` (GlacierEnergyBalance.c,
glacier_melt.c:65-205). The subfreezing ice-surface temperature is a Brent
root of `glacier_energy_terms`: on the CPU through `glacier_brent_plain`,
on a CUDA device through the `glacier_brent` kernel (`csrc/vic_kernels.cu`).
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
    `GlacierResidual` in csrc/vic_kernels.cu is a line-for-line copy."""
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


def glacier_brent_plain(lo, hi, active, *, dt, max_iter, max_tries, **inputs):
    """Plain version of the `glacier_brent` kernel: expand-then-Brent on
    `glacier_energy_terms(t).rest` (glacier.py:130 of the JAX package)."""
    return batched_brent(
        lambda t: glacier_energy_terms(t, dt=dt, **inputs).rest, lo, hi,
        max_iter=max_iter, max_tries=max_tries, active=active)


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
    glac_surf_thick: the surface-layer thickness (mm) used as IceDepth."""
    kwargs = dict(dt=dt_sec, ra=ra, z_ref=z_ref, roughness=roughness,
                  air_dens=air_dens, vp_air=vp_air, longwave_in=longwave_in,
                  lv=le, pressure=pressure, rain_m=rain_mm / 1000.0,
                  net_short=net_short, vpd=vpd, wind=wind,
                  old_tsurf=old_tsurf, ice_depth_mm=glac_surf_thick,
                  tair=tair)
    terms0 = glacier_energy_terms(torch.zeros_like(tair), **kwargs)
    melt_cond = terms0.rest == 0.0
    melt_mm = torch.where(melt_cond,
                          torch.clamp(terms0.melt_energy, min=0.0)
                          / (c.LF * c.RHO_W) * dt_sec * 1000.0, 0.0)

    brent_active = ~melt_cond if active_mask is None \
        else ~melt_cond & active_mask
    solve = (glacier_brent_plain if tair.device.type == "cpu"
             else kernels.glacier_brent)
    res = solve(old_tsurf - c.SNOW_DT, old_tsurf + c.SNOW_DT, brent_active,
                max_iter=max_iter, max_tries=1, **kwargs)
    t_cold = torch.where(res.converged, res.root, old_tsurf)  # TFALLBACK
    fbflag = ~melt_cond & ~res.converged
    surf_temp = torch.where(melt_cond, 0.0, t_cold)
    terms = glacier_energy_terms(surf_temp, **kwargs)
    cold_content = torch.where(melt_cond, 0.0,
                               c.CH_ICE * surf_temp * glac_surf_thick / 1000.0)
    return GlacierAblationResult(
        melt_mm=melt_mm, surf_temp=surf_temp, cold_content=cold_content,
        vapor_flux=-terms.vapor_flux, fbflag=fbflag, terms=terms)
