"""Aerodynamic resistance over the four surface cases (snow-free, canopy,
snow-covered, glacier). Counterpart of `vic_tpu/physics/aero.py`
(CalcAerodynamic.c:7-272): both the overstory and the no-overstory profile
are computed on every lane and merged by the overstory mask.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..constants import HUGE_RESIST, VON_K


class SurfaceCases(NamedTuple):
    snow_free: torch.Tensor
    canopy: torch.Tensor
    snow_covered: torch.Tensor
    glacier: torch.Tensor


class AeroResult(NamedTuple):
    resist: SurfaceCases        # s/m
    wind: SurfaceCases          # m/s
    displacement: SurfaceCases  # m
    ref_height: SurfaceCases    # m
    roughness: SurfaceCases     # m


def calc_aerodynamic(overstory, height, trunk_ratio, z0_snow, z0_soil,
                     wind_atten, displacement_veg, roughness_veg,
                     ref_height_veg, wind) -> AeroResult:
    k2 = VON_K * VON_K
    eps = 1e-10
    log = torch.log
    exp = torch.exp

    def mx(x, v):
        return torch.clamp(x, min=v)

    # no-overstory lane (CalcAerodynamic.c:96-132)
    z0_lo = mx(roughness_veg, eps)
    d_lo = displacement_veg
    zref = ref_height_veg
    log_2z0 = log((2.0 + z0_lo) / z0_lo)
    log_ref = log(mx((zref - d_lo) / z0_lo, 1.0 + eps))
    u_sf_no = log_2z0 / log_ref
    ra_sf_no = log_2z0 * log_ref / k2

    z0s = mx(z0_snow, eps)
    log_2z0s = log((2.0 + z0s) / z0s)
    log_refs = log(mx(zref / z0s, 1.0 + eps))
    u_sc_no = log_2z0s / log_refs
    ra_sc_no = log_2z0s * log_refs / k2

    log_refg = log(mx(zref / z0_lo, 1.0 + eps))
    u_gl_no = log_2z0 / log_refg
    ra_gl_no = log_2z0 * log_refg / k2

    # overstory lane (CalcAerodynamic.c:137-240)
    z0_up = mx(roughness_veg, eps)
    d_up = displacement_veg
    z0_soil_s = mx(z0_soil, eps)
    h = mx(height, 2.0 * eps)
    zw = 1.5 * h - 0.5 * d_up
    zt = torch.maximum(trunk_ratio * h, z0_soil_s * (1.0 + eps))
    n = wind_atten

    log_up = log(mx((zref - d_up) / z0_up, 1.0 + eps))
    n_safe = torch.where(n == 0.0, 1.0, n)
    ra_can = (log_up / k2
              * (h / (n_safe * (zw - d_up))
                 * (exp(n * (1.0 - (d_up + z0_up) / h)) - 1.0)
                 + (zw - h) / (zw - d_up)
                 + log(mx((zref - d_up) / (zw - d_up), eps))))
    uw = log(mx((zw - d_up) / z0_up, 1.0 + eps)) / log_up
    uh = uw - (1.0 - (h - d_up) / (zw - d_up)) / log_up
    u_can = uh * exp(n * ((z0_up + d_up) / h - 1.0))
    ut = mx(uh * exp(n * (zt / h - 1.0)), eps)

    log_2zsoil = log((2.0 + z0_soil_s) / z0_soil_s)
    log_zt = log(mx(zt / z0_soil_s, 1.0 + eps))
    u_sf_ov = ut * log_2zsoil / log_zt
    ra_sf_ov = log_2zsoil * log_zt / (k2 * ut)

    # snow under overstory: 3 cases by canopy geometry
    log_zts = log(mx(zt / z0s, 1.0 + eps))
    u_sc_1 = ut * log_2z0s / log_zts
    ra_sc_1 = log_2z0s * log_zts / (k2 * ut)
    u_sc_2 = uh * exp(n * ((2.0 + z0s) / h - 1.0))
    ra_sc_2 = (log_zts * log_zts / (k2 * ut)
               + h * log_up / (n_safe * k2 * (zw - d_up))
               * (exp(n * (1.0 - zt / h)) - exp(n * (1.0 - (z0s + 2.0) / h))))
    u_sc_3 = uh
    ra_sc_3 = (log_zts * log_zts / (k2 * ut)
               + h * log_up / (n_safe * k2 * (zw - d_up))
               * (exp(n * (1.0 - zt / h)) - 1.0))
    case1 = zt > (2.0 + z0s)
    case2 = h > (2.0 + z0s)
    u_sc_ov = torch.where(case1, u_sc_1, torch.where(case2, u_sc_2, u_sc_3))
    ra_sc_ov = torch.where(case1, ra_sc_1,
                           torch.where(case2, ra_sc_2, ra_sc_3))

    ov = overstory
    W = torch.where
    zeros = torch.zeros_like(d_lo)
    disp = SurfaceCases(snow_free=W(ov, zeros, d_lo), canopy=d_up,
                        snow_covered=zeros, glacier=zeros)
    refh = SurfaceCases(snow_free=W(ov, 2.0 + z0_soil_s, zref), canopy=zref,
                        snow_covered=2.0 + z0s,
                        glacier=2.0 + W(ov, z0_soil_s, z0_lo))
    rough = SurfaceCases(snow_free=W(ov, z0_soil_s, z0_lo), canopy=z0_up,
                         snow_covered=z0s, glacier=W(ov, z0_soil_s, z0_lo))

    # wind scaling (CalcAerodynamic.c:243-258); zero wind -> HUGE_RESIST
    windy = wind > 0.0
    w = mx(wind, 1e-10)

    def scale(u, ra):
        return W(windy, u * w, 0.0), W(windy, ra / w, HUGE_RESIST)

    u_sf, ra_sf = scale(W(ov, u_sf_ov, u_sf_no), W(ov, ra_sf_ov, ra_sf_no))
    u_can_m, ra_can_m = scale(W(ov, u_can, u_sf_no), W(ov, ra_can, ra_sf_no))
    u_sc, ra_sc = scale(W(ov, u_sc_ov, u_sc_no), W(ov, ra_sc_ov, ra_sc_no))
    u_gl, ra_gl = scale(W(ov, u_sf_ov, u_gl_no), W(ov, ra_sf_ov, ra_gl_no))

    return AeroResult(
        resist=SurfaceCases(ra_sf, ra_can_m, ra_sc, ra_gl),
        wind=SurfaceCases(u_sf, u_can_m, u_sc, u_gl),
        displacement=disp, ref_height=refh, roughness=rough)
