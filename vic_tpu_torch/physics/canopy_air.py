"""Canopy-air (atmospheric-exchange) energy balance -- CLOSE_ENERGY.

Counterpart of `vic_tpu/physics/canopy_air.py` (calc_atmos_energy_bal.c:
7-167, func_atmos_energy_bal.c:9-29): the canopy air temperature at which
the sensible heat carried to the atmosphere equals the sensible heat the
overstory and the understory inject,

    InSensible = rho_air * Cp * (Tair - Tcanopy) / Ra_overstory,

in closed form (the residual is linear in Tcanopy); a root outside
+/- CANOPY_DT of Tair falls back to Tair with the flag raised.

`canopy_air_step` is one pass of the CLOSE_ENERGY fixed point of
`vic_tpu/model.py:796-851` but for its column() evaluation: the update of
the canopy-air temperature and the batch's largest change
(`largest_change` reads it on the host), and `canopy_air_final` the
loop's final update at the settled temperature (`vic_tpu/model.py:844`).
Each runs its K9 kernel on CUDA tensors (`csrc/canopy_air.cu`) and its
plain version on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants as c
from .. import kernels


class CanopyAirResult(NamedTuple):
    tcanopy: torch.Tensor       # canopy air temperature (C)
    fbflag: torch.Tensor        # bool: fell back to Tair (TFALLBACK)
    sensible: torch.Tensor      # atmos-level sensible heat at Tcanopy (W/m^2)
    error: torch.Tensor         # residual InSensible - SensibleHeat (W/m^2)


def calc_atmos_energy_bal(in_sensible, tair, air_dens,
                          ra_over) -> CanopyAirResult:
    """The canopy-air energy balance for Tcanopy, lane by lane.
    in_sensible: overstory canopy sensible + understory (soil + snow)
    sensible heat (surface_fluxes.c:595-608); ra_over: the overstory
    aerodynamic resistance (s/m)."""
    ra = torch.clamp(ra_over, min=1e-6)
    coef = air_dens * c.CP / ra
    tc = tair - in_sensible / torch.clamp(coef, min=1e-12)
    inside = torch.abs(tc - tair) <= c.CANOPY_DT
    tcanopy = torch.where(inside, tc, tair)          # TFALLBACK -> Tair
    sensible = coef * (tair - tcanopy)
    return CanopyAirResult(tcanopy=tcanopy, fbflag=~inside,
                           sensible=sensible, error=in_sensible - sensible)


def canopy_air_step_plain(*, it, canopy_sensible, soil_sensible,
                          pack_sensible, cov_w, tair, air_dens, ra_over, tc,
                          tc_prev, g_prev, iter_mask, lane_mask):
    """Plain version of the `canopy_air_step` kernel: after pass `it` (from
    0) of the CLOSE_ENERGY loop at canopy-air temperature tc, the update
    F(tc) = calc_atmos_energy_bal's Tcanopy on iter_mask lanes (Tair
    elsewhere), g = F(tc) - tc, and the per-lane safeguarded secant on g
    with the damped half-step (tc + F)/2 where the secant is undefined or
    wild, or on the first pass (vic_tpu/model.py:799-837).

    Returns (tc_next, g, live_max): live_max is the largest |tc_next - tc|
    over lane_mask as a 0-d tensor, NaN if any of them is NaN."""
    under_sens = soil_sensible + pack_sensible * cov_w
    ca = calc_atmos_energy_bal(canopy_sensible + under_sens, tair, air_dens,
                               ra_over)
    g = torch.where(iter_mask, ca.tcanopy, tair) - tc
    denom = g - g_prev
    flat = torch.abs(denom) < 1e-12
    sec = g * (tc - tc_prev) / torch.where(flat, 1.0, denom)
    damped = flat | (torch.abs(sec) > 10.0) | (it == 0)
    tc_next = tc - torch.where(damped, -0.5 * g, sec)
    live = torch.where(lane_mask, torch.abs(tc_next - tc), 0.0)
    return tc_next, g, live.max()


def canopy_air_step(**inputs):
    """One CLOSE_ENERGY pass's canopy-air update: the kernel on CUDA
    tensors, `canopy_air_step_plain` on the CPU (same arguments)."""
    solve = (canopy_air_step_plain if inputs["tc"].device.type == "cpu"
             else kernels.canopy_air_step)
    return solve(**inputs)


def largest_change(live_max) -> float:
    """The batch's largest change of a pass as a Python float: the K9
    launch's pinned host word on the card (no copy launched), the tensor's
    value on the CPU."""
    if live_max.device.type == "cpu":
        return float(live_max)
    return kernels.canopy_air_largest_change(live_max)


def canopy_air_final_plain(*, canopy_sensible, soil_sensible, pack_sensible,
                           cov_w, tair, air_dens, ra_over, iter_mask):
    """Plain version of K9's final update: calc_atmos_energy_bal on the
    settled pass's sensible heat, on iter_mask lanes (vic_tpu/model.py:
    844-845's tc_update): (tcanopy, its fallback flag, the atmospheric
    sensible heat), Tair, False and the understory's sensible heat
    elsewhere."""
    under_sens = soil_sensible + pack_sensible * cov_w
    ca = calc_atmos_energy_bal(canopy_sensible + under_sens, tair, air_dens,
                               ra_over)
    return (torch.where(iter_mask, ca.tcanopy, tair),
            torch.where(iter_mask, ca.fbflag, False),
            torch.where(iter_mask, ca.sensible, under_sens))


def canopy_air_final(**inputs):
    """The CLOSE_ENERGY loop's final update: the kernel on CUDA tensors,
    `canopy_air_final_plain` on the CPU (same arguments)."""
    solve = (canopy_air_final_plain if inputs["tair"].device.type == "cpu"
             else kernels.canopy_air_final)
    return solve(**inputs)
