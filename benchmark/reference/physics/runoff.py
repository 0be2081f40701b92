"""Surface runoff, inter-layer drainage and ARNO baseflow.

Counterpart of `vic_tpu/physics/runoff.py` (runoff.c): the VIC infiltration
curve, then `dt_hours` hourly trips of Brooks-Corey drainage, the
saturation-overflow cascade, evap withdrawal and ARNO baseflow. A step of
it runs through `runoff_step_plain` (the hourly loop in
`runoff_hourly_plain`) on the CPU and, the whole of it in one launch,
through the `runoff_hourly` kernel (`csrc/vic_kernels.cu`) on a CUDA
device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch



class RunoffResult(NamedTuple):
    moist: torch.Tensor      # [..., nl] mm
    runoff: torch.Tensor     # mm/step
    baseflow: torch.Tensor   # mm/step
    asat: torch.Tensor
    layer_evap: torch.Tensor  # [..., nl] mm/step actually taken


def compute_runoff_and_asat(moist, max_moist_l, b_infilt, inflow):
    """Wood et al. 1992 runoff from the infiltration curve over the top
    N-1 layers (runoff.c:773-814). Returns (asat, runoff)."""
    top_max = max_moist_l[..., :-1].sum(-1)
    top_moist = torch.minimum(moist[..., :-1].sum(-1), top_max)
    ex = b_infilt / (1.0 + b_infilt)
    rel = torch.clamp(1.0 - top_moist / torch.clamp(top_max, min=1e-10),
                      0.0, 1.0)
    asat = 1.0 - torch.pow(rel, ex)
    max_infil = (1.0 + b_infilt) * top_max
    i0 = max_infil * (1.0 - torch.pow(torch.clamp(1.0 - asat, 0.0, 1.0),
                                      1.0 / b_infilt))
    basis = torch.clamp(1.0 - (i0 + inflow)
                        / torch.clamp(max_infil, min=1e-10), 0.0, 1.0)
    runoff_3a = inflow - top_max + top_moist
    runoff_3b = runoff_3a + top_max * torch.pow(basis, 1.0 + b_infilt)
    runoff = torch.where((i0 + inflow) > max_infil, runoff_3a, runoff_3b)
    runoff = torch.where(max_infil == 0.0, inflow, runoff)
    runoff = torch.where(inflow == 0.0, 0.0, runoff)
    return asat, torch.clamp(runoff, min=0.0)


def runoff_hourly_plain(liq0, ice, evap_hr, resid_mm, max_moist, ksat_hr,
                        expt, dt_runoff, dt_inflow, dsmax_hr, ds, ws, c_expt,
                        dt_hours: int):
    """Plain version of the `runoff_hourly` kernel: the hourly loop of
    runoff.c:446-700 (runoff.py:84-172 of the JAX package). Layer arrays
    [..., nl], the rest [...]. Returns (liq, runoff_extra, baseflow)."""
    W = torch.where
    nl = liq0.shape[-1]
    lb = nl - 1
    liq = liq0
    runoff_acc = torch.zeros_like(dt_inflow)
    baseflow_acc = torch.zeros_like(dt_inflow)
    for _ in range(dt_hours):
        # drainage between layers (runoff.c:496-522)
        q12 = []
        for l in range(nl - 1):
            tmp_liq = torch.maximum(liq[..., l] - evap_hr[..., l],
                                    resid_mm[..., l])
            frac = torch.clamp(
                (tmp_liq - resid_mm[..., l])
                / torch.clamp(max_moist[..., l] - resid_mm[..., l], min=1e-10),
                0.0, 1.0)
            q12.append(W(liq[..., l] > resid_mm[..., l],
                         ksat_hr[..., l] * torch.pow(frac, expt[..., l]), 0.0))

        liq_l = [liq[..., l] for l in range(nl)]
        runoff_h = torch.zeros_like(runoff_acc)

        def cascade_up(top, amount):
            # excess moves up through layers top..0; what leaves layer 0
            # is returned (becomes runoff)
            for up in range(top, -1, -1):
                liq_l[up] = liq_l[up] + amount
                amount = torch.clamp(
                    liq_l[up] + ice[..., up] - max_moist[..., up], min=0.0)
                liq_l[up] = torch.minimum(
                    liq_l[up], max_moist[..., up] - ice[..., up])
            return amount

        # upper layers in order (runoff.c:530-612)
        inflow = dt_inflow
        for l in range(nl - 1):
            dro = dt_runoff if l == 0 else 0.0
            liq_l[l] = liq_l[l] + (inflow - dro) - (q12[l] + evap_hr[..., l])
            excess = torch.clamp(liq_l[l] + ice[..., l] - max_moist[..., l],
                                 min=0.0)
            liq_l[l] = torch.minimum(liq_l[l], max_moist[..., l] - ice[..., l])
            if l == 0:
                q12[0] = q12[0] + excess
            else:
                runoff_h = runoff_h + cascade_up(l - 1, excess)
            deficit = torch.clamp(liq_l[l] + ice[..., l] - resid_mm[..., l],
                                  max=0.0)
            q12[l] = q12[l] + deficit
            liq_l[l] = torch.maximum(liq_l[l], resid_mm[..., l] - ice[..., l])
            inflow = q12[l]

        # ARNO baseflow from the bottom layer (runoff.c:615-645)
        rel_moist = ((liq_l[lb] - resid_mm[..., lb])
                     / torch.clamp(max_moist[..., lb] - resid_mm[..., lb],
                                   min=1e-10))
        base = dsmax_hr * ds / ws * rel_moist
        over_ws = torch.clamp((rel_moist - ws) / torch.clamp(1.0 - ws,
                                                             min=1e-10),
                              min=0.0)
        base = base + W(rel_moist > ws,
                        dsmax_hr * (1.0 - ds / ws) * torch.pow(over_ws,
                                                               c_expt), 0.0)
        base = torch.clamp(base, min=0.0)
        liq_l[lb] = liq_l[lb] + q12[lb - 1] - (evap_hr[..., lb] + base)

        # bottom-layer bounds (runoff.c:650-700)
        deficit = torch.clamp(liq_l[lb] + ice[..., lb] - resid_mm[..., lb],
                              max=0.0)
        base = base + deficit
        liq_l[lb] = torch.maximum(liq_l[lb], resid_mm[..., lb] - ice[..., lb])
        over = torch.clamp(liq_l[lb] + ice[..., lb] - max_moist[..., lb],
                           min=0.0)
        liq_l[lb] = torch.minimum(liq_l[lb], max_moist[..., lb] - ice[..., lb])
        runoff_h = runoff_h + cascade_up(lb - 1, over)

        liq = torch.stack(liq_l, dim=-1)
        runoff_acc = runoff_acc + runoff_h
        baseflow_acc = baseflow_acc + base
    return liq, runoff_acc, baseflow_acc


def runoff_step_plain(moist, soil_ice, layer_evap, ppt, max_moist_l,
                      resid_fract, depth, ksat, expt, b_infilt, ds, dsmax,
                      ws, c_expt, dt_hours: int) -> RunoffResult:
    """Plain version of the `runoff_hourly` kernel: one model step of
    runoff/drainage/baseflow (runoff.py:55-184 of the JAX package)."""
    resid_mm = resid_fract * depth * 1000.0
    _, runoff0 = compute_runoff_and_asat(moist, max_moist_l, b_infilt, ppt)
    liq_f, runoff_extra, baseflow = runoff_hourly_plain(
        moist - soil_ice, soil_ice, layer_evap / dt_hours, resid_mm,
        max_moist_l, ksat / 24.0, expt, runoff0 / dt_hours, ppt / dt_hours,
        dsmax / 24.0, ds, ws, c_expt, dt_hours)

    # negative total baseflow reduces bottom-layer evap (runoff.c:704-707)
    evap_out = torch.cat(
        [layer_evap[..., :-1],
         layer_evap[..., -1:] + torch.clamp(baseflow, max=0.0)[..., None]], -1)
    moist_f = liq_f + soil_ice
    asat, _ = compute_runoff_and_asat(moist_f, max_moist_l, b_infilt,
                                      torch.zeros_like(ppt))
    return RunoffResult(moist=moist_f, runoff=runoff0 + runoff_extra,
                        baseflow=torch.clamp(baseflow, min=0.0), asat=asat,
                        layer_evap=evap_out)


def runoff_step(moist, soil_ice, layer_evap, ppt, max_moist_l, resid_fract,
                depth, ksat, expt, b_infilt, ds, dsmax, ws, c_expt,
                dt_hours: int) -> RunoffResult:
    """One model step of runoff/drainage/baseflow on every HRU lane
    (runoff.c). moist/soil_ice/layer_evap [..., nl] in mm, ppt mm/step,
    ksat and dsmax in mm/day. runoff_step_plain on the CPU, the
    `runoff_hourly` kernel on a CUDA device."""
    step = runoff_step_plain
    return step(moist, soil_ice, layer_evap, ppt, max_moist_l, resid_fract,
                depth, ksat, expt, b_infilt, ds, dsmax, ws, c_expt, dt_hours)
