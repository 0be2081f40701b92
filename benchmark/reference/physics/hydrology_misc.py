"""Water-table position: the zwt-vs-moisture curves and their lookup.

Counterpart of `vic_tpu/physics/hydrology_misc.py`'s `build_zwt_curves`
(read_soilparam.c:1150-1245: an 11-point Brooks-Corey curve for each soil
layer, the lumped top N-1 layers and the whole column; numpy, float64) and
`compute_zwt` (compute_zwt.c: the interpolated lookup; zwt in cm, negative
below the surface), and the driver's treeline test (`compute_treeline`,
`july_avg_temperature`, numpy), and CORRPREC's WMO gauge-undercatch
correction (`correct_precip`, correct_precip.c).
"""
from __future__ import annotations

import numpy as np
import torch

MAX_ZWTVMOIST = 11  # vicNl_def.h MAX_ZWTVMOIST
GAUGE_HEIGHT = 1.0  # m, correct_precip.c:7


def build_zwt_curves(soil) -> dict:
    """The curves of every cell on the host: {'zwt': ..., 'moist': ...},
    float64 [n_cell, n_layer + 2, 11] (each layer, the top n_layer-1
    lumped, the whole column)."""
    depth = np.asarray(soil.depth, np.float64)       # [c, nl] m
    expt = np.asarray(soil.expt, np.float64)
    bubble = np.asarray(soil.bubble, np.float64)     # cm
    max_moist = np.asarray(soil.max_moist, np.float64)
    resid = np.asarray(soil.resid_moist, np.float64)
    n_cell, nl = depth.shape
    nz = MAX_ZWTVMOIST
    zwt_c = np.zeros((n_cell, nl + 2, nz))
    moist_c = np.zeros((n_cell, nl + 2, nz))

    def layer_curve(b, bub, d_cm, mmax, mresid):
        """(zwt', moist) over zwt' in [0, d_cm]."""
        zp = np.linspace(0.0, 1.0, nz)[None, :] * d_cm[:, None]
        b = b[..., None]
        bub = np.maximum(bub, 1e-6)[..., None]
        d = d_cm[..., None]
        w_avg = (d - zp - (b / (b - 1.0)) * bub
                 * (1.0 - np.power((zp + bub) / bub, (b - 1.0) / b))) / d
        w_avg = np.clip(w_avg, 0.0, 1.0)
        return zp, w_avg * (mmax[..., None] - mresid[..., None]) \
            + mresid[..., None]

    tmp_depth = np.zeros(n_cell)
    for lay in range(nl):
        zp, m = layer_curve(0.5 * (expt[:, lay] - 3.0), bubble[:, lay],
                            depth[:, lay] * 100.0, max_moist[:, lay],
                            resid[:, lay] * depth[:, lay] * 1000.0)
        zwt_c[:, lay, :] = -tmp_depth[:, None] * 100.0 - zp
        moist_c[:, lay, :] = m
        tmp_depth += depth[:, lay]

    def lumped(sl):
        """The curve of layers `sl` taken as one, depth-weighted."""
        dsum = depth[:, sl].sum(1)
        return layer_curve(
            (0.5 * (expt[:, sl] - 3.0) * depth[:, sl]).sum(1) / dsum,
            (bubble[:, sl] * depth[:, sl]).sum(1) / dsum, dsum * 100.0,
            max_moist[:, sl].sum(1),
            (resid[:, sl] * depth[:, sl] * 1000.0).sum(1))

    for row, sl in ((nl, slice(0, nl - 1)), (nl + 1, slice(0, nl))):
        zp, m = lumped(sl)
        zwt_c[:, row, :] = -zp
        moist_c[:, row, :] = m
    return {"zwt": zwt_c, "moist": moist_c}


def zwt_curves_to(curves: dict, device) -> dict:
    """The curves as float32 tensors on `device`, cast as
    `__graft_entry__._build` casts them for vic_tpu."""
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in curves.items()}


def compute_zwt(moist, curve_zwt, curve_moist):
    """Water-table depth (cm, negative below the surface) of moisture
    `moist` [...] mm on the curves [..., 11], moisture decreasing along the
    curve; below the driest point, the deepest zwt."""
    wetter = (curve_moist >= moist[..., None]).to(moist.dtype)
    idx = torch.clamp(wetter.sum(-1).to(torch.int64) - 1, 0,
                      MAX_ZWTVMOIST - 1)
    idx_hi = torch.clamp(idx + 1, 0, MAX_ZWTVMOIST - 1)

    def at(curve, i):
        shape = torch.broadcast_shapes(curve.shape[:-1], i.shape)
        return torch.gather(curve.expand(shape + curve.shape[-1:]), -1,
                            i.expand(shape)[..., None])[..., 0]

    m_lo, m_hi = at(curve_moist, idx), at(curve_moist, idx_hi)
    z_lo, z_hi = at(curve_zwt, idx), at(curve_zwt, idx_hi)
    frac = torch.clamp((moist - m_hi) / torch.where(m_lo == m_hi, 1.0,
                                                    m_lo - m_hi), 0.0, 1.0)
    zwt = z_hi + (z_lo - z_hi) * frac
    return torch.where(moist < curve_moist[..., -1], curve_zwt[..., -1], zwt)


def correct_precip(wind, wind_h, roughness, snow_roughness):
    """WMO gauge catch-ratio corrections (correct_precip.c:9-50): the wind
    at the gauge's height from the log profile over each surface, then
    (rain, snow) multiplicative factors."""
    wh = torch.clamp(wind_h, min=GAUGE_HEIGHT + 0.01)
    gw_rain = wind * (torch.log((GAUGE_HEIGHT + roughness) / roughness)
                      / torch.log(wh / roughness))
    rain = 100.0 / torch.exp(4.606 - 0.041 * torch.pow(gw_rain, 0.69))
    gw_snow = wind * (torch.log((GAUGE_HEIGHT + snow_roughness)
                                / snow_roughness)
                      / torch.log(wh / snow_roughness))
    snow = 100.0 / torch.exp(4.606 - 0.036 * torch.pow(gw_snow, 1.75))
    return rain, snow


def compute_treeline(avg_july_temp, tfactor_bands):
    """Bands above treeline: lapsed July Tavg <= 10 C (compute_treeline.c).
    avg_july_temp: [n_cell]; tfactor_bands: [n_cell, n_band].
    Returns bool [n_cell, n_band]."""
    return (np.asarray(avg_july_temp)[:, None]
            + np.asarray(tfactor_bands)) <= 10.0


def july_avg_temperature(air_temp, months) -> np.ndarray:
    """Average July air temperature from the forcing record
    (compute_treeline.c:60-90). air_temp [n_rec, n_cell]; months [n_rec]."""
    july = np.asarray(months) == 7
    if not july.any():
        return np.full(air_temp.shape[1], np.nan)
    return np.asarray(air_temp)[july].mean(0)
