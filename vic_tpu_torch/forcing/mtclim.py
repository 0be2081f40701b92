"""MTCLIM 4.3 meteorological estimator, batched over cells.

A copy of `vic_tpu/forcing/mtclim.py`: P. Thornton's MTCLIM as integrated
in the reference (mtclim_vic.c, constants mtclim_constants_vic.h /
mtclim_parameters_vic.h). From daily Tmax/Tmin/precip it estimates daylight
average shortwave, vapor pressure (iterative SW<->humidity coupling per
VP_ITER), cloud fraction, daylength, and the sub-daily radiation fraction
profile used for disaggregation (tiny_radfract).

Everything is vectorized numpy over [n_cell, n_day] in float64, apart from
the hour-angle radiation integration (mtclim_vic.c:70-167): it loops over
the 365 yeardays with the 30-s sub-daily grid of every cell, [n_cell,
2880] a day, which takes numpy ~40 ms a cell; it runs in float64 torch on
the caller's device, the same operations in the same order.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# mtclim_constants_vic.h / mtclim_parameters_vic.h
TDAYCOEF = 0.45
SECPERRAD = 13750.9871
RADPERDAY = 0.017214
RADPERDEG = 0.01745329
MINDECL = -0.4092797
DAYSOFF = 11.25
SRADDT = 30.0
MA = 28.9644e-3
R_GAS = 8.3143
G_STD = 9.80665
P_STD = 101325.0
T_STD = 288.15
LR_STD = 0.0065
CP_AIR = 1010.0
EPS_MT = 0.62196351
TBASE = 0.870
ABASE = -6.1e-5
C_PARAM = 1.5
B0, B1, B2 = 0.031, 0.201, 0.185
RAIN_SCALAR = 0.75
DIF_ALB = 0.6
SC_INT, SC_SLOPE = 1.32, 0.096
KELVIN = 273.15

_OPTAM = np.array([2.90, 3.05, 3.21, 3.39, 3.69, 3.82, 4.07, 4.37, 4.72, 5.12,
                   5.60, 6.18, 6.88, 7.77, 8.90, 10.39, 12.44, 15.36, 19.79,
                   26.96, 30.00])


def svp_mtclim(t):
    """svp.c formula (Pa) shared with the model physics."""
    s = 610.78 * np.exp(17.269 * t / (237.3 + t))
    return np.where(t < 0.0, s * (1.0 + 0.00972 * t + 0.000042 * t * t), s)


def atm_pres(elev):
    """Pressure from elevation (mtclim_vic.c atm_pres)."""
    t1 = 1.0 - (LR_STD * elev) / T_STD
    t2 = G_STD / (LR_STD * (R_GAS / MA))
    return P_STD * np.power(t1, t2)


def pulled_boxcar(x, width):
    """Trailing boxcar mean over the time axis (mtclim_vic.c pulled_boxcar):
    out[i] = mean(x[max(0, i-width+1) .. i]). x: [n_cell, n_day]."""
    n = x.shape[-1]
    width = min(width, n)
    csum = np.cumsum(x, axis=-1)
    out = np.empty_like(x, dtype=np.float64)
    out[..., :width] = csum[..., :width] / np.arange(1, width + 1)
    out[..., width:] = (csum[..., width:] - csum[..., :-width]) / width
    return out


def solar_geometry(lat_deg: np.ndarray, elev: np.ndarray,
                   steps_per_day: int, device="cpu") -> Dict[str, np.ndarray]:
    """Per-yearday radiation geometry (mtclim_vic.c STEP 3).

    Returns ttmax0/flat_potrad/daylength [n_cell, 366] and radfract
    [n_cell, 366, steps_per_day] (fraction of daily flat-surface potential
    radiation in each model sub-step; tiny_radfract aggregated from the 30-s
    grid) as numpy float64. Slope/aspect/horizons are zero (the reference's
    defaults for VIC cells, mtclim_wrapper.c). The [n_cell, 2880] work of
    each day runs in float64 on `device`."""
    n_cell = len(lat_deg)
    lat = np.clip(np.asarray(lat_deg) * RADPERDEG, -1.5707, 1.5707)
    coslat, sinlat = np.cos(lat), np.sin(lat)

    # elevation-corrected max transmittance base (STEPs 1-2)
    t1 = 1.0 - (LR_STD * np.asarray(elev)) / T_STD
    t2 = G_STD / (LR_STD * (R_GAS / MA))
    pratio = np.power(t1, t2)
    trans1 = np.power(TBASE, pratio)            # [n_cell]

    nsub = int(86400 / SRADDT)
    h_all = (np.arange(nsub) * SRADDT + 0.5 * SRADDT - 12.0 * 3600.0) \
        / SECPERRAD                              # hour angle of each 30s step
    agg = nsub // steps_per_day

    ttmax0 = np.zeros((n_cell, 366))
    flat_potrad = np.zeros((n_cell, 366))
    daylength = np.zeros((n_cell, 366))
    radfract = torch.zeros((n_cell, 366, steps_per_day), dtype=torch.float64,
                           device=device)

    def T(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    cosh_all, abs_h, trans1_t, optam = (T(np.cos(h_all)), T(np.abs(h_all)),
                                        T(trans1), T(_OPTAM))
    for yday in range(365):
        decl = MINDECL * np.cos((yday + DAYSOFF) * RADPERDAY)
        cosdecl, sindecl = np.cos(decl), np.sin(decl)
        cosegeom = coslat * cosdecl               # [n_cell]
        sinegeom = sinlat * sindecl
        coshss = np.clip(-sinegeom / cosegeom, -1.0, 1.0)
        hss = np.arccos(coshss)
        dayl = np.minimum(2.0 * hss * SECPERRAD, 86400.0)
        daylength[:, yday] = dayl

        sc = 1368.0 + 45.5 * np.sin(2.0 * np.pi * yday / 365.25 + 1.7)
        dir_beam_topa = float(sc * SRADDT)

        cza = T(cosegeom)[:, None] * cosh_all[None, :] + T(sinegeom)[:, None]
        active = (cza > 0.0) & (abs_h[None, :] < T(hss)[:, None])
        dir_flat_topa = torch.where(active, dir_beam_topa * cza, 0.0)

        am = 1.0 / (torch.clamp(cza, min=1e-7) + 1e-7)
        big = am > 2.9
        ami = torch.clamp(torch.rad2deg(torch.arccos(torch.clamp(cza, -1, 1)))
                          .to(torch.int64) - 69, 0, 20)
        am = torch.where(big, optam[ami], am)
        trans2 = torch.pow(trans1_t[:, None], am)

        sum_trans = (trans2 * dir_flat_topa).sum(1).cpu().numpy()
        sum_flat = dir_flat_topa.sum(1)
        sum_flat_np = sum_flat.cpu().numpy()

        ok = (dayl > 0) & (sum_flat_np > 0)
        ttmax0[:, yday] = np.where(
            ok, sum_trans / np.maximum(sum_flat_np, 1e-30), 0.0)
        flat_potrad[:, yday] = np.where(
            ok, sum_flat_np / np.maximum(dayl, 1.0), 0.0)
        # aggregate 30-s fractions to model sub-steps
        frac = dir_flat_topa / torch.clamp(sum_flat, min=1e-30)[:, None]
        radfract[:, yday, :] = frac.reshape(n_cell, steps_per_day,
                                            agg).sum(-1)

    # yearday 366 = 365 (mtclim_vic.c:343-350)
    ttmax0[:, 365] = ttmax0[:, 364]
    flat_potrad[:, 365] = flat_potrad[:, 364]
    daylength[:, 365] = daylength[:, 364]
    radfract[:, 365] = radfract[:, 364]
    return dict(ttmax0=ttmax0, flat_potrad=flat_potrad, daylength=daylength,
                radfract=radfract.cpu().numpy())


def effective_annual_precip(prcp_cm: np.ndarray) -> np.ndarray:
    """90-day moving-window effective annual precip in cm
    (mtclim_vic.c:141-197). prcp_cm: [n_cell, n_day]."""
    n_cell, n_day = prcp_cm.shape
    if n_day < 90:
        eff = prcp_cm.mean(-1, keepdims=True) * 365.25
        return np.broadcast_to(np.maximum(eff, 8.0), prcp_cm.shape).copy()
    window = np.concatenate([prcp_cm[:, :90], prcp_cm], axis=1)
    csum = np.cumsum(window, axis=1)
    tot90 = np.empty((n_cell, n_day))
    tot90[:, 0] = csum[:, 89]
    tot90[:, 1:] = csum[:, 90:n_day + 89] - csum[:, :n_day - 1]
    eff = (tot90 / 90.0) * 365.25
    return np.maximum(eff, 8.0)


def calc_pet_mtclim(rad, tday, pa, dayl):
    """Priestly-Taylor PET in cm/day (mtclim_vic.c calc_pet)."""
    rnet = rad * 0.72
    lhvap = 2.5023e6 - 2430.54 * tday
    gamma = CP_AIR * pa / (lhvap * EPS_MT)
    dt = 0.2
    s = (svp_mtclim(tday + dt) - svp_mtclim(tday - dt)) / (2 * dt)
    pet = (1.26 * (s / (s + gamma)) * rnet * dayl) / lhvap
    return pet / 10.0


SNOW_TCRIT = -6.0    # deg C, critical temperature (mtclim_parameters:35)
SNOW_TRATE = 0.042   # cm/degC/day melt rate (mtclim_parameters:36)


def mtclim_snowpack(prcp_cm, tmin, yday):
    """Radiation-correction snowpack (mtclim_vic.c:461-523 snowpack()).

    prcp_cm/tmin: [n_cell, n_day]; yday: [n_day] 1-based. Returns SWE in cm.
    """
    n_cell, n_day = np.shape(prcp_cm)
    newsnow = np.where(tmin <= SNOW_TCRIT, prcp_cm, 0.0)
    melt = np.where(tmin <= SNOW_TCRIT, 0.0,
                    SNOW_TRATE * (tmin - SNOW_TCRIT))
    delta = newsnow - melt

    def accumulate(init):
        swe = np.zeros((n_cell, n_day))
        pack = init
        for i in range(n_day):
            pack = np.maximum(pack + delta[:, i], 0.0)
            swe[:, i] = pack
        return swe

    swe = accumulate(np.zeros(n_cell))
    start_yday = yday[0]
    prev_yday = 365 if start_yday == 1 else start_yday - 1
    match = (yday[1:] == start_yday) | (yday[1:] == prev_yday)
    count = int(match.sum())
    if count:
        swe = accumulate(swe[:, 1:][:, match].sum(-1) / count)
    return swe


def mtclim_run(lat_deg, elev, yday, prcp_mm, tmax, tmin, swe_mm=None,
               sw_prec_thresh=0.0, mtclim_swe_corr=True, vp_iter=1,
               steps_per_day=24, supplied_sw=None, supplied_vp=None,
               device="cpu") -> Dict[str, np.ndarray]:
    """Full MTCLIM pipeline (calc_srad_humidity_iterative).

    yday: [n_day] 1-based yeardays; other daily inputs [n_cell, n_day] with
    precip in mm (converted to cm internally like mtclim_wrapper.c:94-100).
    vp_iter: 0 NONE / 1 ALWAYS / 2 ANNUAL / 3 CONVERGE. device: where
    `solar_geometry` runs.
    Returns daily estimates + the radfract table for disaggregation.
    """
    n_cell, n_day = np.shape(tmax)
    prcp_cm = np.asarray(prcp_mm, np.float64) / 10.0
    tmax = np.maximum(np.asarray(tmax, np.float64), np.asarray(tmin))
    tmin = np.asarray(tmin, np.float64)

    # calc_tair (no base/site lapse here: forcing already at cell elevation)
    tmean = (tmax + tmin) / 2.0
    tday = (tmax - tmean) * TDAYCOEF + tmean

    dtr = tmax - tmin
    sm_dtr = pulled_boxcar(dtr, 30)

    ann_prcp = np.maximum(prcp_cm.mean(-1) * 365.25, 1.0)  # [n_cell]
    parray = effective_annual_precip(prcp_cm)

    geo = solar_geometry(lat_deg, elev, steps_per_day, device)
    ydx = np.asarray(yday) - 1
    dayl = geo["daylength"][:, ydx]                    # [n_cell, n_day]
    ttmax0_d = geo["ttmax0"][:, ydx]
    flat_potrad_d = geo["flat_potrad"][:, ydx]

    # t_fmax (mtclim_vic.c:374-385)
    b = B0 + B1 * np.exp(-B2 * sm_dtr)
    t_fmax = 1.0 - 0.9 * np.exp(-b * np.power(dtr, C_PARAM))
    rain_day = prcp_cm * 10.0 > sw_prec_thresh
    t_fmax = np.where(rain_day, t_fmax * RAIN_SCALAR, t_fmax)

    pa = atm_pres(np.asarray(elev))[:, None]
    if swe_mm is not None:
        swe_cm = np.asarray(swe_mm) / 10.0
    else:
        # internal snowpack estimate for the radiation correction
        # (mtclim_vic.c:461-523 snowpack()): degree-day pack in cm driven by
        # tmin, two passes — the second re-initialized from the mean SWE of
        # all days sharing the start (or previous) yearday
        swe_cm = mtclim_snowpack(prcp_cm, tmin, np.asarray(yday))

    tdew = tmin.copy()
    pva = supplied_vp.copy() if supplied_vp is not None else svp_mtclim(tdew)

    def onetime(tdew, pva):
        """compute_srad_humidity_onetime (mtclim_vic.c:560-650)."""
        t_tmax = np.maximum(ttmax0_d + ABASE * pva, 1e-10)
        t_final = t_tmax * t_fmax
        tskc = np.sqrt(np.clip((1.0 - t_fmax) / 0.65, 0.0, 1.0))
        pdif = np.clip(-1.25 * t_final + 1.25, 0.0, 1.0)
        pdir = 1.0 - pdif
        srad1 = np.zeros_like(t_final)  # slope component (slope=0 for cells)
        srad2 = flat_potrad_d * t_final * pdif * (1.0 + DIF_ALB * 0.0)
        # sky_prop = 1 with no horizons -> srad2 = flat*t_final*pdif
        srad_dir = flat_potrad_d * t_final * pdir
        if mtclim_swe_corr:
            sc = np.where(swe_cm > 0.0,
                          (SC_INT + SC_SLOPE * swe_cm) * 1e6, 0.0)
            sc = np.where(dayl > 0.0, sc / np.maximum(dayl, 1.0), 0.0)
            sc = np.minimum(sc, 100.0)
        else:
            sc = 0.0
        srad = srad_dir + srad2 + sc
        if supplied_sw is not None:
            potrad = srad / np.maximum(t_final, 1e-10)
            t_fmax_new = np.where(potrad > 0,
                                  supplied_sw / np.maximum(potrad * t_tmax,
                                                           1e-10), t_fmax)
            srad_out = supplied_sw
        else:
            t_fmax_new = t_fmax
            srad_out = srad
        # PET-based dewpoint correction (Kimball et al. 1997)
        pet = calc_pet_mtclim(srad_out, tday, pa, dayl)
        ratio = pet / parray
        tmink = tmin + KELVIN
        tdewk = tmink * (-0.127 + 1.121 * (1.003 - 1.444 * ratio
                                           + 12.312 * ratio ** 2
                                           - 32.766 * ratio ** 3)
                         + 0.0006 * dtr)
        tdew_new = tdewk - KELVIN
        pva_new = svp_mtclim(tdew_new)
        return dict(srad=srad_out, tskc=tskc, pet=pet, tdew=tdew_new,
                    pva=pva_new, t_fmax=t_fmax_new)

    first = onetime(tdew, pva)
    ann_pet = first["pet"].mean(-1) * 365.25

    if supplied_vp is not None:
        pva_out = pva
        tskc = first["tskc"]
        srad = first["srad"]
    else:
        arid = ann_pet / ann_prcp >= 2.5
        if vp_iter == 1 or vp_iter == 3 or (vp_iter == 2 and arid.any()):
            max_iter = 100 if vp_iter == 3 else 2
            tdew_i, pva_i = first["tdew"], first["pva"]
            res = first
            for it in range(1, max_iter):
                prev = tdew_i
                res = onetime(tdew_i, pva_i)
                tdew_i, pva_i = res["tdew"], res["pva"]
                rmse = np.sqrt(np.mean((tdew_i - prev) ** 2))
                if rmse <= 0.01:
                    break
            if vp_iter == 2:
                # per-cell: arid cells iterate, others keep tdew=tmin
                pva_out = np.where(arid[:, None], pva_i, svp_mtclim(tmin))
            else:
                pva_out = pva_i
            srad, tskc = res["srad"], res["tskc"]
        else:
            pva_out = svp_mtclim(tmin)
            srad, tskc = first["srad"], first["tskc"]

    vpd = np.clip(svp_mtclim(tday) - pva_out, 0.0, None)
    return dict(srad=srad, tskc=tskc, pva=pva_out, vpd=vpd, tday=tday,
                daylength=dayl, radfract=geo["radfract"],
                flat_potrad=flat_potrad_d, tmax=tmax, tmin=tmin)
