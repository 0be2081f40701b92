"""Daily-to-subdaily forcing disaggregation and model-forcing assembly, a
copy of `vic_tpu/forcing/disagg.py`: the reference forcing orchestrator
(initialize_atmos.c:7-1349), in float64 numpy on the host:
- sub-daily air temperature via Hermite spline through (tminhour, Tmin) /
  (tmaxhour, Tmax) knots with zero slope at the extrema
  (calc_air_temperature.c:20-198 hermite/HourlyT; hours from the radiation
  cycle, set_max_min_hour);
- shortwave split across sub-steps by the MTCLIM radiation-fraction profile
  (tiny_radfract, mtclim_wrapper.c:53-67);
- vapor pressure daily-constant or linearly interpolated (VP_INTERP), VPD
  recomputed per sub-step (initialize_atmos.c:1067-1192);
- longwave estimated per sub-step when unsupplied (calc_longwave.c clear-sky
  x cloud options);
- pressure/density from elevation and air temperature (PLAPSE,
  initialize_atmos.c:905-1010).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..constants import KELVIN, LAPSE_PM, RD, STEFAN_B, G as GRAV
from .mtclim import mtclim_run, svp_mtclim


def calc_longwave(tskc, air_temp, vp_pa, lw_type: int = 0, lw_cloud: int = 1):
    """Longwave from cloud fraction/temp/vp (calc_longwave.c:8-74).
    lw_type: 0 TVA..5 PRATA; lw_cloud: 0 BRAS, 1 DEARDORFF."""
    tk = air_temp + KELVIN
    vp_mbar = vp_pa / 100.0
    if lw_type == 0:
        em = 0.740 + 0.0049 * vp_mbar
    elif lw_type == 1:
        em = 0.68 + 0.036 * np.power(np.maximum(vp_mbar, 0.0), 0.5)
    elif lw_type == 2:
        em = 1.24 * np.power(np.maximum(vp_mbar / tk, 1e-10), 0.14285714)
    elif lw_type == 3:
        em = 1.08 * (1.0 - np.exp(-np.power(np.maximum(vp_mbar, 1e-10),
                                            tk / 2016.0)))
    elif lw_type == 4:
        em = 0.7 + 5.95e-5 * vp_mbar * np.exp(1500.0 / tk)
    else:
        x = 46.5 * vp_mbar / tk
        em = 1.0 - (1.0 + x) * np.exp(-np.sqrt(1.2 + 3.0 * x))
    if lw_cloud == 1:  # Deardorff
        cf = 0.65 * tskc * tskc
        emissivity = cf * 1.0 + (1.0 - cf) * em
    else:  # Bras
        emissivity = (1.0 + 0.17 * tskc * tskc) * em
    return emissivity * STEFAN_B * tk ** 4


def set_max_min_hour(radfract_daily: np.ndarray) -> tuple:
    """Times of Tmin/Tmax from the radiation cycle
    (calc_air_temperature.c set_max_min_hour). radfract_daily:
    [n_cell, n_day, 24] hourly radiation fractions. Returns (tmin_h, tmax_h)
    int arrays [n_cell, n_day]."""
    pos = radfract_daily > 0.0
    n_cell, n_day, nh = pos.shape
    # risehour: last hour in 0..11 where rad>0 and previous <=0
    prev = np.concatenate([np.zeros((n_cell, n_day, 1), bool),
                           pos[..., :-1]], axis=-1)
    rise_candidates = pos & ~prev
    hours = np.arange(nh)
    rise = np.where(rise_candidates[..., :12],
                    hours[:12], -1).max(-1)
    set_candidates = (~pos) & prev
    sethr = np.where(set_candidates[..., 12:], hours[12:], 99).min(-1)
    ok = (rise >= 0) & (sethr < 99)
    tmax_h = np.where(ok, (0.67 * (sethr - rise) + rise).astype(int), 14)
    tmin_h = np.where(ok, rise - 1, 2)
    return tmin_h, tmax_h


def hourly_temperature(tmin, tmax, tmin_h, tmax_h, steps_per_day: int
                       ) -> np.ndarray:
    """Hermite spline through alternating Tmin/Tmax knots with zero slope
    (HourlyT, calc_air_temperature.c:72-144). Inputs [n_cell, n_day];
    returns [n_cell, n_day*steps_per_day]."""
    n_cell, n_day = tmin.shape
    dt_h = 24.0 / steps_per_day
    nk = 2 * n_day + 2
    xk = np.zeros((n_cell, nk))
    yk = np.zeros((n_cell, nk))
    base = np.arange(n_day) * 24.0
    first_min = tmin_h <= tmax_h
    x1 = np.where(first_min, tmin_h, tmax_h) + base
    y1 = np.where(first_min, tmin, tmax)
    x2 = np.where(first_min, tmax_h, tmin_h) + base
    y2 = np.where(first_min, tmax, tmin)
    xk[:, 1:-1:2] = x1
    yk[:, 1:-1:2] = y1
    xk[:, 2:-1:2] = x2
    yk[:, 2:-1:2] = y2
    xk[:, 0] = xk[:, 2] - 24.0
    yk[:, 0] = yk[:, 2]
    xk[:, -1] = xk[:, -3] + 24.0
    yk[:, -1] = yk[:, -3]

    t = np.arange(n_day * steps_per_day) * dt_h
    out = np.empty((n_cell, len(t)))
    for ci in range(n_cell):
        idx = np.clip(np.searchsorted(xk[ci], t, "right") - 1, 0, nk - 2)
        xa, xb = xk[ci, idx], xk[ci, idx + 1]
        ya, yb = yk[ci, idx], yk[ci, idx + 1]
        h = np.maximum(xb - xa, 1e-9)
        s = np.clip((t - xa) / h, 0.0, 1.0)
        h01 = -2.0 * s ** 3 + 3.0 * s ** 2
        out[ci] = ya * (1.0 - h01) + yb * h01   # zero end slopes
    return out


def pressure_density(air_temp, elevation, plapse: bool = True,
                     density=None):
    """Pressure and density (initialize_atmos.c:905-1010)."""
    if density is not None:
        if plapse:
            pressure = (KELVIN + air_temp) * density * RD
        else:
            pressure = (275.0 + air_temp) * density / 0.003486
        return pressure, density
    if plapse:
        pressure = 101300.0 * np.exp(
            -elevation * GRAV
            / (RD * (KELVIN + air_temp + 0.5 * elevation * LAPSE_PM)))
    else:
        pressure = np.full_like(air_temp, 95500.0)
    if plapse:
        dens = 0.003486 * pressure / (275.0 + air_temp)
    else:
        dens = 3.486 * pressure / 1000.0 / (275.0 + air_temp)
    return pressure, dens


# accumulation-type forcings (mm/step): split on refinement, sum on
# aggregation; everything else is intensive (repeat / mean)
_EXTENSIVE = {"PREC", "RAINF", "SNOWF", "CRAINF", "CSNOWF", "LSRAINF",
              "LSSNOWF", "CHANNEL_IN"}


def resample_forcing_series(v: np.ndarray, name: str, file_dt: int,
                            model_dt: int) -> np.ndarray:
    """Re-time a supplied [n_rec_file, n_cell] series from its file time step
    to the model step (initialize_atmos.c fills the NF sub-step slots of each
    atmos array from whatever resolution was supplied; with SNOW_STEP <
    FORCE_DT the coarse values repeat across sub-steps and accumulations
    split evenly — uniform disaggregation like initialize_atmos.c's
    prec/wind handling)."""
    if file_dt == model_dt:
        return v
    if file_dt > model_dt:                    # refine: coarse -> fine
        nf = file_dt // model_dt
        out = np.repeat(v, nf, axis=0)
        return out / nf if name in _EXTENSIVE else out
    na = model_dt // file_dt                  # aggregate: fine -> coarse
    n = (v.shape[0] // na) * na
    w = v[:n].reshape(-1, na, *v.shape[1:])
    return w.sum(1) if name in _EXTENSIVE else w.mean(1)



def build_model_forcing(supplied: Dict[str, np.ndarray], gp, domain,
                        timeaxis, device="cpu") -> Dict[str, np.ndarray]:
    """Assemble the model-step forcing dict from whatever was supplied
    (initialize_atmos.c decision tree, simplified to the two supported
    supply patterns). device: where MTCLIM's solar geometry runs."""
    soil = domain.soil
    n_rec = timeaxis.nrecs
    n_cell = soil.n_cell
    elev = soil.elevation[None, :]

    def have(k):
        return k in supplied and supplied[k] is not None

    # ALMA_INPUT unit conversions (initialize_atmos.c:255-300): precip rates
    # mm/s -> mm/step, temperatures K -> C, pressure already Pa
    supplied = dict(supplied)
    if gp.alma_input:
        dt_s = gp.dt * 3600.0
        for k in ("PREC", "RAINF", "SNOWF", "CRAINF", "CSNOWF", "LSRAINF",
                  "LSSNOWF"):
            if have(k):
                supplied[k] = supplied[k] * dt_s
        for k in ("AIR_TEMP", "TMAX", "TMIN"):
            if have(k):
                supplied[k] = supplied[k] - 273.15
    else:
        # VIC-convention forcings supply pressures in kPa
        # (initialize_atmos.c:287-299 kPa2Pa)
        for k in ("PRESSURE", "VP"):
            if have(k):
                supplied[k] = supplied[k] * 1000.0

    # --- pattern A: AIR_TEMP + PREC at the model step ---------------------
    if have("AIR_TEMP") and have("PREC"):
        air_temp = supplied["AIR_TEMP"][:n_rec]
        prec = supplied["PREC"][:n_rec]
        wind = supplied["WIND"][:n_rec] if have("WIND") else \
            np.full((n_rec, n_cell), 1.5)
        if have("VP"):
            vp = supplied["VP"][:n_rec]
        elif have("REL_HUMID"):
            vp = supplied["REL_HUMID"][:n_rec] / 100.0 * svp_mtclim(air_temp)
        elif have("QAIR") and have("PRESSURE"):
            vp = supplied["QAIR"][:n_rec] * supplied["PRESSURE"][:n_rec] \
                / 0.62196351
        else:
            vp = svp_mtclim(air_temp) * 0.7
        if have("PRESSURE"):
            # supplied pressure (Pa after unit conversion above); density
            # follows the reference's rho = 3.486 p[kPa]/(275+T)
            pressure = supplied["PRESSURE"][:n_rec]
            density = 0.003486 * pressure / (275.0 + air_temp)
        else:
            pressure, density = pressure_density(
                air_temp, elev, gp.plapse,
                supplied.get("DENSITY", [None])[:n_rec] if have("DENSITY")
                else None)
        if have("SHORTWAVE"):
            sw = supplied["SHORTWAVE"][:n_rec]
        else:
            sw = np.maximum(200.0 + 0.0 * air_temp, 0.0)  # crude fallback
        if have("LONGWAVE"):
            lw = supplied["LONGWAVE"][:n_rec]
        else:
            tskc = supplied["TSKC"][:n_rec] if have("TSKC") else \
                np.full_like(air_temp, 0.5)
            lw = calc_longwave(tskc, air_temp, vp, int(gp.lw_type),
                               int(gp.lw_cloud))
        return dict(prec=prec, air_temp=air_temp, wind=wind, shortwave=sw,
                    longwave=lw, pressure=pressure, vp=vp, density=density)

    # --- pattern B: daily TMAX/TMIN/PREC -> MTCLIM + disagg ---------------
    if not (have("TMAX") and have("TMIN") and have("PREC")):
        raise ValueError(
            "forcing must supply AIR_TEMP+PREC (model step) or "
            "TMAX+TMIN+PREC (daily)")
    steps_per_day = 24 // gp.dt if gp.dt <= 24 else 1
    n_day = n_rec * gp.dt // 24

    # Local-solar-time shift (initialize_atmos.c:125,150-225,361-372):
    # MTCLIM and the disaggregation run on a LOCAL solar-time hourly axis;
    # the model record axis is in the forcing time zone (soil time_zone_lng,
    # stored as soil.off_gmt in DEGREES of longitude). Each model hour h
    # samples local hour h - hour_offset with hour_offset =
    # round((time_zone_lng - lng)*24/360), per cell. We generate the local
    # series with one pad day on each side, gather per cell, and aggregate
    # hourly windows into model steps (the reference's SNOW_STEP averaging
    # loops, initialize_atmos.c:406-430).
    hour_offset = np.rint(
        (np.asarray(soil.off_gmt) - np.asarray(soil.lng)) * 24.0 / 360.0
    ).astype(np.int64)
    hour_offset = np.clip(hour_offset, -23, 23)

    def pad_daily(v_d):
        # edge-replicate one day at each end (the reference clamps the
        # daily index at the series edges, initialize_atmos.c:361-366)
        return np.concatenate([v_d[:, :1], v_d, v_d[:, -1:]], axis=1)

    tmax_d = pad_daily(supplied["TMAX"][:n_day].T)    # [n_cell, n_day+2]
    tmin_d = pad_daily(supplied["TMIN"][:n_day].T)
    prec_d = pad_daily(supplied["PREC"][:n_day].T)
    # yearday series of the padded daily axis
    day_stride = 24 // gp.dt
    ydays = np.asarray(timeaxis.day_in_year[::day_stride][:n_day])
    yd0 = ydays[0] - 1 if ydays[0] > 1 else 365
    yd1 = ydays[-1] + 1 if ydays[-1] < 365 else 1
    ydays_p = np.concatenate([[yd0], ydays, [yd1]])
    n_day_p = n_day + 2

    mt = mtclim_run(soil.lat, soil.elevation, ydays_p, prec_d, tmax_d,
                    tmin_d, sw_prec_thresh=gp.sw_prec_thresh,
                    mtclim_swe_corr=gp.mtclim_swe_corr,
                    vp_iter=int(gp.vp_iter), steps_per_day=24,
                    device=device)

    # hourly radiation cycle (always at 24/day)
    rf24 = mt["radfract"][:, ydays_p - 1, :]        # [n_cell, n_day_p, 24]

    # mtclim_to_vic radiation shift quirk (mtclim_wrapper.c:195-215):
    # hourlyrad is built by sampling the day's radfract at (local_hour -
    # hour_offset) with WRAP WITHIN THE SAME DAY, using the REAL-VALUED
    # offset at SRADDT resolution.  Because the atmos fill loops
    # (initialize_atmos.c:806-816) apply the integer hour shift AGAIN, the
    # radiation ends up displaced by ~2*hour_offset on the model axis —
    # and the tmin/tmax hours (set_max_min_hour on the shifted hourlyrad,
    # initialize_atmos.c:830) inherit one extra shift too.  Fractional
    # shifts are linear mixes of adjacent hourly bins (the tiny-step sum).
    off_real = (np.asarray(soil.off_gmt) - np.asarray(soil.lng)) * 24.0 / 360.0
    jj = np.arange(24)[None, :]
    pos = np.mod(jj - off_real[:, None], 24.0)      # [n_cell, 24]
    j0 = np.floor(pos).astype(np.int64) % 24
    w_frac = (pos - np.floor(pos))[:, None, :]
    take = lambda idx: np.take_along_axis(
        rf24, np.broadcast_to(idx[:, None, :], rf24.shape), axis=-1)
    rf24_s = (1.0 - w_frac) * take(j0) + w_frac * take((j0 + 1) % 24)

    tmin_h, tmax_h = set_max_min_hour(rf24_s)

    # hourly LOCAL series, [n_cell, n_day_p*24]
    air_h = hourly_temperature(tmin_d, tmax_d, tmin_h, tmax_h, 24)
    daily_j = mt["srad"] * mt["daylength"]          # [n_cell, n_day_p]
    sw_h = (daily_j[..., None] * rf24_s / 3600.0).reshape(n_cell, -1)
    vp_h = np.repeat(mt["pva"], 24, axis=1)
    tskc_h = np.repeat(mt["tskc"], 24, axis=1)

    # per-cell shift onto the forcing time axis; hour h of the run maps to
    # local index 24 + h - hour_offset
    n_hours = n_day * 24
    idx = (24 - hour_offset)[:, None] + np.arange(n_hours)[None, :]

    def localize(h):
        return np.take_along_axis(h, idx, axis=1)    # [n_cell, n_hours]

    def to_steps(h, extensive=False):
        w = localize(h).reshape(n_cell, n_rec, gp.dt)
        return (w.sum(-1) if extensive else w.mean(-1)).T  # [n_rec, n_cell]

    air_temp = to_steps(air_h)
    sw = to_steps(sw_h)
    vp = to_steps(vp_h)
    tskc = to_steps(tskc_h)

    # daily precip: the reference books each whole sub-step at the LOCAL
    # day of the sub-step's STARTING hour (initialize_atmos.c:453-463:
    # idx = hour/24 with hour = step start - hour_offset_int (+24); the
    # day's total divides evenly, 1/(NF*stepspday) per sub-step) — no
    # hourly splitting across local midnight inside a window
    h0 = np.arange(n_rec) * gp.dt                           # model start hour
    pday = (h0[None, :] - hour_offset[:, None] + 24) // 24  # padded-axis day
    pday = np.clip(pday, 0, n_day + 1).astype(np.int64)
    prec = (np.take_along_axis(prec_d, pday, axis=1)
            * (gp.dt / 24.0)).T                             # [n_rec, n_cell]

    def fit(name):
        # daily-supplied extras on the sub-daily model axis: uniform repeat
        # (initialize_atmos.c wind handling)
        v = supplied[name]
        if v.shape[0] < n_rec and n_rec % v.shape[0] == 0:
            v = resample_forcing_series(v, name,
                                        gp.dt * (n_rec // v.shape[0]), gp.dt)
        return v[:n_rec]

    wind = fit("WIND") if have("WIND") else np.full((n_rec, n_cell), 1.5)
    if have("LONGWAVE"):
        lw = fit("LONGWAVE")
    else:
        lw = calc_longwave(tskc, air_temp, vp, int(gp.lw_type),
                           int(gp.lw_cloud))
    pressure, density = pressure_density(air_temp, elev, gp.plapse)
    return dict(prec=prec, air_temp=air_temp, wind=wind, shortwave=sw,
                longwave=lw, pressure=pressure, vp=vp, density=density)
