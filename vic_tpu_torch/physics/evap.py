"""Evapotranspiration: saturation vapor pressure, Penman-Monteith, canopy
interception evaporation, transpiration with soil-moisture stress, ARNO
bare-soil evaporation and the six PET reference surfaces.

Counterpart of `vic_tpu/physics/evap.py`, elementwise over any batch shape
with a trailing layer axis on per-layer quantities.
"""
from __future__ import annotations

import torch

from .. import constants as c
from ..constants import (A_SVP, B_SVP, C_SVP, CP_PM, HUGE_RESIST,
                         LAPSE_PM, PS_PM, SEC_PER_DAY)

_CLOSURE = 4000.0   # Pa (penman.c:40-42)
_RSMAX = 5000.0
_VPDMINFACTOR = 0.1


def svp(temp):
    """Saturated vapor pressure (Pa), svp.c:7-23 incl. the sub-freezing
    correction."""
    s = A_SVP * torch.exp((B_SVP * temp) / (C_SVP + temp))
    s = torch.where(temp < 0.0,
                    s * (1.0 + 0.00972 * temp + 0.000042 * temp * temp), s)
    return s * 1000.0


def svp_slope(temp):
    """d(svp)/dT (Pa/K)."""
    t = C_SVP + temp
    return (B_SVP * C_SVP) / (t * t) * svp(temp)


def calc_rc(rs, net_short, rgl, tair, vpd, lai, gsm_inv,
            ref_crop: bool = False):
    """Canopy resistance (s/m), penman.c:44-96."""
    rgl_safe = torch.where(rgl == 0.0, 1.0, rgl)
    f = net_short / rgl_safe
    dayfactor = torch.where(rs > 0.0, (1.0 + f) / (f + rs / _RSMAX), 1.0)
    tfactor = torch.clamp(0.08 * tair - 0.0016 * tair * tair, min=1e-10)
    vpdfactor = torch.clamp(1.0 - vpd / _CLOSURE, min=_VPDMINFACTOR)
    lai_safe = torch.where(lai == 0.0, 1.0, lai)
    gsm_safe = torch.where(gsm_inv == 0.0, 1.0, gsm_inv)
    if ref_crop:
        rc_full = rs / (lai_safe * 0.5)
    else:
        rc_full = torch.clamp(
            rs / (lai_safe * gsm_safe * tfactor * vpdfactor) * dayfactor,
            max=_RSMAX)
    return torch.where(rs == 0.0, 0.0,
                       torch.where(lai == 0.0, HUGE_RESIST,
                                   torch.where(gsm_inv == 0.0, _RSMAX,
                                               rc_full)))


def penman_coeffs(tair, elevation):
    """The (tair, elevation)-only Penman terms (slope, lv, gamma, r_air)."""
    slope = svp_slope(tair)
    h = 287.0 / 9.81 * ((tair + 273.15) + 0.5 * elevation * LAPSE_PM)
    pz = PS_PM * torch.exp(-elevation / h)
    lv = 2501000.0 - 2361.0 * tair
    gamma = 1628.6 * pz / lv
    r_air = 0.003486 * pz / (275.0 + tair)
    return slope, lv, gamma, r_air


def penman(tair, elevation, rad, vpd, ra, rc, rarc, coeffs=None):
    """Penman-Monteith evaporation in mm/day (penman.c:96-143)."""
    if coeffs is None:
        coeffs = penman_coeffs(tair, elevation)
    slope, lv, gamma, r_air = coeffs
    ra_safe = torch.clamp(ra, min=1e-10)
    evap = ((slope * rad + r_air * CP_PM * vpd / ra_safe)
            / (lv * (slope + gamma * (1.0 + (rc + rarc) / ra_safe)))
            * SEC_PER_DAY)
    # negative evap only as condensation when vpd < 0 (penman.c:138-141)
    return torch.where((vpd >= 0.0) & (evap < 0.0), 0.0, evap)


def transpiration_pre(moist, soil_ice, wcr, wpwp, root,
                      rmin, rgl, lai, net_short, vpd, air_temp, elevation):
    """The surface-temperature-independent part of the transpiration split:
    stress fractions, CASE 1/2 selection, canopy resistances, layer caps and
    Penman coefficients (canopy_evap.c:296-443)."""
    avail = torch.clamp(moist - soil_ice, min=0.0)
    has_root = root > 0.0
    avail_top = torch.where(has_root[..., :-1], avail[..., :-1], 0.0)
    moist1 = avail_top.sum(-1)
    wcr1 = torch.where(has_root[..., :-1], wcr[..., :-1], 0.0).sum(-1)
    moist2 = avail[..., -1]
    avail_eff = torch.cat([avail_top, moist2[..., None]], dim=-1)
    root_last = root[..., -1]

    case1 = (((moist1 >= wcr1) & (moist2 >= wcr[..., -1]) & (wcr1 > 0.0))
             | ((moist1 >= wcr1) & ((1.0 - root_last) >= 0.5))
             | ((moist2 >= wcr[..., -1]) & (root_last >= 0.5)))

    layer_wet = avail_eff >= wcr
    gsm_l = torch.clamp((avail_eff - wpwp) / torch.clamp(wcr - wpwp, min=1e-10),
                        0.0, 1.0)
    rc1 = calc_rc(rmin, net_short, rgl, air_temp, vpd, lai,
                  torch.ones_like(vpd))
    rc2 = calc_rc(rmin[..., None] * torch.ones_like(gsm_l),
                  net_short[..., None], rgl[..., None], air_temp[..., None],
                  vpd[..., None], lai[..., None], gsm_l)

    w1 = torch.where(layer_wet, root, gsm_l * root)
    spare_frac = torch.where(layer_wet, 0.0, root * (1.0 - gsm_l)).sum(-1)
    root_sum = 1.0 - torch.where(layer_wet, 0.0, root).sum(-1)
    root_sum = torch.where(root_sum <= 0.0, 1.0, root_sum)
    w1 = w1 + torch.where(layer_wet, root * (spare_frac / root_sum)[..., None],
                          0.0)

    cap_icy = torch.where(soil_ice >= wpwp, avail, moist - wpwp)
    cap = torch.clamp(torch.where(soil_ice > 0.0, cap_icy, moist - wpwp),
                      min=0.0)
    return dict(case1=case1, gsm_l=gsm_l, rc1=rc1, rc2=rc2, w1=w1, cap=cap,
                coeffs=penman_coeffs(air_temp, elevation))


def transpiration(moist, soil_ice, wcr, wpwp, root, rmin, rgl, lai, rarc,
                  rad, net_short, vpd, air_temp, elevation, ra,
                  f, wdew_frac_pow, delta_t, pre=None):
    """Transpiration split over soil layers (canopy_evap.c:218-445).
    Returns layerevap [..., n_layer] in mm/step."""
    if pre is None:
        pre = transpiration_pre(moist, soil_ice, wcr, wpwp, root, rmin, rgl,
                                lai, net_short, vpd, air_temp, elevation)
    coeffs = pre["coeffs"]
    trans_factor = 1.0 - f * wdew_frac_pow

    evap1 = (penman(air_temp, elevation, rad, vpd, ra, pre["rc1"], rarc,
                    coeffs=coeffs)
             * delta_t / SEC_PER_DAY * trans_factor)
    layerevap1 = evap1[..., None] * pre["w1"]

    gsm_l = pre["gsm_l"]

    def cl(x):
        return x[..., None]

    layerevap2 = torch.where(
        gsm_l > 0.0,
        penman(cl(air_temp), cl(elevation), cl(rad), cl(vpd), cl(ra),
               pre["rc2"], cl(rarc), coeffs=tuple(cl(t) for t in coeffs))
        * delta_t / SEC_PER_DAY * root * trans_factor[..., None],
        0.0)

    layerevap = torch.where(pre["case1"][..., None], layerevap1, layerevap2)
    return torch.minimum(torch.clamp(layerevap, min=0.0), pre["cap"])


def wet_canopy_evap(wdew, prec, wdmax, rarc, rad, vpd, air_temp, elevation,
                    ra, delta_t, coeffs=None):
    """Interception evaporation of the wet canopy, canopy_evap.c:46-177
    (the whole of canopy_evap with CALC_EVAP=FALSE). Returns (canopyevap,
    f, throughfall, wdew_new) in mm/step; f is the fraction of the step
    the canopy evaporation used."""
    wdmax_safe = torch.clamp(wdmax, min=1e-10)
    throughfall = torch.clamp(wdew - wdmax, min=0.0)
    wdew_c = torch.minimum(wdew, wdmax)

    # wet-canopy evaporation at rc = 0 (penman.c:55)
    canopyevap = (torch.pow(torch.clamp(wdew_c / wdmax_safe, 0.0, 1.0),
                            2.0 / 3.0)
                  * penman(air_temp, elevation, rad, vpd, ra,
                           torch.zeros_like(vpd), rarc, coeffs=coeffs)
                  * delta_t / SEC_PER_DAY)

    storage = wdew_c + prec if delta_t == SEC_PER_DAY else wdew_c
    f = torch.where(canopyevap > 0.0,
                    torch.clamp(storage / torch.clamp(canopyevap, min=1e-20),
                                max=1.0),
                    1.0)
    canopyevap = canopyevap * f

    wdew_new = torch.clamp(wdew_c + prec - canopyevap, min=0.0)
    over = torch.clamp(wdew_new - wdmax, min=0.0)
    return canopyevap, f, throughfall + over, wdew_new - over


def canopy_evap(moist, soil_ice, wcr, wpwp, root, wdew, prec, wdmax,
                rmin, rgl, lai, rarc, rad, net_short, vpd, air_temp,
                elevation, ra, delta_t, pre=None):
    """Canopy interception evaporation + transpiration
    (canopy_evap.c:46-213). Returns (evap_total, layerevap [..., nl],
    canopyevap, throughfall, wdew_new), all mm/step."""
    canopyevap, f, throughfall, wdew_new = wet_canopy_evap(
        wdew, prec, wdmax, rarc, rad, vpd, air_temp, elevation, ra, delta_t,
        coeffs=pre["coeffs"] if pre is not None else None)
    # (Wdew/Wdmax)^(2/3) from the START-of-step dew, unclipped
    # (canopy_evap.c:153,193)
    wdew_frac_pow = torch.pow(
        torch.clamp(wdew, min=0.0) / torch.clamp(wdmax, min=1e-10), 2.0 / 3.0)
    layerevap = transpiration(moist, soil_ice, wcr, wpwp, root, rmin, rgl,
                              lai, rarc, rad, net_short, vpd, air_temp,
                              elevation, ra, f, wdew_frac_pow, delta_t,
                              pre=(pre or {}).get("transp"))
    return (canopyevap + layerevap.sum(-1), layerevap, canopyevap,
            throughfall, wdew_new)


def compute_pot_evap(tair, vpd, shortwave, net_longwave, elevation,
                     dt_hours, ra_surface, ra_overstory, veg_rmin, veg_rarc,
                     veg_rgl, veg_lai, veg_albedo, veg_overstory):
    """Potential evaporation (mm/step) of the 6 reference surfaces
    (compute_pot_evap.c:8-87)."""
    out = {}
    names = ("satsoil", "h2osurf", "short", "tall", "natveg", "vegnocr")
    for i, name in enumerate(names):
        if i < 4:
            def full(v):
                return torch.full_like(tair, v)
            rs, rarc, rgl = (full(c.REF_VEG_RMIN[i]), full(c.REF_VEG_RARC[i]),
                             full(c.REF_VEG_RGL[i]))
            lai, albedo = full(c.REF_VEG_LAI[i]), full(c.REF_VEG_ALBEDO[i])
            ra = ra_surface
        else:
            rs = torch.zeros_like(veg_rmin) if i == 5 else veg_rmin
            rarc, rgl, lai, albedo = veg_rarc, veg_rgl, veg_lai, veg_albedo
            ra = torch.where(veg_overstory, ra_overstory, ra_surface)
        net_short = (1.0 - albedo) * shortwave
        net_rad = net_short + net_longwave
        rc = calc_rc(rs, net_short, rgl, tair, vpd, lai, torch.ones_like(tair),
                     ref_crop=bool(c.REF_VEG_REF_CROP[i]))
        out[name] = penman(tair, elevation, net_rad, vpd, ra, rc, rarc) \
            * dt_hours / 24.0
    return out


def build_evap_pre(moist, soil_ice, wcr, wpwp, root, max_moist0, b_infilt,
                   rmin, rgl, lai, net_short, vpd, air_temp, elevation):
    """Every surface-temperature-independent ET precomputation of one
    moisture column, built once per step and reused by each Brent iterate."""
    return dict(
        coeffs=penman_coeffs(air_temp, elevation),
        arno_beta=arno_beta(moist[..., 0], soil_ice[..., 0], max_moist0,
                            b_infilt),
        transp=transpiration_pre(moist, soil_ice, wcr, wpwp, root, rmin, rgl,
                                 lai, net_short, vpd, air_temp, elevation))


def arno_beta(moist0, soil_ice0, max_moist0, b_infilt):
    """ARNO beta: saturated-area fraction + 30-term series in
    x = deficit^(1/(b+1)) (arno_evap.c:126-196)."""
    moist = torch.minimum(torch.clamp(moist0 - soil_ice0, min=0.0), max_moist0)
    ratio = torch.clamp(1.0 - moist / max_moist0, 0.0, 1.0)
    b_safe = torch.where(b_infilt == 0.0, 1.0, b_infilt)
    x = torch.where(ratio != 0.0, torch.pow(ratio, 1.0 / (b_safe + 1.0)), 0.0)
    as_frac = 1.0 - torch.where(x != 0.0, torch.pow(x, b_safe), 0.0)
    k = torch.arange(1, 31, dtype=moist.dtype, device=moist.device)
    terms = b_infilt[..., None] * torch.pow(x[..., None], k) / (
        b_infilt[..., None] + k)
    dummy = 1.0 + terms.sum(-1)
    return as_frac + (1.0 - as_frac) * (1.0 - x) * dummy


def arno_evap(moist0, soil_ice0, max_moist0, depth0, resid_moist0,
              b_infilt, rad, air_temp, vpd, elevation, ra, delta_t,
              beta=None, coeffs=None):
    """ARNO bare-soil evaporation from the top layer (arno_evap.c:61-228),
    mm/step."""
    moist = torch.minimum(torch.clamp(moist0 - soil_ice0, min=0.0), max_moist0)
    zero = torch.zeros_like(ra)
    epot = penman(air_temp, elevation, rad, vpd, ra, zero, zero,
                  coeffs=coeffs) * delta_t / SEC_PER_DAY
    if beta is None:
        beta = arno_beta(moist0, soil_ice0, max_moist0, b_infilt)
    evap = epot * beta
    cap = torch.clamp(moist - resid_moist0 * depth0 * 1000.0, min=0.0)
    return torch.where(evap > 0.0, torch.minimum(evap, cap), evap)
