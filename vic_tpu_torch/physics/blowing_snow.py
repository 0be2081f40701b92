"""Blowing-snow sublimation and transport (Pomeroy / Liston & Sturm).

Counterpart of `vic_tpu/physics/blowing_snow.py` (CalcBlowingSnow.c:56-799):
the probability of blowing snow, the threshold and saltation shear
velocities (a 24-step bisection), the saltation-layer sublimation and the
suspension-layer integrals as a fixed 16-point log-spaced trapezoid, over a
Laplace wind distribution of 10 probability increments, with the fetch
dependence and the -5e-5 kg/m^2/s floor. Returns the blowing mass flux
(kg/m^2/s, negative = loss) that feeds `snow.latent_heat_from_snow`.

`calc_blowing_snow` runs the `blowing_snow` kernel on CUDA tensors
(`csrc/blowing_snow.cu`: the snow lanes compacted, one thread a (snow
lane, wind increment) item) and `calc_blowing_snow_plain` on the CPU.
The quadrature nodes and the Laplace bounds' logarithms are
float32 tables given to both, so the kernel and its plain version read the
same constants.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import constants as c
from .. import kernels
from .evap import svp

KA_AIR = 0.0245187      # thermal conductivity of air (W/mK)
CSALT = 0.68
KIN_VIS = 1.3e-5
SETTLING = 0.3
NUMINCS = 10
MW = 18.0148e-3
R_GAS = 8.3143
G_STD = 9.80665
N_QUAD = 16
N_SHEAR_ITERS = 24
AREA = 1.0 / NUMINCS
# the 16 quadrature nodes as jax.numpy.linspace(0, 1, 16) comes out of XLA
# in float32: iota times the float32 reciprocal of 15, the last one exactly 1
QUAD_NODES = np.append(np.arange(N_QUAD - 1, dtype=np.float32)
                       * (np.float32(1.0) / np.float32(N_QUAD - 1)),
                       np.float32(1.0))


def laplace_log_arguments():
    """The arguments of the Laplace interval bounds' logarithms
    (CalcBlowingSnow.c:203-223): [NUMINCS] for each lower bound, then
    [NUMINCS] for each upper one; 1.0 where a bound is uo -/+ 9999."""
    lower, upper = [], []
    for p in range(NUMINCS):
        if p < NUMINCS // 2:
            lower.append(2.0 * p * AREA if p else 1.0)
            upper.append(2.0 * (p + 1) * AREA)
        else:
            lower.append(2.0 - 2.0 * p * AREA)
            upper.append(2.0 - 2.0 * (p + 1.0) * AREA
                         if p < NUMINCS - 1 else 1.0)
    return lower + upper


# tables() of each device, made at its first call there
_tables = {}


def tables(device):
    """(quadrature nodes [16], the bounds' float32 logarithms [20]) on
    `device`; the logarithms taken there, as the kernel's libm would. Made
    once a device, so a call uploads nothing."""
    device = torch.device(device)
    if device not in _tables:
        nodes = torch.as_tensor(QUAD_NODES, device=device)
        logs = torch.log(torch.tensor(laplace_log_arguments(),
                                      dtype=torch.float32, device=device))
        _tables[device] = (nodes, logs)
    return _tables[device]


def _const(value, like):
    """A float32 constant on `like`'s device."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def get_prob(tair, age_h, surf_water, u10):
    """Probability of blowing-snow occurrence (Li & Pomeroy 1997)."""
    age = torch.clamp(age_h, min=1e-3)
    dry = surf_water < 0.001
    mean_u = torch.where(dry, 11.2 + 0.365 * tair + 0.00706 * tair * tair
                         + 0.9 * torch.log(age), 21.0)
    sigma = torch.where(dry, 4.3 + 0.145 * tair + 0.00196 * tair * tair, 7.0)
    prob = 1.0 / (1.0 + torch.exp(math.sqrt(math.pi) * (mean_u - u10)
                                  / sigma))
    return torch.clamp(prob, 0.0, 1.0)


def get_thresh(tair, surf_water, z0):
    """Threshold shear velocity, variable form (get_thresh)."""
    ut10 = torch.where(surf_water < 0.001,
                       9.43 + 0.18 * tair + 0.0033 * tair * tair, 9.9)
    return c.VON_K * ut10 / torch.log(10.0 / z0)


def shear_residual(x, u_r):
    """get_shear's residual at shear velocity x for wind u_r at 10 m."""
    log_zr = torch.log(_const(2.0 * G_STD * 10.0 / 0.12, x))
    return log_zr + torch.log(1.0 / (x * x)) - c.VON_K * u_r / x


def solve_shear(u10, z0, utshear, n_iter: int = N_SHEAR_ITERS):
    """Saltation shear velocity (shear_stress:640-664): bisection between
    utshear and k*U10; log-profile fallback when no saltation solution.
    Returns (ushear, zo_salt)."""
    umin = utshear
    umax = c.VON_K * u10
    f_lo = shear_residual(umin, u10)
    f_hi = shear_residual(umax, u10)
    bracketed = f_lo * f_hi < 0.0
    lo, hi, flo = umin, umax, f_lo
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        fm = shear_residual(mid, u10)
        left = flo * fm <= 0.0
        lo, hi, flo = (torch.where(left, lo, mid), torch.where(left, mid, hi),
                       torch.where(left, flo, fm))
    ushear_root = 0.5 * (lo + hi)
    ushear_fb = c.VON_K * u10 / torch.log(10.0 / z0)
    ushear = torch.where(bracketed, ushear_root, ushear_fb)
    zo_salt = torch.where(bracketed, 0.12 * ushear * ushear / (2.0 * G_STD),
                          z0)
    return ushear, zo_salt


def sub_with_height(z, es, u10, zo_salt, eact, F, hsalt, phi_s, ushear):
    """Sublimation rate at height z, kg/m^3/s (sub_with_height:508-551);
    zo_salt is not read, as in the reference."""
    rrz = 4.6e-5 * torch.pow(z, -0.258)
    alphaz = 4.08 + 12.6 * z
    mz = ((4.0 / 3.0) * math.pi * c.ICE_DENSITY * (rrz * rrz * rrz)
          * (1.0 + 3.0 / alphaz + 2.0 / (alphaz * alphaz)))
    rmean = torch.pow(3.0 * mz / (4.0 * math.pi * c.ICE_DENSITY), 1.0 / 3.0)
    terminal_v = 1.1e7 * torch.pow(rmean, 1.8)
    fluct_v = 0.005 * torch.pow(u10, 1.36)
    vtz = terminal_v + 3.0 * fluct_v * math.cos(math.pi / 4.0)
    re = 2.0 * rmean * vtz / KIN_VIS
    nu = 1.79 + 0.606 * torch.sqrt(re)
    sigz = (eact / es - 1.0) * (1.019 + 0.027 * torch.log(z))
    dmdt = 2.0 * math.pi * rmean * sigz * nu / F
    psi_t = dmdt / mz
    temp = (0.5 * ushear * ushear) / (u10 * SETTLING)
    phi_t = phi_s * ((temp + 1.0)
                     * torch.pow(z / hsalt, -SETTLING / (c.VON_K * ushear))
                     - temp)
    return psi_t * phi_t


def _trapezoid(f, dt_q):
    """The pairwise trapezoid sum over the last axis, accumulated in order
    (as the kernel does), / 2 * dt_q."""
    total = f[..., 0] + f[..., 1]
    for k in range(2, f.shape[-1]):
        total = total + (f[..., k - 1] + f[..., k])
    return total / 2.0 * dt_q


def _sub_flux_one(u10, es, eact, air_dens, z0, fe, F, utshear, quad_nodes):
    """Sublimation and transport for one wind speed (CalcSubFlux, Liston &
    Sturm path with fetch). Returns (subflux kg/m^2/s, transport)."""
    ushear, zo_salt = solve_shear(u10, z0, utshear)
    saltating = ushear > utshear

    qsalt = ((CSALT * air_dens / G_STD) * (utshear / ushear)
             * torch.clamp(ushear * ushear - utshear * utshear, min=0.0))
    qsalt = qsalt * (1.0 + (500.0 / (3.0 * fe))
                     * (torch.exp(-3.0 * fe / 500.0) - 1.0))
    hsalt = 0.08436 * torch.pow(ushear, 1.27)
    particle = utshear * 2.8
    phi_s = qsalt / torch.clamp(hsalt * particle, min=1e-12)
    T = 0.5 * ushear * ushear / (u10 * SETTLING)
    ztop = hsalt * torch.pow(T / (T + 1.0), (c.VON_K * ushear) / (-SETTLING))

    # saltation layer: phi_s * psi_s * hsalt with psi_s at hsalt / 2, as the
    # reference composes it (CalcSubFlux:700-710)
    psi_s = sub_with_height(hsalt / 2.0, es, u10, zo_salt, eact, F, hsalt,
                            phi_s, ushear)
    sub_salt = phi_s * psi_s * hsalt

    # suspension layer: fixed log-spaced trapezoid of sub_with_height
    lo = torch.log(torch.clamp(hsalt, min=1e-4))
    hi = torch.log(torch.maximum(ztop, torch.clamp(hsalt, min=1e-4) * 1.0001))
    zs = torch.exp(lo[..., None] + (hi - lo)[..., None] * quad_nodes)
    fz = sub_with_height(zs, es[..., None], u10[..., None],
                         zo_salt[..., None], eact[..., None], F[..., None],
                         hsalt[..., None], phi_s[..., None],
                         ushear[..., None])
    dt_q = (hi - lo) / (N_QUAD - 1)
    sub_susp = _trapezoid(fz * zs, dt_q)

    undersat = eact < es
    subflux = torch.where(saltating & undersat, sub_salt + sub_susp, 0.0)
    # transport out of the domain (CalcSubFlux:731-739): saltation plus the
    # suspension-layer integral of transport_with_height, over the fetch
    trans_salt = qsalt * (1.0 - torch.exp(-3.0 * fe / 500.0))
    uz = ushear[..., None] * torch.log(
        zs / torch.clamp(zo_salt[..., None], min=1e-10)) / c.VON_K
    phi_tz = phi_s[..., None] * (
        (T[..., None] + 1.0)
        * torch.pow(zs / hsalt[..., None],
                    -SETTLING / (c.VON_K * ushear[..., None]))
        - T[..., None])
    trans_susp = _trapezoid(uz * phi_tz * zs, dt_q)
    transport = torch.where(saltating, (trans_salt + trans_susp) / fe, 0.0)
    return subflux, transport


def calc_blowing_snow_plain(*, dt_sec, tair, last_snow, surf_water_m,
                            wind_2m, ls, air_dens, pressure, eact, z0_snow,
                            zrh, snowdepth, lag_one, sigma_slope, tsnow,
                            is_bare, fetch, displacement, roughness,
                            quad_nodes, log_terms):
    """Plain version of the `blowing_snow` kernel: vic_tpu's
    calc_blowing_snow (blowing_snow.py:171-244), with the quadrature nodes
    and the Laplace bounds' logarithms from `tables`. pressure, zrh and
    tsnow are not read, as in the reference. Returns (flux kg/m^2/s,
    transport)."""
    age_h = torch.clamp(last_snow * dt_sec / 3600.0, min=1e-3)
    es = svp(tair)
    tk = tair + c.KELVIN
    ros = 0.622 * es / (287.0 * tk)
    diffus = 2.06e-5 * torch.pow(tk / 273.0, 1.75)
    F = ((ls / (KA_AIR * tk)) * (ls * MW / (R_GAS * tk) - 1.0)
         + 1.0 / (diffus * ros))

    wind10 = (wind_2m * torch.log(10.0 / z0_snow)
              / torch.log((2.0 + z0_snow) / z0_snow))
    fe = torch.where(is_bare, 1500.0, fetch)
    sslope = torch.where(is_bare, 2.0e-4, sigma_slope)
    ratio = (2.44 - 0.43 * lag_one) * sslope
    sigma_w = wind10 * ratio
    uo = wind10
    hv = 1.5 * displacement
    nd = (4.0 / 3.0) * roughness / torch.clamp(displacement, min=1e-6)
    utshear = get_thresh(tair, surf_water_m, z0_snow)
    sig_safe = torch.clamp(sigma_w, min=1e-10)
    shape = torch.broadcast_shapes(*(x.shape for x in (
        tair, wind10, sigma_w, snowdepth, fe, hv, eact, air_dens)))

    def e_hi(x):
        return torch.exp(torch.clamp(-(x - uo) / sig_safe, max=0.0))

    def e_lo(x):
        return torch.exp(torch.clamp((x - uo) / sig_safe, max=0.0))

    total = torch.zeros(shape, dtype=tair.dtype, device=tair.device)
    total_transport = torch.zeros_like(total)
    for p in range(NUMINCS):
        # Laplace-distribution interval bounds (CalcBlowingSnow.c:203-223);
        # the conditional mean selects by lower >= Uo, not by p (:230-237)
        log_lo, log_up = log_terms[p], log_terms[NUMINCS + p]
        if p == 0:
            lower = uo - 9999.0
            upper = uo + sigma_w * log_up
        elif p < NUMINCS // 2:
            lower = uo + sigma_w * log_lo
            upper = uo + sigma_w * log_up
        elif p < NUMINCS - 1:
            lower = uo - sigma_w * log_lo
            upper = uo - sigma_w * log_up
        else:
            lower = uo - sigma_w * log_lo
            upper = uo + 9999.0
        lower = torch.minimum(lower, upper)
        u10_hi = -0.5 * ((upper + sigma_w) * e_hi(upper)
                         - (lower + sigma_w) * e_hi(lower)) / AREA
        u10_lo = 0.5 * ((upper - sigma_w) * e_lo(upper)
                        - (lower - sigma_w) * e_lo(lower)) / AREA
        u10 = torch.clamp(torch.where(lower >= uo, u10_hi, u10_lo), 0.4, 25.0)
        uveg = torch.where(
            snowdepth < hv,
            u10 / torch.sqrt(1.0 + 170.0 * nd
                             * torch.clamp(hv - snowdepth, min=0.0)),
            u10)
        prob = get_prob(tair, age_h, surf_water_m, uveg)
        sub, trans = _sub_flux_one(u10, es, eact, air_dens, z0_snow, fe, F,
                                   utshear, quad_nodes)
        total = total + AREA * sub * prob
        total_transport = total_transport + AREA * trans * prob

    total = torch.where(snowdepth > 0.0, total, 0.0)
    total = torch.clamp(total, min=-5.0e-5)   # CalcBlowingSnow:246
    return total, torch.where(snowdepth > 0.0, total_transport, 0.0)


def calc_blowing_snow(**inputs):
    """Blowing-snow flux and transport of every lane: the `blowing_snow`
    kernel on CUDA tensors, `calc_blowing_snow_plain` on the CPU. Takes
    calc_blowing_snow_plain's keyword arguments but the two tables."""
    quad_nodes, log_terms = tables(inputs["tair"].device)
    solve = (calc_blowing_snow_plain if inputs["tair"].device.type == "cpu"
             else kernels.blowing_snow)
    return solve(quad_nodes=quad_nodes, log_terms=log_terms, **inputs)
