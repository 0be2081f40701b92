"""Lake / wetland model: multi-layer lake temperature, ice and water balance.

Counterpart of `vic_tpu/physics/lake.py` (lakes.eb.c, ice_melt.c,
IceEnergyBalance.c, water_energy_balance.c, water_under_ice.c,
initialize_lake.c), one lake per cell with MAX_LAKE_NODES layers, with
the blowing-snow flux over lake ice under BLOWING. Every function repeats
vic_tpu's arithmetic in its order: integer powers as the products
lax.integer_pow forms, and every sum over the layer axis in index order
(`_isum`), as XLA's CPU reduction runs it.

The lake's loops run on the card as CUDA kernels; each call site
takes the plain version beside it on CPU tensors and the kernel on CUDA
tensors:

- `depth_from_volume` -> `depth_from_volume_plain` / K13 `lake_depth`;
- the water balance after solve_lake -> `lake_water_balance_plain` /
  `lake_water_balance` (its depths on K13's basin code);
- the open-water fixed point and the mix `solve_lake` applies to it ->
  `lake_open_water_plain` (`water_energy_balance` + `tracer_mixer`) / K10
  `lake_open_water`;
- `water_under_ice` -> `water_under_ice_plain` / K11 `lake_under_ice`;
- `lake_ice_melt` (the snow over the ice and its Brent solve) ->
  `lake_ice_melt_plain` (its Brent `lake_ice_brent_plain`) / K12
  `lake_ice_melt`, the whole function in one launch;
- under BLOWING, the blowing-snow flux over lake ice ->
  `blowing_snow.calc_blowing_snow_plain` / K8 `blowing_snow` on the
  [n_cell] lake lanes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .. import constants as c
from .. import kernels
from ..ops.rootfind import MAXTRIES, batched_brent
from ..ops.tridiag import thomas_solve
from ..tensors import TensorDataclass
from .blowing_snow import calc_blowing_snow
from .snow import latent_heat_from_snow, snow_albedo, stability_correction

MAX_LAKE_NODES = c.MAX_LAKE_NODES

# LAKE.h:36-63
DM = 1.38889e-07     # molecular diffusivity of water (m^2/s)
EMH2O = 0.98
RHOSNOW = 250.0      # snow density for depth conversions over lake ice
RHOICE = 917.0
FRACMIN = 0.10       # min ice thickness (m)
FRACLIM = 0.02       # lower limit on fractional ice cover
SNOWCRIT = 0.05      # snow depth for full snow albedo (m)
ZWATER = 0.0045      # open-water roughness (m)
ZSNOW = 0.005        # snow-on-ice roughness (m)
CONDI = 2.3          # thermal conductivity of ice (W/m/K)
CONDS = 0.7          # thermal conductivity of snow (W/m/K)
LAMISW = 1.5         # SW extinction in ice, visible (1/m)
LAMILW = 20.0        # SW extinction in ice, NIR (1/m)
LAMSSW = 6.0         # SW extinction in snow, visible (1/m)
LAMSLW = 20.0        # SW extinction in snow, NIR (1/m)
LAMWSW = 0.3         # SW extinction in water, visible (1/m)
LAMWLW = 1.4         # SW extinction in water, NIR (1/m)
A1 = 0.7             # fraction of SW in visible band
A2 = 0.3             # fraction of SW in NIR band
MAX_SURFACE_LAKE = 0.6   # surface-layer cap (m), LAKE.h:40
EB_MAX_ITER = 50         # water_energy_balance.c / water_under_ice.c MAX_ITER
EB_EPS = 1.0e-4
DEPTH_ITERS = 30         # bisection steps of depth_from_volume
MIX_SWEEPS = MAX_LAKE_NODES  # red-black sweeps of tracer_mixer
# calc_blowing_snow's hard-wired frozen-pond parameters over lake ice
# (ice_melt.c:264-288): 10-cm protrusions
FROZEN_POND = dict(lag_one=0.95, sigma_slope=0.005, fetch=100.0,
                   displacement=0.067, roughness=0.0123)

W = torch.where


def _isum(x):
    """Sum over the last axis in index order."""
    s = x[..., 0]
    for k in range(1, x.shape[-1]):
        s = s + x[..., k]
    return s


@dataclass
class LakeParams(TensorDataclass):
    """Per-cell lake configuration (lake_con_struct, LAKE.h). z/basin: node
    depth (m above the lake bottom) and area (m^2) profiles, index 0 = the
    lake surface at max depth, [c, NN+1]."""
    has_lake: torch.Tensor     # [c] bool
    numnod: torch.Tensor       # [c] int32
    z: torch.Tensor
    basin: torch.Tensor
    mindepth: torch.Tensor
    minvolume: torch.Tensor
    maxvolume: torch.Tensor
    maxdepth: torch.Tensor
    wfrac: torch.Tensor
    depth_in: torch.Tensor
    rpercent: torch.Tensor
    cl0: torch.Tensor


@dataclass
class LakeState(TensorDataclass):
    """Prognostic lake state (lake_var_struct + its snow); snow stores in m
    over the LAKE area (see vic_tpu/physics/lake.py:117)."""
    volume: torch.Tensor
    temp: torch.Tensor         # [c, NN]
    ice_water_eq: torch.Tensor
    ice_area: torch.Tensor
    ice_height: torch.Tensor
    swe: torch.Tensor
    tempi: torch.Tensor
    surf_temp: torch.Tensor
    pack_temp: torch.Tensor
    surf_water: torch.Tensor
    pack_water: torch.Tensor
    salbedo: torch.Tensor
    last_snow: torch.Tensor
    melting: torch.Tensor      # [c] bool


def make_lake_params(soil, gp, depth_in=None, frac=0.1) -> dict:
    """Synthetic parabolic-basin defaults (vic_tpu/physics/lake.py:140), as
    {field: numpy array} in float64 like vic_tpu's; carry them onto a
    device with prepare.lake_params_from_numpy."""
    n_cell = soil.cell_area.shape[0]
    NN = MAX_LAKE_NODES
    maxdepth = np.full(n_cell, 10.0)
    area0 = np.asarray(soil.cell_area) * frac
    z = np.zeros((n_cell, NN + 1))
    basin = np.zeros((n_cell, NN + 1))
    nn = np.full(n_cell, NN, np.int32)
    for k in range(NN + 1):
        fracz = 1.0 - k / NN
        z[:, k] = maxdepth * fracz
        basin[:, k] = area0 * fracz
    basin[:, NN] = 0.0
    vol = np.zeros(n_cell)
    for k in range(NN):
        vol += (z[:, k] - z[:, k + 1]) * (basin[:, k] + basin[:, k + 1]) / 2.0
    return dict(
        has_lake=np.ones(n_cell, bool), numnod=nn, z=z, basin=basin,
        mindepth=maxdepth * 0.5, minvolume=vol * 0.05, maxvolume=vol,
        maxdepth=maxdepth, wfrac=np.full(n_cell, 0.01),
        depth_in=(np.full(n_cell, depth_in) if depth_in is not None
                  else maxdepth * 0.7),
        rpercent=np.full(n_cell, 0.5), cl0=np.full(n_cell, frac))


# --------------------------------------------------------------------------
# Basin geometry (initialize_lake.c:335-470)
# --------------------------------------------------------------------------

def check_basin(z):
    """Raise ValueError unless every lake's levels z ([..., NN+1], numpy or
    torch) fall with k (z[k] >= z[k+1]) and hold no NaN: the basin
    geometry below assumes it, and the kernels' level searches
    (csrc/lake_basin.cuh) rely on it."""
    if not isinstance(z, torch.Tensor):
        z = torch.from_numpy(np.array(z))
    bad = torch.isnan(z).any(-1) | (z[..., 1:] > z[..., :-1]).any(-1)
    if bool(bad.any()):
        cells = torch.nonzero(bad.reshape(-1)).reshape(-1)[:5].tolist()
        raise ValueError(
            "lake basin levels must fall with depth index and hold no NaN; "
            f"{int(bad.sum())} lake(s) do not, first at cells {cells}")


def _area(z, b, depth):
    """Piecewise-linear area at `depth` on profiles z, b ([..., NN+1]
    broadcasting with depth[..., None])."""
    d = depth[..., None]
    z_top, z_bot = z[..., :-1], z[..., 1:]
    inlayer = (d <= z_top) & (d > z_bot)
    w = (d - z_bot) / torch.clamp(z_top - z_bot, min=1e-10)
    a = b[..., 1:] + w * (b[..., :-1] - b[..., 1:])
    area = W(inlayer, a, 0.0).sum(-1)     # one layer at most: exact
    area = W(depth >= z[..., 0], b[..., 0], area)
    return W(depth <= 0.0, 0.0, area)


def area_from_depth(lp: LakeParams, depth):
    """Surface area at water depth (get_sarea)."""
    return _area(lp.z, lp.basin, depth)


def volume_from_depth(lp: LakeParams, depth):
    """Trapezoidal volume below `depth` (get_volume, initialize_lake.c:370);
    the full layers summed in index order."""
    z, b = lp.z, lp.basin
    a_surf = area_from_depth(lp, depth)
    z_top, z_bot = z[..., :-1], z[..., 1:]
    layer_vol = (z_top - z_bot) * (b[..., :-1] + b[..., 1:]) / 2.0
    d = depth[..., None]
    vol_full = _isum(W(d >= z_top, layer_vol, 0.0))
    partial = (d > z_bot) & (d < z_top)
    h = torch.clamp(d - z_bot, min=0.0)
    vol_part = _isum(W(partial, h * (a_surf[..., None] + b[..., 1:]) / 2.0,
                       0.0))
    return vol_full + vol_part


def depth_from_volume_plain(lp: LakeParams, volume):
    """Plain version of the `lake_depth` kernel: volume -> depth by
    DEPTH_ITERS bisection steps on the monotone volume curve (get_depth,
    initialize_lake.c:412; vic_tpu/physics/lake.py:204)."""
    lo = torch.zeros_like(volume)
    hi = lp.maxdepth * torch.ones_like(volume)
    for _ in range(DEPTH_ITERS):
        mid = 0.5 * (lo + hi)
        high = volume_from_depth(lp, mid) > volume
        lo, hi = W(high, lo, mid), W(high, mid, hi)
    d = 0.5 * (lo + hi)
    return W(volume <= 0.0, 0.0, d)


def depth_from_volume(lp: LakeParams, volume):
    """Depth of `volume` m^3 of liquid: the plain bisection on CPU
    tensors, the `lake_depth` kernel (K13) on CUDA tensors."""
    if volume.device.type == "cpu":
        return depth_from_volume_plain(lp, volume)
    return kernels.lake_depth(lp.z, lp.basin, lp.maxdepth, volume)


class LayerGrid(NamedTuple):
    """The masked static-shape layering (vic_tpu/physics/lake.py:222)."""
    numnod: torch.Tensor    # [c] int32
    dz: torch.Tensor        # [c]
    surfdz: torch.Tensor    # [c]
    z: torch.Tensor         # [c, NN]
    zhalf: torch.Tensor     # [c, NN]
    mask: torch.Tensor      # [c, NN] bool
    last: torch.Tensor      # [c, NN] bool
    surface: torch.Tensor   # [c, NN+1]


def make_grid(lp: LakeParams, ldepth) -> LayerGrid:
    NN = MAX_LAKE_NODES
    f32 = ldepth.dtype
    two = (ldepth > MAX_SURFACE_LAKE) & (ldepth < 2.0 * MAX_SURFACE_LAKE)
    many = ldepth >= 2.0 * MAX_SURFACE_LAKE
    numnod = W(many, torch.clamp((ldepth / MAX_SURFACE_LAKE)
                                 .to(torch.int32), 2, NN),
               W(two, 2, 1)).to(torch.int32)
    surfdz = W(many, MAX_SURFACE_LAKE,
               W(two, ldepth / 2.0, torch.clamp(ldepth, min=1e-3)))
    dz = W(many, (ldepth - surfdz)
           / torch.clamp(numnod - 1, min=1).to(f32),
           W(two, ldepth / 2.0, 0.0))
    dz_safe = torch.clamp(dz, min=1e-3)
    k = torch.arange(NN, device=ldepth.device)
    mask = k[None, :] < numnod[..., None]
    last = k[None, :] == (numnod[..., None] - 1)
    first = k[None, :] == 0
    z = W(first, surfdz[..., None], dz_safe[..., None])
    zhalf = W(first,
              W((numnod > 1)[..., None], 0.5 * (surfdz + dz_safe)[..., None],
                0.5 * surfdz[..., None]),
              dz_safe[..., None])
    # surface[k]: area at ldepth for k=0, else at dz*(numnod-k)
    kk = torch.arange(NN + 1, dtype=f32, device=ldepth.device)
    lvl = W(kk[None, :] == 0, ldepth[..., None],
            torch.clamp(dz[..., None] * (numnod[..., None].to(f32)
                                         - kk[None, :]), min=0.0))
    area = torch.clamp(_area(lp.z[:, None, :], lp.basin[:, None, :], lvl),
                       min=0.0)
    return LayerGrid(numnod=numnod, dz=dz, surfdz=surfdz, z=z, zhalf=zhalf,
                     mask=mask, last=last, surface=area)


# --------------------------------------------------------------------------
# Water properties
# --------------------------------------------------------------------------

def _f32(k):
    return float(np.float32(k))


def _fma(k, x, acc):
    """k*x + acc rounded once, as XLA's CPU backend contracts a product
    feeding a sum into a fused multiply-add: the float32 product is exact
    in float64, so one float64 sum and the cast round as the FMA does
    (but for ties of the two roundings, about one in 2^29). k: a Python
    constant taken at float32; acc: a tensor or a constant."""
    if not isinstance(acc, torch.Tensor):
        acc = _f32(acc)
    else:
        acc = acc.double()
    return (x.double() * _f32(k) + acc).float()


def water_density(t):
    """Density anomaly vs 1000 kg/m^3 (calc_density, lakes.eb.c:800). The
    polynomial is the chain of fused multiply-adds vic_tpu's XLA computes
    (its results are equal bit for bit): near the density maximum at 4 C
    the layers' densities differ by ulps, and tracer_mixer's comparisons
    of them must fall the same way."""
    t2 = t * t
    t4 = t2 * t2
    r = _fma(6.793952e-2, t, 999.842594)
    r = _fma(-9.095290e-3, t2, r)
    r = _fma(1.001685e-4, t * t2, r)
    r = _fma(-1.120083e-6, t4, r)
    r = _fma(6.536332e-9, t * t4, r)
    return r - 1000.0


def specheat(t):
    """Specific heat of water J/kg/K (specheat, lakes.eb.c:1395), the fused
    multiply-add chain as water_density."""
    t2 = t * t
    r = _fma(-3.720283, t, 4217.4)
    r = _fma(0.1412855, t2, r)
    r = _fma(-2.654387e-3, t * t2, r)
    return _fma(2.093236e-5, t2 * t2, r)


def freezing_point(pressure_kpa):
    """Freshwater freezing point vs air pressure (rhoinit, lakes.eb.c:1323)."""
    return -7.53e-3 * pressure_kpa / 100.0


# --------------------------------------------------------------------------
# Eddy diffusivity (eddy, lakes.eb.c:837)
# --------------------------------------------------------------------------

def eddy_diffusivity(freezeflag, wind, temp, lat, grid: LayerGrid):
    """Hostetler eddy diffusivity per layer interface, [c, NN]; molecular
    only where freezeflag is False (eddy, lakes.eb.c:837-935)."""
    rho = water_density(temp)
    nn = temp.shape[-1]
    wind = torch.clamp(wind, min=1.0)
    ks = 6.6 * torch.sqrt(torch.sin(torch.abs(lat) * math.pi / 180.0)) \
        * torch.pow(wind, -1.84)
    ws = 0.0012 * wind
    k_idx = torch.arange(nn - 1, device=temp.device)
    zhalf = grid.zhalf[..., :-1]
    dpdz = (rho[..., 1:] - rho[..., :-1]) / zhalf
    n2 = dpdz / (1.0e3 + rho[..., :-1]) * 9.8
    z = grid.surfdz[..., None] + k_idx * grid.dz[..., None]
    ksz = torch.clamp(ks[..., None] * z, max=30.0)
    deep = z * torch.exp(ksz) / ws[..., None] > 1.0e8
    vkz = c.VON_K * z
    wsb = ws[..., None]
    rad = 1.0 + 40.0 * n2 * (vkz * vkz) / (wsb * wsb
                                           * torch.exp(-2.0 * ksz))
    rad = W(deep, 4.0e4, rad)
    rad = torch.clamp(rad, 1.0, 4.0e4)
    ri = (-1.0 + torch.sqrt(rad)) / 20.0
    de = DM + (c.VON_K * wsb * z / 1.0) * torch.exp(
        -ks[..., None] * z) / (1.0 + 37.0 * ri * ri)
    de = torch.cat([de, de[..., -1:]], -1)
    return W(freezeflag[..., None], de, DM)


# --------------------------------------------------------------------------
# Column energy content (energycalc, lakes.eb.c:1840)
# --------------------------------------------------------------------------

def energycalc(temp, grid: LayerGrid, cp, rho):
    """Thermal energy of the active column in J (Kelvin), summed over the
    layers in index order."""
    s_top = grid.surface[..., :-1]
    s_bot = grid.surface[..., 1:]
    wt = W(grid.last, s_top / 2.0, (s_top + s_bot) / 2.0)
    e = (temp + c.KELVIN) * grid.z * (1.0e3 + rho) * cp * wt
    return _isum(W(grid.mask, e, 0.0))


# --------------------------------------------------------------------------
# Layer temperature update (temp_area, lakes.eb.c:1395-1600)
# --------------------------------------------------------------------------

def temp_area(sw_visible, sw_nir, surface_force, temp, rho, de, dt_sec,
              grid: LayerGrid, cp):
    """Semi-implicit tridiagonal update of the active water column
    (vic_tpu/physics/lake.py:353). Returns (Tnew, joulenew,
    energy_out_bottom)."""
    NN = temp.shape[-1]
    k_idx = torch.arange(NN, dtype=temp.dtype, device=temp.device)
    z, zhalf, mask, last = grid.z, grid.zhalf, grid.mask, grid.last
    interior = mask & ~last
    first = k_idx[None, :] == 0

    s_top = grid.surface[..., :-1]
    s_bot = grid.surface[..., 1:]
    lm = last & (grid.numnod > 1)[..., None]
    s_bot = W(lm, s_top, s_bot)
    s_avg = W(lm, s_top, (s_top + s_bot) / 2.0)
    s_avg = torch.clamp(s_avg, min=c.SMALL)

    top = W(first, 0.0, grid.surfdz[..., None]
            + (k_idx[None, :] - 1.0) * grid.dz[..., None])
    bot = W(first, grid.surfdz[..., None],
            grid.surfdz[..., None] + k_idx[None, :] * grid.dz[..., None])

    swv, swn = sw_visible[..., None], sw_nir[..., None]
    t1 = (swv * (s_top * torch.exp(-LAMWSW * top)
                 - s_bot * torch.exp(-LAMWSW * bot))
          + swn * (s_top * torch.exp(-LAMWLW * top)
                   - s_bot * torch.exp(-LAMWLW * bot))) / s_avg
    t1_0 = t1[..., 0] + surface_force * s_top[..., 0] / s_avg[..., 0]
    t1 = torch.cat([t1_0[..., None], t1[..., 1:]], -1)

    # explicit diffusion half-terms at interface k (between k and k+1)
    dT = temp[..., 1:] - temp[..., :-1]
    g = de[..., :-1] / zhalf[..., :-1]
    term1 = 0.5 * g * dT / z[..., :-1] * s_bot[..., :-1] / s_avg[..., :-1]
    term1 = W(interior, torch.cat([term1, torch.zeros_like(term1[..., :1])],
                                  -1), 0.0)
    term2 = -0.5 * g * dT / z[..., 1:] * s_top[..., 1:] / s_avg[..., 1:]
    term2 = W(mask, torch.cat([torch.zeros_like(term2[..., :1]), term2], -1),
              0.0)
    cn = term1 + term2

    heat_cap = (1.0e3 + rho) * cp * z
    d_rhs = temp + t1 * dt_sec / heat_cap + cn * dt_sec
    d_rhs = W(mask, d_rhs, temp)

    b_sup = -0.5 * g * (dt_sec / z[..., :-1]) * s_bot[..., :-1] \
        / s_avg[..., :-1]
    b_sup = W(interior, torch.cat([b_sup, torch.zeros_like(b_sup[..., :1])],
                                  -1), 0.0)
    c_sub = -0.5 * g * (dt_sec / z[..., 1:]) * s_top[..., 1:] \
        / s_avg[..., 1:]
    c_sub = W(mask & ~first,
              torch.cat([torch.zeros_like(c_sub[..., :1]), c_sub], -1), 0.0)
    a_main = 1.0 - b_sup - c_sub

    t_new = thomas_solve(c_sub, a_main, b_sup, d_rhs)
    t_new = W(mask, t_new, temp)

    # energy out of the bottom of the deepest active node
    bot_last = W(last, bot, 0.0).sum(-1)      # one node: exact
    s_last = W(last, s_top, 0.0).sum(-1)
    energy_out_bottom = s_last * (
        sw_visible * torch.exp(-LAMWSW * bot_last)
        + sw_nir * torch.exp(-LAMWLW * bot_last)) / torch.clamp(
            grid.surface[..., 0], min=c.SMALL)

    joulenew = energycalc(t_new, grid, cp, rho)
    return t_new, joulenew, energy_out_bottom


def tracer_mixer(temp, grid: LayerGrid, cp, sweeps: int = MIX_SWEEPS):
    """Convective mixing of density-unstable layers (tracer_mixer,
    lakes.eb.c:1610): heat-conserving pairwise red-black sweeps, each
    parity pass reading the density at its start."""
    NN = temp.shape[-1]
    z = grid.z
    s_node = torch.clamp(grid.surface[..., :-1], min=c.SMALL)
    pair_ok = grid.mask[..., 1:]
    parity = torch.arange(NN - 1, device=temp.device) % 2
    T = temp
    for _ in range(sweeps):
        for par in (0, 1):
            rho = water_density(T)
            heatcon = z * (1.0e3 + rho) * cp * s_node
            do = (rho[..., :-1] > rho[..., 1:]) & (parity == par) & pair_ok
            tav = (T[..., :-1] * heatcon[..., :-1]
                   + T[..., 1:] * heatcon[..., 1:]) \
                / torch.clamp(heatcon[..., :-1] + heatcon[..., 1:],
                              min=c.SMALL)
            upper = W(do, tav, T[..., :-1])
            T = torch.cat([upper, T[..., -1:]], -1)
            lower = W(do, tav, T[..., 1:])
            T = torch.cat([T[..., :1], lower], -1)
    return T


# --------------------------------------------------------------------------
# New ice formation (iceform, lakes.eb.c:971)
# --------------------------------------------------------------------------

class IceformResult(NamedTuple):
    temp: torch.Tensor
    qfusion: torch.Tensor
    areaadd: torch.Tensor
    new_ice_height: torch.Tensor
    new_ice_water_eq: torch.Tensor


def iceform(temp, tcutoff, fracprv, dt_sec, grid: LayerGrid, cp,
            lvolume) -> IceformResult:
    surface = grid.surface
    # the deepest node weighs its FULL area (lakes.eb.c:1029-1035)
    wt = W(grid.last, surface[..., :-1],
           (surface[..., :-1] + surface[..., 1:]) / 2.0)
    cold = (temp < tcutoff[..., None]) & grid.mask
    extra = W(cold, (tcutoff[..., None] - temp) * grid.z * c.RHO_W * cp
              * (1.0 - fracprv)[..., None] * wt, 0.0)
    ssum = _isum(extra)
    t_out = W(cold, tcutoff[..., None], temp)

    new_iwe = ssum / (c.RHO_W * c.LF)
    denom = dt_sec * torch.clamp(surface[..., 0] * (1.0 - fracprv),
                                 min=c.SMALL)
    have_water = lvolume > new_iwe
    some_water = lvolume > 0.0
    new_iwe = W(have_water, new_iwe, W(some_water, lvolume, 0.0))
    di = W(have_water, ssum / (c.LF * RHOICE),
           W(some_water, new_iwe * c.RHO_W / RHOICE, 0.0))
    qfusion = W(have_water, ssum / denom,
                W(some_water, (new_iwe * c.RHO_W / RHOICE) / denom, 0.0))
    areaadd = di / FRACMIN
    cap = (1.0 - fracprv) * surface[..., 0]
    over = areaadd > cap
    new_hi = W(over, di / torch.clamp(cap, min=c.SMALL), FRACMIN)
    areaadd = torch.minimum(areaadd, cap)
    return IceformResult(temp=t_out, qfusion=qfusion, areaadd=areaadd,
                         new_ice_height=new_hi, new_ice_water_eq=new_iwe)


# --------------------------------------------------------------------------
# Bulk surface fluxes over open water (latsens + lkdrag, lakes.eb.c:543,1263)
# --------------------------------------------------------------------------

def lkdrag(tsurf_k, tair_k, wind, roughness, z1):
    """Richardson-number-corrected lake drag coefficient (lakes.eb.c:1263)."""
    logzr = torch.log(z1 / roughness)
    cdrn = c.VON_K / logzr
    cdrn = cdrn * cdrn
    ribn = z1 * c.G * (1.0 - tsurf_k / tair_k)
    ribd = W(tsurf_k / tair_k <= 1.0, wind * wind + 0.01, wind * wind + 1.0)
    rib = ribn / torch.clamp(ribd, min=c.SMALL)
    cdr = W(rib < 0.0,
            cdrn * (1.0 + 24.5 * torch.sqrt(torch.clamp(-cdrn * rib,
                                                        min=0.0))),
            cdrn / (1.0 + 11.5 * rib))
    cdrmin = torch.clamp(0.25 * cdrn, min=6.0e-4)
    return torch.maximum(cdr, cdrmin)


def latsens(tsurf_k, tcutk, hice, tair, wind, pressure, vp, air_density,
            wind_h):
    """Bulk latent/sensible partition over the lake surface (lakes.eb.c:543).
    Returns (evap mm/s, qsen W/m2)."""
    rough = W(hice > 0.0, ZSNOW, ZWATER)
    dragcoeff = lkdrag(tsurf_k, tair + c.KELVIN, wind, rough, wind_h)
    ts_c = tsurf_k - c.KELVIN
    eog_water = 611.0 * torch.exp(17.269 * ts_c / (ts_c + 237.3))
    eog_ice = 611.0 * torch.exp(21.874 * ts_c / (tsurf_k - 7.66))
    eog = W((hice <= 0.0) & (tsurf_k > tcutk), eog_water, eog_ice)
    qlake = 0.622 * eog / torch.clamp(pressure - 0.378 * eog, min=1.0)
    qair = 0.622 * vp / torch.clamp(pressure - 0.378 * vp, min=1.0)
    delq = qair - qlake
    evap = -1.0 * dragcoeff * wind * air_density * delq
    qsen = dragcoeff * wind * air_density * c.CP \
        * (tair + c.KELVIN - tsurf_k)
    return evap, qsen


# --------------------------------------------------------------------------
# Open-water column energy balance (water_energy_balance.c:47)
# --------------------------------------------------------------------------

class WaterEBResult(NamedTuple):
    temp: torch.Tensor
    qh: torch.Tensor
    qle: torch.Tensor
    lwnet: torch.Tensor
    delta_h: torch.Tensor
    energy_ice_formation: torch.Tensor
    new_ice_area: torch.Tensor
    new_ice_height: torch.Tensor
    new_ice_water_eq: torch.Tensor
    evap_mm_s: torch.Tensor
    energy_out_bottom: torch.Tensor
    converged: torch.Tensor
    # the fixed point's trips: the batch's (plain) or each lake's (K10)
    iterations: object = None


def water_energy_balance(*, temp, grid, lat, tcutoff, tair, wind, pressure,
                         vp, air_density, longwave, shortwave_net, wind_h,
                         fracprv, lvolume, dt_sec, active) -> WaterEBResult:
    """Fixed-point iteration on the skin temperature of the open-water
    fraction (vic_tpu/physics/lake.py:584). The loop runs while any lane is
    not done; a done lane keeps its outputs and its ts. Non-converged
    lanes take the reference's workaround."""
    rho0 = water_density(temp)
    cp0 = specheat(temp)
    jouleold = energycalc(temp, grid, cp0, rho0)
    tcutk = tcutoff + c.KELVIN
    zeros = torch.zeros_like(temp[..., 0])

    def fluxes(ts):
        tskin = ts + c.KELVIN
        evap, qh = latsens(tskin, tcutk, zeros, tair, wind, pressure, vp,
                           air_density, wind_h)
        le = (2.501 - 0.002361 * tair) * 1.0e6
        qle = -1.0 * evap * le
        tk2 = tskin * tskin
        lwnet = longwave - EMH2O * c.STEFAN_B * (tk2 * tk2)
        return evap, qh, qle, lwnet

    de = eddy_diffusivity(torch.ones_like(zeros, dtype=torch.bool), wind,
                          temp, lat, grid)

    def one_iter(ts):
        evap, qh, qle, lwnet = fluxes(ts)
        t_new, joulenew, e_bot = temp_area(
            shortwave_net * A1, shortwave_net * A2, qle + qh + lwnet, temp,
            rho0, de, dt_sec, grid, cp0)
        froze = t_new[..., 0] < tcutoff
        icf = iceform(t_new, tcutoff, fracprv, dt_sec, grid, cp0, lvolume)
        t_new = W(froze[..., None], icf.temp, t_new)
        joule_f = energycalc(t_new, grid, cp0, rho0)
        joulenew = W(froze, joule_f, joulenew)
        dh = (joulenew - jouleold) / torch.clamp(
            grid.surface[..., 0] * dt_sec, min=c.SMALL)
        return (t_new, evap, qh, qle, lwnet, dh,
                W(froze, icf.qfusion, 0.0), W(froze, icf.areaadd, 0.0),
                W(froze, icf.new_ice_height, 0.0),
                W(froze, icf.new_ice_water_eq, 0.0), e_bot)

    ts = temp[..., 0]
    done = ~active
    out = (temp,) + (zeros,) * 10
    i = 0
    while i < EB_MAX_ITER and not bool(done.all()):
        res = one_iter(ts)
        tmean = (res[0][..., 0] + temp[..., 0]) / 2.0
        newly = torch.abs(tmean - ts) <= EB_EPS
        out = tuple(W(done[..., None] if o.dim() == temp.dim() else done,
                      o_old, o) for o, o_old in zip(res, out))
        ts = W(done, ts, tmean)
        done = done | newly
        i += 1
    (t_new, evap, qh, qle, lwnet, dh, eif, aadd, nih, niwe, e_bot) = out

    # non-convergence workaround (water_energy_balance.c:185-218)
    evap_f, qh_f, qle_f, lwnet_f = fluxes(temp[..., 0])
    froze_f = temp[..., 0] < tcutoff
    icf_f = iceform(temp, tcutoff, fracprv, dt_sec, grid, specheat(temp),
                    lvolume)
    return WaterEBResult(
        temp=W(done[..., None], t_new, temp),
        qh=W(done, qh, qh_f), qle=W(done, qle, qle_f),
        lwnet=W(done, lwnet, lwnet_f), delta_h=W(done, dh, 0.0),
        energy_ice_formation=W(done, eif, W(froze_f, icf_f.qfusion, 0.0)),
        new_ice_area=W(done, aadd, W(froze_f, icf_f.areaadd, 0.0)),
        new_ice_height=W(done, nih, W(froze_f, icf_f.new_ice_height, 0.0)),
        new_ice_water_eq=W(done, niwe,
                           W(froze_f, icf_f.new_ice_water_eq, 0.0)),
        evap_mm_s=W(done, evap, evap_f),
        energy_out_bottom=W(done, e_bot, 0.0), converged=done, iterations=i)


def lake_open_water_plain(**kwargs):
    """Plain version of the `lake_open_water` kernel: water_energy_balance
    and the convective mix solve_lake applies to its column on every cell
    (vic_tpu/physics/lake.py:1330-1337). Returns (WaterEBResult, t_open)."""
    web = water_energy_balance(**kwargs)
    return web, tracer_mixer(web.temp, kwargs["grid"],
                             specheat(kwargs["temp"]))


# --------------------------------------------------------------------------
# Radiation through snow+ice (icerad, lakes.eb.c:1092) and albedo
# --------------------------------------------------------------------------

def icerad(sw, hi, hs):
    """Patterson & Hamblin radiation balance over ice. Returns (avgcond,
    sw_net absorbed in snow+ice, sw_under_ice)."""
    avgcond = (hs * CONDI + hi * CONDS) / (CONDI * CONDS)
    a = -1.0 * (1.0 - torch.exp(-LAMSSW * hs)) / (CONDS * LAMSSW)
    b = -1.0 * torch.exp(-LAMSSW * hs) * (1.0 - torch.exp(-LAMISW * hi)) \
        / (CONDI * LAMISW)
    cc = -1.0 * (1.0 - torch.exp(-LAMSLW * hs)) / (CONDS * LAMSLW)
    d = -1.0 * torch.exp(-LAMSLW * hs) * (1.0 - torch.exp(-LAMILW * hi)) \
        / (CONDI * LAMILW)
    sw_net = sw * A1 * (a + b) + sw * A2 * (cc + d)
    sw_under_ice = (A1 * sw * (1.0 - torch.exp(-(LAMSSW * hs + LAMISW * hi)))
                    + A2 * sw * (1.0 - torch.exp(-(LAMSLW * hs
                                                   + LAMILW * hi))))
    return avgcond, sw_net, sw_under_ice


class AlblakeResult(NamedTuple):
    albs: torch.Tensor
    albi: torch.Tensor
    albw: torch.Tensor
    salbedo: torch.Tensor
    last_snow: torch.Tensor
    melting: torch.Tensor


def alblake(tcutoff, tair, salbedo, newsnow_mm, coldcontent, dt_hours,
            last_snow, swq, depth, melting, day_in_year, lat,
            new_snow_alb, accum_a, accum_b, thaw_a, thaw_b) -> AlblakeResult:
    """Lake snow/ice albedo (alblake, lakes.eb.c:637). day_in_year: a host
    int or a tensor."""
    dT = tair - tcutoff
    dTc = torch.clamp(dT, 0.0, 20.0)
    albgl = W(dT > 0.0, 0.4 - 0.011 * dTc, 0.4)
    albgs = W(dT > 0.0, 0.6 - 0.0245 * dTc, 0.6)
    albi = 0.5 * albgs + 0.5 * albgl

    last_snow = W(newsnow_mm > c.TRACESNOW, 1.0,
                  W(swq == 0.0, 0.0, last_snow + 1.0))
    doy = torch.as_tensor(day_in_year, device=tair.device)
    in_melt_season = W(lat >= 0.0, (doy > 60) & (doy < 273),
                       (doy < 60) | (doy > 273))
    melting = W(swq > 0.0, (coldcontent >= 0.0) & in_melt_season,
                torch.zeros_like(melting))
    melting = W(newsnow_mm > c.TRACESNOW, torch.zeros_like(melting), melting)

    aged = snow_albedo(newsnow_mm, swq, depth, salbedo, coldcontent,
                       dt_hours, last_snow, melting, new_snow_alb,
                       accum_a, accum_b, thaw_a, thaw_b)
    salbedo = W(swq > 0.0, aged, W(newsnow_mm > 0.0, new_snow_alb, 0.0))
    albs = W(newsnow_mm > 0.0, new_snow_alb, salbedo)
    albw = torch.full_like(albs, 0.15)
    return AlblakeResult(albs=albs, albi=albi, albw=albw, salbedo=salbedo,
                         last_snow=last_snow, melting=melting)


# --------------------------------------------------------------------------
# Ice/snow surface energy balance residual (IceEnergyBalance.c:60-175)
# --------------------------------------------------------------------------

class IceEBTerms(NamedTuple):
    rest: torch.Tensor
    refreeze_energy: torch.Tensor
    vapor_flux: torch.Tensor
    latent: torch.Tensor
    latent_sub: torch.Tensor
    sensible: torch.Tensor
    advection: torch.Tensor
    qf: torch.Tensor
    lwnet: torch.Tensor


def ice_energy_terms(tsurf, *, dt_sec, ra, z_ref, roughness, wind, net_short,
                     longwave_in, air_dens, lv, tair, pressure, vpd, vp_air,
                     rain_m, surf_water, tcutoff, avgcond, sw_conducted,
                     blowing_flux=0.0) -> IceEBTerms:
    """The lake snow/ice surface energy balance at candidate tsurf
    (vic_tpu/physics/lake.py:752); blowing_flux, the blowing-snow
    sublimation flux over the ice (kg/m^2/s, BLOWING), enters the vapor
    flux through latent_heat_from_snow. The latent term keeps the
    UNcorrected resistance (IceEnergyBalance.c:132). `IceResidual` in
    csrc/lake_ice_melt.cu is a line-for-line copy (its `terms`), its fields
    in the order of kernels.ICE_EB_INPUTS."""
    ra_corr = W(wind > 0.0,
                ra / stability_correction(z_ref, 0.0, tsurf, tair, wind,
                                          roughness),
                c.HUGE_RESIST)
    tkelv = tsurf + c.KELVIN
    tk2 = tkelv * tkelv
    lwnet = longwave_in - c.STEFAN_B * (tk2 * tk2)
    net_rad = net_short + lwnet
    sensible = air_dens * c.CP_PM * (tair - tsurf) / ra_corr
    latent, latent_sub, vapor_mass_flux = latent_heat_from_snow(
        air_dens, vp_air, lv, pressure, ra, tsurf, vpd, blowing_flux)
    vapor_flux = vapor_mass_flux * dt_sec / c.RHO_W
    advection = c.CH_WATER * tair * rain_m / dt_sec
    qnull = (tcutoff - tsurf + sw_conducted) / torch.clamp(avgcond,
                                                           min=c.SMALL)
    rest = net_rad + sensible + latent + latent_sub + advection + qnull
    refreeze_energy = surf_water * c.LF * c.RHO_W / dt_sec
    melt_branch = (tsurf == 0.0) & (rest > -refreeze_energy)
    return IceEBTerms(rest=W(melt_branch, 0.0, rest + refreeze_energy),
                      refreeze_energy=W(melt_branch, -rest, refreeze_energy),
                      vapor_flux=vapor_flux, latent=latent,
                      latent_sub=latent_sub, sensible=sensible,
                      advection=advection, qf=qnull, lwnet=lwnet)


def lake_ice_brent_plain(lo, hi, active, *, dt, max_iter, max_tries,
                         **inputs):
    """The Brent of `lake_ice_melt_plain`: expand-then-Brent on
    `ice_energy_terms(t).rest` (vic_tpu/physics/lake.py:960)."""
    return batched_brent(
        lambda t: ice_energy_terms(t, dt_sec=dt, **inputs).rest, lo, hi,
        max_iter=max_iter, max_tries=max_tries, active=active)


# --------------------------------------------------------------------------
# Snow-on-ice two-layer mass/energy update (ice_melt.c:117-650)
# --------------------------------------------------------------------------

class IceMeltResult(NamedTuple):
    swq: torch.Tensor
    surf_temp: torch.Tensor
    pack_temp: torch.Tensor
    surf_water: torch.Tensor
    pack_water: torch.Tensor
    melt_m: torch.Tensor
    ice_melt_m: torch.Tensor
    lake_ice_m: torch.Tensor
    vapor_flux: torch.Tensor
    qnet: torch.Tensor
    surf_temp_fbflag: torch.Tensor
    cold_content: torch.Tensor
    terms: IceEBTerms
    sw_under_ice: torch.Tensor
    # the Brent's root, converged, bracketed and iterations (a RootResult)
    solve: object = None


def lake_ice_melt_plain(*, swq, surf_temp, pack_temp, surf_water,
                        pack_water, lake_ice_m, hice, rainfall_mm,
                        snowfall_mm, tair, wind, vp_air, vpd, pressure,
                        air_dens, longwave_in, net_short, tcutoff, ra, z_ref,
                        roughness, dt_sec, max_iter: int = 30,
                        blowing_flux=0.0, active=None) -> IceMeltResult:
    """Plain version of the `lake_ice_melt` kernel (K12): two-layer snow
    over lake ice (vic_tpu/physics/lake.py:805), masses in m of water over
    the ICE area; the subfreezing surface temperature is a Brent root of
    ice_energy_terms (`lake_ice_brent_plain`). blowing_flux: the
    blowing-snow flux over the ice (kg/m^2/s), a number or a tensor that
    broadcasts to the lakes."""
    MSW = c.MAX_SURFACE_SWE
    snowfall = snowfall_mm / 1000.0
    rainfall = rainfall_mm / 1000.0
    old_tsurf = surf_temp

    snow_ice = swq - pack_water - surf_water
    ice = snow_ice + lake_ice_m
    surface_swq = torch.clamp(ice, max=MSW)
    surf_covers = surface_swq <= snow_ice
    pack_swq = W(surf_covers, snow_ice - surface_swq, 0.0)
    pack_ice = W(surf_covers, lake_ice_m, ice - surface_swq)

    surface_cc = c.CH_ICE * surface_swq * surf_temp
    pack_cc = c.CH_ICE * (pack_swq + pack_ice) * pack_temp
    snowfall_cc = W(tair > 0.0, 0.0, c.CH_ICE * snowfall * tair)

    # distribute fresh snowfall (ice_melt.c:232-258)
    spill = snowfall > (MSW - surface_swq)
    delta_pack_swq = W(spill, surface_swq + snowfall - MSW, 0.0)
    delta_pack_cc = W(
        spill,
        W(delta_pack_swq > surface_swq,
          surface_cc + (snowfall - MSW)
          / torch.clamp(snowfall, min=c.SMALL) * snowfall_cc,
          delta_pack_swq / torch.clamp(surface_swq, min=c.SMALL)
          * surface_cc),
        0.0)
    surface_swq = W(spill, MSW, surface_swq + snowfall)
    surface_cc = surface_cc + snowfall_cc - delta_pack_cc
    pack_swq = pack_swq + delta_pack_swq
    pack_cc = pack_cc + delta_pack_cc
    surf_temp = W(surface_swq > 0.0,
                  surface_cc / (c.CH_ICE * torch.clamp(surface_swq,
                                                       min=c.SMALL)), 0.0)
    pack_temp = W(pack_swq + pack_ice > 0.0,
                  pack_cc / (c.CH_ICE * torch.clamp(pack_swq + pack_ice,
                                                    min=c.SMALL)), 0.0)
    snow_ice = snow_ice + snowfall
    ice = ice + snowfall
    surf_water = surf_water + rainfall

    avgcond, sw_conducted, sw_under_ice = icerad(
        net_short, hice, snow_ice * c.RHO_W / RHOSNOW)

    lv_ice = (677.0 - 0.07 * tair) * c.JOULES_PER_CAL * c.GRAMS_PER_KG
    term_kwargs = dict(
        ra=ra, z_ref=z_ref, roughness=roughness, wind=wind,
        net_short=net_short, longwave_in=longwave_in, air_dens=air_dens,
        lv=lv_ice, tair=tair, pressure=pressure, vpd=vpd, vp_air=vp_air,
        rain_m=rainfall, surf_water=surf_water, tcutoff=tcutoff,
        avgcond=avgcond, sw_conducted=sw_conducted,
        blowing_flux=torch.as_tensor(blowing_flux, dtype=swq.dtype,
                                     device=swq.device))

    terms0 = ice_energy_terms(torch.zeros_like(swq), dt_sec=dt_sec,
                              **term_kwargs)
    melt_cond = terms0.rest == 0.0

    # ---- branch A: surface at 0 C, melt/refreeze (ice_melt.c:309-410) ----
    refreeze = terms0.refreeze_energy
    refrozen = torch.minimum(torch.clamp(refreeze * dt_sec / (c.LF * c.RHO_W),
                                         min=0.0), surf_water)
    freezing = refreeze >= 0.0
    refz = W(freezing, refrozen, 0.0)
    a_surface_swq = surface_swq + refz
    a_snow_ice = snow_ice + refz
    a_ice = ice + refz
    a_surf_water = torch.clamp(surf_water - refz, min=0.0)
    snowmelt = W(freezing, 0.0,
                 torch.abs(refreeze) * dt_sec / (c.LF * c.RHO_W))

    vflux = terms0.vapor_flux
    vflux_a = W(a_surf_water < -vflux, -a_surf_water, vflux)
    a_surf_water = torch.clamp(a_surf_water + vflux_a, min=0.0)

    case1 = snowmelt <= pack_swq
    case2 = ~case1 & (snowmelt <= a_snow_ice)
    case3 = ~case1 & ~case2 & (snowmelt < a_ice)
    complete = ~case1 & ~case2 & ~case3

    sw1 = a_surf_water + snowmelt
    ps1 = pack_swq - snowmelt
    sw2 = a_surf_water + snowmelt + pack_water
    ss2 = a_surface_swq - (snowmelt - pack_swq)
    sw3 = a_surf_water + a_snow_ice + pack_water
    icemelt3 = snowmelt - a_snow_ice
    lake3 = lake_ice_m - icemelt3
    ss3 = W(a_surface_swq > snowmelt, a_surface_swq - snowmelt, 0.0)
    pi3 = W(a_surface_swq > snowmelt, pack_ice,
            pack_ice - (snowmelt - a_surface_swq))
    sw4 = a_surf_water + a_snow_ice + pack_water
    snowmelt4 = a_ice

    a_state = dict(
        surface_swq=W(case1, a_surface_swq,
                      W(case2, ss2, W(case3, ss3, 0.0))),
        pack_swq=W(case1, ps1, 0.0),
        surf_water=W(case1, sw1, W(case2, sw2, W(case3, sw3, sw4))),
        pack_water=W(case1, pack_water, 0.0),
        snow_ice=W(case1, a_snow_ice - snowmelt,
                   W(case2, a_snow_ice - snowmelt, 0.0)),
        lake_ice=W(case3, lake3, W(complete, 0.0, lake_ice_m)),
        pack_ice=W(case3, pi3, W(complete, 0.0, pack_ice)),
        ice=W(complete, 0.0, a_ice - W(complete, 0.0, snowmelt)),
        surf_temp=torch.zeros_like(surf_temp),
        pack_temp=W(complete, 0.0, pack_temp),
        vapor_flux=vflux_a,
        ice_melt=W(case3, icemelt3, W(complete, lake_ice_m, 0.0)),
        snowmelt=W(complete, snowmelt4, snowmelt))

    # ---- branch B: subfreezing surface, Brent (ice_melt.c:425-520) ----
    thin = surface_swq <= c.MIN_SWQ_EB_THRES
    brent_active = ~melt_cond & ~thin
    if active is not None:
        brent_active = brent_active & active
    res = lake_ice_brent_plain(old_tsurf - c.SNOW_DT, old_tsurf + c.SNOW_DT,
                               brent_active, dt=dt_sec, max_iter=max_iter,
                               max_tries=MAXTRIES, **term_kwargs)
    ok = res.converged & ~thin
    b_surf_temp = W(ok, res.root, old_tsurf)     # TFALLBACK (+ thin)
    fbflag = ~ok & ~melt_cond
    terms_b = ice_energy_terms(b_surf_temp, dt_sec=dt_sec, **term_kwargs)

    # all surface liquid refreezes (ice_melt.c:480-487)
    b_surface_swq = surface_swq + surf_water
    b_snow_ice = snow_ice + surf_water
    b_ice = ice + surf_water
    bv = terms_b.vapor_flux
    exceeds = b_surface_swq < -bv
    surf_over_snow = b_surface_swq > b_snow_ice
    snow_has = b_snow_ice > -bv
    b_state = dict(
        surface_swq=torch.clamp(
            W(exceeds, W(surf_over_snow, b_surface_swq, 0.0),
              b_surface_swq + bv), min=0.0),
        pack_swq=pack_swq, surf_water=torch.zeros_like(surf_water),
        pack_water=pack_water,
        snow_ice=W(exceeds, W(surf_over_snow, 0.0, b_snow_ice),
                   W(snow_has, b_snow_ice + bv, 0.0)),
        lake_ice=torch.clamp(
            W(exceeds,
              W(surf_over_snow, lake_ice_m - (b_surface_swq - b_snow_ice),
                lake_ice_m),
              W(snow_has, lake_ice_m, lake_ice_m + (bv + b_snow_ice))),
            min=0.0),
        pack_ice=pack_ice,
        ice=torch.clamp(W(exceeds, W(surf_over_snow, pack_ice,
                                     pack_swq + pack_ice), b_ice + bv),
                        min=0.0),
        surf_temp=b_surf_temp, pack_temp=pack_temp,
        vapor_flux=W(exceeds, -b_surface_swq, bv),
        ice_melt=torch.zeros_like(swq), snowmelt=torch.zeros_like(swq))

    def sel(k):
        return W(melt_cond, a_state[k], b_state[k])

    surface_swq = sel("surface_swq")
    pack_swq = sel("pack_swq")
    surf_water = sel("surf_water")
    pack_water = sel("pack_water")
    snow_ice = sel("snow_ice")
    lake_ice = sel("lake_ice")
    pack_ice = sel("pack_ice")
    ice = sel("ice")
    surf_temp = sel("surf_temp")
    pack_temp = sel("pack_temp")
    vapor_flux = sel("vapor_flux")
    ice_melt_m = sel("ice_melt")
    terms = IceEBTerms(*(W(melt_cond, a, b)
                         for a, b in zip(terms0, terms_b)))

    # ---- liquid capacity + pack refreeze (ice_melt.c:528-590) ----
    max_liquid = c.SNOW_LIQUID_WATER_CAPACITY * torch.minimum(snow_ice,
                                                              surface_swq)
    melt_out = torch.clamp(surf_water - max_liquid, min=0.0)
    surf_water = torch.minimum(surf_water, max_liquid)

    pack_water = pack_water + melt_out
    pack_cc = c.CH_ICE * (pack_swq + pack_ice) * pack_temp
    pack_refreeze_e = pack_water * c.LF * c.RHO_W
    cold_enough = pack_cc < -pack_refreeze_e
    pack_swq_f = pack_swq + pack_water
    ice_f = ice + pack_water
    snow_ice_f = snow_ice + pack_water
    pack_cc_f = pack_cc + pack_refreeze_e
    pack_temp_f = W(pack_swq_f + pack_ice > 0.0,
                    torch.clamp(pack_cc_f / (c.CH_ICE * torch.clamp(
                        pack_swq_f + pack_ice, min=c.SMALL)), max=0.0), 0.0)
    delta_pack = -pack_cc / (c.LF * c.RHO_W)
    pack_swq = W(cold_enough, pack_swq_f, pack_swq + delta_pack)
    ice = W(cold_enough, ice_f, ice + delta_pack)
    snow_ice = W(cold_enough, snow_ice_f, snow_ice + delta_pack)
    pack_water = W(cold_enough, 0.0,
                   torch.clamp(pack_water - delta_pack, min=0.0))
    pack_temp = W(cold_enough, pack_temp_f, 0.0)

    max_liquid_pack = c.SNOW_LIQUID_WATER_CAPACITY * pack_swq
    melt_out = torch.clamp(pack_water - max_liquid_pack, min=0.0)
    pack_water = torch.minimum(pack_water, max_liquid_pack)

    # ---- re-layer around MAX_SURFACE_SWE (ice_melt.c:593-625) ----
    ice = pack_ice + pack_swq + surface_swq
    deep = ice > MSW
    surface_cc = c.CH_ICE * surf_temp * surface_swq
    pack_cc = c.CH_ICE * pack_temp * (pack_swq + pack_ice)
    excess = surface_swq - MSW
    frac_s = excess / torch.clamp(surface_swq, min=c.SMALL)
    pack_cc_1 = pack_cc + surface_cc * frac_s
    surface_cc_1 = surface_cc * (1.0 - frac_s)
    pack_swq_1 = pack_swq + excess
    deficit = MSW - surface_swq
    frac_p = deficit / torch.clamp(pack_swq + pack_ice, min=c.SMALL)
    pack_cc_2 = pack_cc * (1.0 - frac_p)
    surface_cc_2 = surface_cc + pack_cc * frac_p
    pack_swq_2 = pack_swq - deficit

    too_thick = surface_swq > MSW
    exact = surface_swq == MSW
    surface_swq_d = W(exact, surface_swq, torch.full_like(surface_swq, MSW))
    pack_swq_d = W(exact, pack_swq, W(too_thick, pack_swq_1, pack_swq_2))
    surface_cc_d = W(exact, surface_cc,
                     W(too_thick, surface_cc_1, surface_cc_2))
    pack_cc_d = W(exact, pack_cc, W(too_thick, pack_cc_1, pack_cc_2))

    surface_swq = W(deep, surface_swq_d, surface_swq)
    pack_swq = W(deep, torch.clamp(pack_swq_d, min=0.0), 0.0)
    pack_ice = W(deep, pack_ice, 0.0)
    surf_temp = W(deep, surface_cc_d / (c.CH_ICE * torch.clamp(
        surface_swq_d, min=c.SMALL)), surf_temp)
    pack_temp = W(deep, pack_cc_d / (c.CH_ICE * torch.clamp(
        pack_swq_d + pack_ice, min=c.SMALL)), 0.0)

    swq_out = snow_ice + surf_water + pack_water
    cold_content = c.CH_ICE * surf_temp * surface_swq
    return IceMeltResult(
        swq=torch.clamp(swq_out, min=0.0), surf_temp=surf_temp,
        pack_temp=pack_temp, surf_water=surf_water, pack_water=pack_water,
        melt_m=melt_out, ice_melt_m=ice_melt_m,
        lake_ice_m=torch.clamp(lake_ice, min=0.0),
        vapor_flux=-vapor_flux, qnet=terms.rest, surf_temp_fbflag=fbflag,
        cold_content=cold_content, terms=terms, sw_under_ice=sw_under_ice,
        solve=res)


def lake_ice_melt(**kwargs) -> IceMeltResult:
    """Two-layer snow over lake ice: `lake_ice_melt_plain` on CPU tensors,
    the `lake_ice_melt` kernel (K12, the whole function in one launch) on
    CUDA tensors."""
    if kwargs["swq"].device.type == "cpu":
        return lake_ice_melt_plain(**kwargs)
    return kernels.lake_ice_melt(**kwargs)


# --------------------------------------------------------------------------
# Water column under the ice (water_under_ice.c:45)
# --------------------------------------------------------------------------

class UnderIceResult(NamedTuple):
    temp: torch.Tensor
    qw: torch.Tensor
    delta_h: torch.Tensor
    energy_out_bottom: torch.Tensor
    converged: torch.Tensor
    # the fixed point's trips: the batch's (plain) or each lake's (K11)
    iterations: object = None


def water_under_ice_plain(*, temp, grid, lat, tcutoff, wind, sw_ice, hice,
                          sdepth, dt_sec, active) -> UnderIceResult:
    """Plain version of the `lake_under_ice` kernel: the fixed point on the
    ice/water interface flux qw (vic_tpu/physics/lake.py:1112), the column
    solved and mixed every iteration; molecular diffusivity only.
    Non-converged lanes: qw = 0 and the column pinned at Tcutoff."""
    rho0 = water_density(temp)
    cp0 = specheat(temp)
    jouleold = energycalc(temp, grid, cp0, rho0)
    de = eddy_diffusivity(torch.zeros_like(tcutoff, dtype=torch.bool), wind,
                          temp, lat, grid)
    qw_init = 0.57 * (temp[..., 0] - tcutoff) / (grid.surfdz / 2.0)
    sw_vis = A1 * sw_ice * torch.exp(-1.0 * (LAMISW * hice + LAMSSW * sdepth))
    sw_nir = A2 * sw_ice * torch.exp(-1.0 * (LAMILW * hice + LAMSLW * sdepth))
    denom = torch.clamp(grid.surface[..., 0] * dt_sec, min=c.SMALL)

    def one_iter(qw):
        t_new, joulenew, e_bot = temp_area(
            sw_vis, sw_nir, -1.0 * qw, temp, rho0, de, dt_sec, grid, cp0)
        dh = (joulenew - jouleold) / denom
        t_new = tracer_mixer(t_new, grid, cp0)
        qw_final = 0.57 * (t_new[..., 0] - tcutoff) / (grid.surfdz / 2.0)
        return t_new, dh, e_bot, (qw_final + qw) / 2.0

    z0 = torch.zeros_like(qw_init)
    qw = qw_init
    done = ~active
    out = (temp, z0, z0, qw_init)
    i = 0
    while i < EB_MAX_ITER and not bool(done.all()):
        res = one_iter(qw)
        newly = torch.abs(res[3] - qw) <= EB_EPS
        out = tuple(W(done[..., None] if o.dim() == temp.dim() else done,
                      o_old, o) for o, o_old in zip(res, out))
        qw = W(done, qw, res[3])
        done = done | newly
        i += 1
    t_new, dh, e_bot, qw_mean = out

    # workaround on non-convergence (water_under_ice.c:130-146)
    t_fb = tcutoff[..., None].expand(temp.shape)
    dh_fb = (energycalc(t_fb, grid, cp0, rho0) - jouleold) / denom
    return UnderIceResult(
        temp=W(done[..., None], t_new, t_fb), qw=W(done, qw_mean, 0.0),
        delta_h=W(done, dh, dh_fb), energy_out_bottom=W(done, e_bot, 0.0),
        converged=done, iterations=i)


def water_under_ice(**kwargs) -> UnderIceResult:
    """The under-ice column: `water_under_ice_plain` on CPU tensors, the
    `lake_under_ice` kernel (K11) on CUDA tensors."""
    if kwargs["temp"].device.type == "cpu":
        return water_under_ice_plain(**kwargs)
    return kernels.lake_under_ice(**kwargs)


def lake_open_water(**kwargs):
    """The open-water column and its mix, (WaterEBResult, t_open):
    `lake_open_water_plain` on CPU tensors, the `lake_open_water` kernel
    (K10) on CUDA tensors."""
    if kwargs["temp"].device.type == "cpu":
        return lake_open_water_plain(**kwargs)
    return kernels.lake_open_water(**kwargs)


# --------------------------------------------------------------------------
# Bottom ice growth / melt (lakeice, lakes.eb.c:1153), column average
# --------------------------------------------------------------------------

class LakeiceResult(NamedTuple):
    ice_water_eq: torch.Tensor
    energy_ice_melt_bot: torch.Tensor
    qf: torch.Tensor


def lakeice(*, sw_ice, fracprv, dt_sec, snowflux, qw, sw_absorbed,
            ice_water_eq, volume, sarea) -> LakeiceResult:
    """Melt/freeze at the bottom of the ice pack (lakes.eb.c:1153-1262)."""
    qf = snowflux + sw_ice - sw_absorbed
    e_bot = qf - qw
    dibot = e_bot / (RHOICE * c.LF) * dt_sec
    new_water_eq = dibot * sarea * fracprv * RHOICE / c.RHO_W
    liquid = volume - ice_water_eq
    freeze_full = liquid >= new_water_eq
    some = liquid > 0.0
    iwe_freeze = W(freeze_full, ice_water_eq + new_water_eq,
                   W(some, volume, ice_water_eq))
    iwe = W(dibot > 0.0, iwe_freeze,
            torch.clamp(ice_water_eq + new_water_eq, min=0.0))
    return LakeiceResult(ice_water_eq=iwe, energy_ice_melt_bot=e_bot, qf=qf)


def colavg(t_open, t_ice, fracprv, grid: LayerGrid):
    """Average the open-water and under-ice columns by ice fraction,
    weighted by layer thickness x density (colavg, lakes.eb.c:735)."""
    z = grid.z
    rho_w = water_density(t_open) + 1000.0
    rho_i = water_density(t_ice) + 1000.0
    f = fracprv[..., None]
    num = (1.0 - f) * t_open * z * rho_w + f * t_ice * z * rho_i
    den = (1.0 - f) * z * rho_w + f * z * rho_i
    return num / torch.clamp(den, min=c.SMALL)


# --------------------------------------------------------------------------
# solve_lake: the energy budget in sequence (lakes.eb.c:8-540)
# --------------------------------------------------------------------------

class SolveLakeResult(NamedTuple):
    state: LakeState
    ice_throughfall_m3: torch.Tensor
    store_dump_m3: torch.Tensor
    precip_in_m3: torch.Tensor
    snowmelt_m3: torch.Tensor
    evap_m3: torch.Tensor
    vapor_flux_m3: torch.Tensor
    new_ice_area: torch.Tensor
    sarea: torch.Tensor
    ldepth: torch.Tensor
    fracprv: torch.Tensor
    albedo_lake: torch.Tensor
    net_short: torch.Tensor
    net_long: torch.Tensor
    sensible: torch.Tensor
    latent: torch.Tensor
    delta_h: torch.Tensor
    grnd_flux: torch.Tensor
    refreeze_energy: torch.Tensor
    advection: torch.Tensor
    energy_error: torch.Tensor
    tsurf: torch.Tensor
    ice_fbflag: torch.Tensor


def solve_lake(lp: LakeParams, st: LakeState, *, snowfall_mm, rainfall_mm,
               tair, wind, vp, sw_in, lw_in, vpd, pressure, air_density,
               dt_sec, wind_h, snow_rough, lat, day_in_year, new_snow_alb,
               alb_accum_a, alb_accum_b, alb_thaw_a, alb_thaw_b,
               active, blowing: bool = False) -> SolveLakeResult:
    """One energy-budget pass over every lake (vic_tpu/physics/lake.py:1243),
    with the blowing-snow flux over lake ice if `blowing`. vp/vpd/pressure
    in Pa. The water balance is left to lake_step."""
    dt_h = dt_sec / 3600.0
    liquid = torch.clamp(st.volume - st.ice_water_eq, min=0.0)
    ldepth = depth_from_volume(lp, liquid)
    grid = make_grid(lp, ldepth)
    sarea = torch.clamp(grid.surface[..., 0], min=1.0)
    fracprv = torch.clamp(st.ice_area / sarea, 0.0, 1.0)
    tcutoff = freezing_point(pressure / 1000.0)

    active = lp.has_lake & active & ((ldepth > 0.01) | (st.ice_area > 0.0))

    # ---- 2. precip and snow-store conversion (lakes.eb.c:196-232) ----
    has_ice_cover = fracprv > 0.0

    def to_ice(x):
        return W(has_ice_cover, x / torch.clamp(fracprv, min=c.SMALL), 0.0)

    swq_i = to_ice(st.swe)
    surf_water_i = to_ice(st.surf_water)
    pack_water_i = to_ice(st.pack_water)
    store_dump = W((st.swe > 0.0) & ~has_ice_cover, sarea * st.swe, 0.0)

    full_ice = fracprv >= 1.0
    part_ice = (fracprv > FRACLIM) & ~full_ice
    open_lake = fracprv <= FRACLIM
    rain_to_lake_full = full_ice & (swq_i <= 0.0)
    ice_throughfall = torch.zeros_like(sarea)
    ice_throughfall = ice_throughfall + W(
        rain_to_lake_full, rainfall_mm / 1000.0 * st.ice_area, 0.0)
    ice_throughfall = ice_throughfall + W(
        part_ice, (snowfall_mm + rainfall_mm) / 1000.0 * (1.0 - fracprv)
        * sarea, 0.0)
    rain_to_lake_part = part_ice & (swq_i <= 0.0)
    ice_throughfall = ice_throughfall + W(
        rain_to_lake_part, rainfall_mm / 1000.0 * fracprv * sarea, 0.0)
    ice_throughfall = ice_throughfall + W(
        open_lake, (rainfall_mm + snowfall_mm) / 1000.0 * sarea, 0.0)
    rain_on_pack = W(rain_to_lake_full | rain_to_lake_part | open_lake, 0.0,
                     rainfall_mm)
    snow_on_pack = W(open_lake, 0.0, snowfall_mm)

    # ---- 3. albedos and SW over ice/water (lakes.eb.c:237-270) ----
    surface_swq_i = torch.clamp(swq_i - surf_water_i - pack_water_i,
                                max=c.MAX_SURFACE_SWE)
    coldcontent = c.CH_ICE * st.surf_temp * torch.clamp(surface_swq_i,
                                                        min=0.0)
    snow_depth_i = swq_i * c.RHO_W / RHOSNOW
    alb = alblake(tcutoff, tair, st.salbedo, snow_on_pack, coldcontent,
                  dt_h, st.last_snow, swq_i, snow_depth_i, st.melting,
                  day_in_year, lat, new_snow_alb, alb_accum_a, alb_accum_b,
                  alb_thaw_a, alb_thaw_b)
    deep_snow = swq_i > SNOWCRIT * RHOSNOW / c.RHO_W
    thin_snow = (swq_i > 0.0) & ~deep_snow
    bare_ice = (fracprv > 0.0) & (swq_i <= 0.0)
    alb_ice_eff = W(deep_snow, alb.albs,
                    W(thin_snow, (alb.albi + alb.albs) / 2.0, alb.albi))
    iced = deep_snow | thin_snow | bare_ice
    sw_ice = W(iced, sw_in * (1.0 - alb_ice_eff), 0.0)
    albedo_lake = W(iced, fracprv * alb_ice_eff + (1.0 - fracprv) * alb.albw,
                    alb.albw)
    sw_water = sw_in * (1.0 - alb.albw)

    # ---- 4./5. open-water column and its mix (lakes.eb.c:275-335) ----
    has_open = (1.0 - fracprv) > c.SMALL
    log_w = torch.log(sarea.new_tensor((2.0 + ZWATER) / ZWATER))
    windw = torch.clamp(
        wind * log_w / torch.clamp(torch.log(wind_h / ZWATER), min=c.SMALL),
        min=0.0)
    web, t_open = lake_open_water(
        temp=st.temp, grid=grid, lat=lat, tcutoff=tcutoff, tair=tair,
        wind=windw, pressure=pressure, vp=vp, air_density=air_density,
        longwave=lw_in, shortwave_net=sw_water, wind_h=wind_h,
        fracprv=fracprv, lvolume=liquid, dt_sec=dt_sec,
        active=active & has_open)

    open_f = W(has_open, 1.0 - fracprv, 0.0)
    atmos_latent = open_f * web.qle
    atmos_sensible = open_f * web.qh
    net_long = open_f * web.lwnet
    net_short = open_f * W(has_open, sw_water, 0.0)
    refreeze = open_f * web.energy_ice_formation
    delta_h = open_f * web.delta_h
    grnd_flux = -1.0 * open_f * web.energy_out_bottom
    tsurf_blend = open_f * t_open[..., 0]
    new_ice_area = W(has_open, web.new_ice_area, 0.0)
    new_ice_we = W(has_open, web.new_ice_water_eq, 0.0)
    evap_mm_s = W(has_open, web.evap_mm_s, 0.0)

    # ---- 6.-8. ice fraction (lakes.eb.c:340-470) ----
    has_icefrac = fracprv >= FRACLIM
    log_i = torch.log((2.0 + snow_rough) / snow_rough)
    log_h = torch.log(wind_h / snow_rough)
    windi = torch.clamp(wind * log_i / torch.clamp(log_h, min=c.SMALL),
                        min=1.0)
    aero_resist_i = (log_i * log_h / (c.VON_K ** 2)) / windi
    lake_ice_m = W(st.ice_area > 0.0,
                   st.ice_water_eq / torch.clamp(st.ice_area, min=1.0), 0.0)
    if blowing:
        # blowing-snow sublimation over lake ice (ice_melt.c:264-288) on the
        # lake lanes, with the reference's hard-wired frozen-pond parameters
        # as float32 scalars broadcast to the lakes
        ls_lake = (677.0 - 0.07 * st.surf_temp) \
            * c.JOULES_PER_CAL * c.GRAMS_PER_KG
        pond = {k: tair.new_tensor(v) for k, v in FROZEN_POND.items()}
        blow_lake, _ = calc_blowing_snow(
            dt_sec=dt_sec, tair=tair, last_snow=st.last_snow.to(tair.dtype),
            surf_water_m=surf_water_i, wind_2m=windi, ls=ls_lake,
            air_dens=air_density, pressure=pressure, eact=vp,
            z0_snow=snow_rough, zrh=wind_h + snow_rough,
            snowdepth=swq_i * c.RHO_W / RHOSNOW, tsnow=st.surf_temp,
            is_bare=torch.zeros_like(swq_i, dtype=torch.bool), **pond)
        blow_lake = W(swq_i > 0.0, blow_lake, 0.0)
    else:
        blow_lake = 0.0
    im = lake_ice_melt(
        swq=swq_i, surf_temp=st.surf_temp, pack_temp=st.pack_temp,
        surf_water=surf_water_i, pack_water=pack_water_i,
        lake_ice_m=lake_ice_m, hice=st.ice_height,
        rainfall_mm=rain_on_pack, snowfall_mm=snow_on_pack, tair=tair,
        wind=windi, vp_air=vp, vpd=vpd, pressure=pressure,
        air_dens=air_density, longwave_in=lw_in, net_short=sw_ice,
        tcutoff=tcutoff, ra=aero_resist_i, z_ref=wind_h + snow_rough,
        roughness=snow_rough, dt_sec=dt_sec, blowing_flux=blow_lake,
        active=active & has_icefrac)

    ui = water_under_ice(
        temp=st.temp, grid=grid, lat=lat, tcutoff=tcutoff, wind=wind,
        sw_ice=sw_ice, hice=st.ice_height,
        sdepth=im.swq * c.RHO_W / RHOSNOW, dt_sec=dt_sec,
        active=active & has_icefrac)

    iwe_after_top = im.lake_ice_m * st.ice_area
    li = lakeice(sw_ice=sw_ice, fracprv=fracprv, dt_sec=dt_sec,
                 snowflux=im.terms.qf, qw=ui.qw, sw_absorbed=im.sw_under_ice,
                 ice_water_eq=iwe_after_top, volume=st.volume - new_ice_we,
                 sarea=grid.surface[..., 0])
    iwe_bot = W(iwe_after_top > 0.0, li.ice_water_eq, iwe_after_top)
    e_melt_bot = W(iwe_after_top > 0.0, li.energy_ice_melt_bot, 0.0)

    # fracprv < FRACLIM: a residual thin ice slab is dumped into the lake
    dump = ~has_icefrac & (fracprv > 0.0)

    def I(new, old):
        return W(has_icefrac, new, old)

    swq_i2 = I(im.swq, swq_i)
    surf_temp2 = I(im.surf_temp, st.surf_temp)
    pack_temp2 = I(im.pack_temp, st.pack_temp)
    surf_water_i2 = I(im.surf_water, surf_water_i)
    pack_water_i2 = I(im.pack_water, pack_water_i)
    tempi2 = I(im.surf_temp, W(dump, 0.0, st.tempi))
    t_ice = W(has_icefrac[..., None], ui.temp, st.temp)
    iwe2 = W(has_icefrac, iwe_bot, W(dump, 0.0, st.ice_water_eq))
    areai2 = W(has_icefrac, st.ice_area, 0.0)
    vol_subl = W(has_icefrac,
                 -(lake_ice_m - im.lake_ice_m - im.ice_melt_m) * st.ice_area,
                 0.0)

    atmos_latent = atmos_latent + W(
        has_icefrac, fracprv * (im.terms.latent + im.terms.latent_sub), 0.0)
    atmos_sensible = atmos_sensible + W(has_icefrac,
                                        fracprv * im.terms.sensible, 0.0)
    net_long = net_long + W(has_icefrac, fracprv * im.terms.lwnet, 0.0)
    net_short = net_short + W(has_icefrac, fracprv * sw_ice, 0.0)
    delta_h = delta_h + W(has_icefrac, fracprv * ui.delta_h, 0.0)
    grnd_flux = grnd_flux - W(has_icefrac,
                              fracprv * ui.energy_out_bottom, 0.0)
    advection = W(has_icefrac, fracprv * im.terms.advection, 0.0)
    refreeze = refreeze + W(
        has_icefrac, fracprv * (im.terms.refreeze_energy + e_melt_bot), 0.0)
    tsurf_blend = tsurf_blend + W(has_icefrac, fracprv * im.surf_temp, 0.0)

    # ---- 9. column average, 10. energy closure ----
    t_avg = colavg(t_open, t_ice, fracprv, grid)
    energy_error = (net_short + net_long + atmos_sensible + atmos_latent
                    - delta_h + grnd_flux + refreeze + advection)

    # ---- 11. final bookkeeping (lakes.eb.c:480-540) ----
    snowmelt_m3 = W(has_icefrac, im.melt_m * fracprv * sarea, 0.0)
    vapor_m3 = W(has_icefrac, im.vapor_flux * fracprv * sarea, 0.0)
    evap_m3 = evap_mm_s * (1.0 - fracprv) * dt_sec * 0.001 * sarea
    swe_new = swq_i2 * fracprv
    surf_water_new = surf_water_i2 * fracprv
    pack_water_new = pack_water_i2 * fracprv

    total_ice_area = areai2 + new_ice_area
    iwe3 = iwe2 + W(new_ice_area > 0.0, new_ice_we, 0.0)
    hice = W((iwe3 > 0.0) & (total_ice_area > 0.0),
             iwe3 / torch.clamp(total_ice_area, min=c.SMALL) * c.RHO_W
             / RHOICE, 0.0)
    gone = hice <= 0.0
    thin_ice = ~gone & (hice < FRACMIN)
    total_ice_area = W(gone, 0.0, W(thin_ice,
                                    total_ice_area * hice / FRACMIN,
                                    total_ice_area))
    hice = W(gone, 0.0, W(thin_ice, FRACMIN, hice))

    keep = ~active

    def K(new, old):
        return W(keep, old, new)

    new_state = LakeState(
        volume=K(st.volume + vol_subl, st.volume),
        temp=W(keep[..., None], st.temp, t_avg),
        ice_water_eq=K(torch.clamp(iwe3, min=0.0), st.ice_water_eq),
        ice_area=st.ice_area,     # areai updates next step
        ice_height=K(hice, st.ice_height),
        swe=K(swe_new, st.swe), tempi=K(tempi2, st.tempi),
        surf_temp=K(surf_temp2, st.surf_temp),
        pack_temp=K(pack_temp2, st.pack_temp),
        surf_water=K(surf_water_new, st.surf_water),
        pack_water=K(pack_water_new, st.pack_water),
        salbedo=K(alb.salbedo, st.salbedo),
        last_snow=K(alb.last_snow, st.last_snow),
        melting=W(keep, st.melting, alb.melting))

    def Zm(x):
        return W(keep, 0.0, x)

    precip_in_m3 = (ice_throughfall + (rain_on_pack + snow_on_pack) / 1000.0
                    * fracprv * sarea)
    return SolveLakeResult(
        state=new_state, ice_throughfall_m3=Zm(ice_throughfall),
        store_dump_m3=Zm(store_dump), precip_in_m3=Zm(precip_in_m3),
        snowmelt_m3=Zm(snowmelt_m3), evap_m3=Zm(evap_m3),
        vapor_flux_m3=Zm(vapor_m3), new_ice_area=Zm(total_ice_area),
        sarea=sarea, ldepth=ldepth, fracprv=Zm(fracprv),
        albedo_lake=W(keep, 0.0, albedo_lake), net_short=Zm(net_short),
        net_long=Zm(net_long), sensible=Zm(atmos_sensible),
        latent=Zm(atmos_latent), delta_h=Zm(-delta_h),
        grnd_flux=Zm(grnd_flux), refreeze_energy=Zm(refreeze),
        advection=Zm(advection), energy_error=Zm(energy_error),
        tsurf=Zm(tsurf_blend), ice_fbflag=W(keep, False, im.surf_temp_fbflag))


# --------------------------------------------------------------------------
# Water balance + the step (water_balance, lakes.eb.c:1870-2200)
# --------------------------------------------------------------------------

class WaterBalance(NamedTuple):
    """The lakes' water balance after solve_lake (lake_water_balance)."""
    volume: torch.Tensor
    evap_m3: torch.Tensor
    runoff_out_m3: torch.Tensor
    baseflow_out_m3: torch.Tensor
    recharge_m3: torch.Tensor
    max_newfraction: torch.Tensor
    depth: torch.Tensor
    sarea: torch.Tensor
    water_error_mm: torch.Tensor
    lane_nf: torch.Tensor            # [c, lane]
    lane_maxnf: torch.Tensor         # [c, lane]
    wetland_dmoist_mm: torch.Tensor  # [c, lane, nl], None without wetland


def lake_water_balance_plain(lp: LakeParams, st: LakeState,
                             res: SolveLakeResult, *, runoff_in_m3,
                             baseflow_in_m3, ds, dsmax, ws_arno, dt_sec,
                             c_expt, wetland_moist, wetland_max_moist,
                             wetland_rel_moist, active,
                             lane_mask) -> WaterBalance:
    """Plain version of the `lake_water_balance` kernel: the water balance
    once PER HRU lane after solve_lake's energy budget (`res`), from the
    step's starting state `st` (lakes.eb.c:1965-2247; vic_tpu/physics/
    lake.py:1553): each lane's gains and evaporation cap, new extent,
    flooding recharge of its wetland soil, lake-bed baseflow, weir outflow
    with the growth caps and the dry test, then the final depth, area and
    closure telemetry. wetland_moist: [cell, lane, nl] or None,
    wetland_max_moist broadcasting to it, wetland_rel_moist [cell, lane] or
    None, lane_mask [cell, lane]."""
    basin0 = lp.basin[..., 0]
    s1 = res.state
    sarea = res.sarea
    lakefrac = torch.clamp(torch.maximum(sarea, st.ice_area)
                           / torch.clamp(basin0, min=1.0), 0.0, 1.0)
    store_start_m3 = st.volume + st.swe * sarea

    live = lp.has_lake & active
    inflow = runoff_in_m3 + baseflow_in_m3
    gains = res.ice_throughfall_m3 + res.store_dump_m3 + inflow \
        + res.snowmelt_m3

    dsmax_step = dsmax / 24.0
    cexp = torch.ones_like(st.volume) * 2.0 if c_expt is None else c_expt

    volume = s1.volume
    iwe = s1.ice_water_eq
    evap_call = res.evap_m3
    zero = torch.zeros_like(volume)
    gains_total = evap_total = recharge_m3 = zero
    baseflow_total = runoff_total = baseflow_out = runoff_out = zero
    max_newfraction = zero
    dmoist_lanes, nf_lanes, maxnf_lanes = [], [], []

    for h in range(lane_mask.shape[1]):
        valid = live & lane_mask[:, h]
        # gains + evaporation cap, re-booked every call (lakes.eb.c:1965-1976)
        liquid0 = torch.clamp(volume - iwe, min=0.0)
        over = evap_call > liquid0 + gains
        evap_h = W(over, torch.clamp(liquid0 + gains, min=0.0), evap_call)
        evap_call = W(valid, evap_h, evap_call)
        volume = W(valid, W(over, iwe, volume + gains - evap_h), volume)
        gains_total = gains_total + W(valid, gains, 0.0)
        evap_total = evap_total + W(valid, evap_h, 0.0)

        # new lake extent before recharge (lakes.eb.c:1999-2013)
        volume_save = volume
        liquid1 = torch.clamp(volume - iwe, min=0.0)
        surfacearea = torch.maximum(
            area_from_depth(lp, depth_from_volume(lp, liquid1)),
            res.new_ice_area)
        maxnf_h = torch.clamp(surfacearea / torch.clamp(basin0, min=1.0),
                              0.0, 1.0)
        max_newfraction = W(valid, maxnf_h, max_newfraction)

        # flooding recharge of this lane's soil (lakes.eb.c:2046-2096)
        if wetland_moist is not None:
            moist_h = wetland_moist[:, h, :]
            max_h = wetland_max_moist[:, h, :]
            grow = valid & (maxnf_h > lakefrac)
            gfrac = (maxnf_h - lakefrac) / torch.clamp(1.0 - lakefrac,
                                                       min=1e-6)
            room = torch.clamp(max_h - moist_h, min=0.0)
            want = room * gfrac[..., None]
            rech_h = _isum(want) / 1000.0 * (1.0 - lakefrac) * basin0
            liquid2 = torch.clamp(volume - iwe, min=0.0)
            enough = liquid2 > rech_h
            avail_mm = 1000.0 * liquid2 / torch.clamp(
                (maxnf_h - lakefrac) * basin0, min=c.SMALL)
            cum_before = torch.cumsum(room, dim=-1) - room
            fill = torch.minimum(torch.clamp(avail_mm[..., None] - cum_before,
                                             min=0.0), room)
            dmoist_h = W(grow[..., None],
                         W(enough[..., None], want, fill * gfrac[..., None]),
                         0.0)
            rech_h = W(grow, W(enough, rech_h, liquid2), 0.0)
            volume = volume - W(valid, rech_h, 0.0)
            recharge_m3 = recharge_m3 + W(valid, rech_h, 0.0)
            rel_moist = (torch.clamp(wetland_rel_moist[:, h], 0.0, 1.0)
                         if wetland_rel_moist is not None
                         else torch.ones_like(volume))
        else:
            dmoist_h = None
            rel_moist = torch.ones_like(volume)

        # ARNO baseflow through the lake bed (lakes.eb.c:2100-2126),
        # Dsmax/24 per call with no dt scaling (quirk kept)
        baseflow_mm = dsmax_step * ds / ws_arno * rel_moist
        over_ws = rel_moist > ws_arno
        frac2 = W(over_ws, (rel_moist - ws_arno)
                  / torch.clamp(1.0 - ws_arno, min=c.SMALL), 0.0)
        baseflow_mm = baseflow_mm + W(
            over_ws, dsmax_step * (1.0 - ds / ws_arno)
            * torch.pow(torch.clamp(frac2, min=c.SMALL), cexp), 0.0)
        baseflow_mm = torch.clamp(baseflow_mm, min=0.0)
        liquid3 = torch.clamp(volume - iwe, min=0.0)
        area3 = area_from_depth(lp, depth_from_volume(lp, liquid3))
        bf_h = torch.minimum(torch.clamp(baseflow_mm * area3 / 1000.0,
                                         min=0.0), liquid3)
        volume = volume - W(valid, bf_h, 0.0)
        baseflow_total = baseflow_total + W(valid, bf_h, 0.0)
        baseflow_out = W(valid, bf_h, baseflow_out)

        # weir outflow (lakes.eb.c:2152-2200)
        liquid4 = torch.clamp(volume - iwe, min=0.0)
        ldepth4 = depth_from_volume(lp, liquid4)
        circum = 2.0 * math.pi * torch.sqrt(torch.clamp(area3, min=0.0)
                                            / math.pi)
        head = ldepth4 - lp.mindepth
        ro_h = W(head > 0.0,
                 lp.wfrac * circum * dt_sec * 1.6
                 * torch.pow(torch.clamp(head, min=0.0), 1.5), 0.0)
        ro_h = torch.minimum(ro_h, liquid4)
        ro_h = torch.minimum(torch.clamp(ro_h, min=0.0),
                             torch.clamp(volume - lp.minvolume, min=0.0))
        vol_after_weir = volume - W(valid, ro_h, 0.0)
        # growth caps (lakes.eb.c:2183-2200)
        excess_save = torch.clamp(vol_after_weir - volume_save, min=0.0)
        ro_h = ro_h + W(valid, excess_save, 0.0)
        vol_after_weir = vol_after_weir - W(valid, excess_save, 0.0)
        cap = torch.maximum(lp.maxvolume, iwe)
        excess_max = W(vol_after_weir - lp.maxvolume > c.SMALL,
                       torch.clamp(vol_after_weir - cap, min=0.0), 0.0)
        ro_h = ro_h + W(valid, excess_max, 0.0)
        vol_after_weir = vol_after_weir - W(valid, excess_max, 0.0)
        vol_after_weir = W(vol_after_weir < c.SMALL, 0.0, vol_after_weir)
        # the liquid depth vanishes (activenod == 0, lakes.eb.c:2240-2247)
        liquid5 = torch.clamp(vol_after_weir - iwe, min=0.0)
        dry = depth_from_volume(lp, liquid5) <= c.SMALL
        ro_h = ro_h + W(valid & dry, liquid5, 0.0)
        vol_after_weir = W(valid & dry, iwe, vol_after_weir)
        volume = W(valid, vol_after_weir, volume)
        runoff_total = runoff_total + W(valid, ro_h, 0.0)
        runoff_out = W(valid, ro_h, runoff_out)

        # per-lane final fraction for the storage advection
        liq_f = torch.clamp(volume - iwe, min=0.0)
        ar_f = torch.maximum(area_from_depth(lp, depth_from_volume(lp, liq_f)),
                             res.new_ice_area)
        nf_lanes.append(torch.clamp(ar_f / torch.clamp(basin0, min=1.0),
                                    0.0, 1.0))
        maxnf_lanes.append(maxnf_h)
        if dmoist_h is not None:
            dmoist_lanes.append(dmoist_h)

    dmoist = torch.stack(dmoist_lanes, 1) if dmoist_lanes else None
    lane_nf = torch.stack(nf_lanes, 1)
    lane_maxnf = torch.stack(maxnf_lanes, 1)

    liquid5 = torch.clamp(volume - iwe, min=0.0)
    ldepth5 = depth_from_volume(lp, liquid5)
    dry = ldepth5 <= c.SMALL
    ldepth5 = W(dry, 0.0, ldepth5)
    area5 = area_from_depth(lp, W(dry, 0.0, ldepth5))
    sarea_end = torch.maximum(area5, res.new_ice_area)

    # closure telemetry: every pass after the first re-adds the same gains
    # (the reference's per-HRU quirk) and is credited as influx
    extra_gains = torch.clamp(gains_total - gains, min=0.0)
    store_end_m3 = volume + s1.swe * sarea
    water_error_m3 = (store_end_m3 - store_start_m3) - (
        res.precip_in_m3 + inflow + extra_gains - evap_total
        - res.vapor_flux_m3 - recharge_m3 - baseflow_total - runoff_total)
    water_error_mm = W(live, water_error_m3 / torch.clamp(sarea, min=1.0)
                       * 1000.0, 0.0)

    return WaterBalance(
        volume=volume, evap_m3=evap_call, runoff_out_m3=runoff_out,
        baseflow_out_m3=baseflow_out, recharge_m3=recharge_m3,
        max_newfraction=max_newfraction, depth=ldepth5, sarea=sarea_end,
        water_error_mm=water_error_mm, lane_nf=lane_nf,
        lane_maxnf=lane_maxnf, wetland_dmoist_mm=dmoist)


def lake_water_balance(lp: LakeParams, st: LakeState, res: SolveLakeResult,
                       **inputs) -> WaterBalance:
    """The water balance after solve_lake: `lake_water_balance_plain` on
    CPU tensors, the `lake_water_balance` kernel on CUDA tensors (same
    arguments)."""
    if st.volume.device.type == "cpu":
        return lake_water_balance_plain(lp, st, res, **inputs)
    return kernels.lake_water_balance(lp, st, res, **inputs)


class LakeStepResult(NamedTuple):
    state: LakeState
    evap_m3: torch.Tensor
    runoff_out_m3: torch.Tensor
    baseflow_out_m3: torch.Tensor
    depth: torch.Tensor
    sarea: torch.Tensor
    ice_fract: torch.Tensor
    surf_temp: torch.Tensor
    recharge_m3: torch.Tensor
    wetland_dmoist_mm: torch.Tensor
    max_newfraction: torch.Tensor
    lane_nf: torch.Tensor
    lane_maxnf: torch.Tensor
    snowmelt_m3: torch.Tensor
    vapor_flux_m3: torch.Tensor
    precip_in_m3: torch.Tensor
    water_error_mm: torch.Tensor
    energy_error: torch.Tensor
    albedo_lake: torch.Tensor
    net_short: torch.Tensor
    net_long: torch.Tensor
    sensible: torch.Tensor
    latent: torch.Tensor
    delta_h: torch.Tensor
    grnd_flux: torch.Tensor
    refreeze_energy: torch.Tensor
    advection: torch.Tensor
    ice_fbflag: torch.Tensor


def lake_step(lp: LakeParams, st: LakeState, *, tair, wind, sw_in, lw_in,
              vp_air, vpd, pressure, air_density, rainfall_mm, snowfall_mm,
              runoff_in_m3, baseflow_in_m3, lat, day_in_year, wind_h,
              snow_rough, new_snow_alb, alb_accum_a, alb_accum_b,
              alb_thaw_a, alb_thaw_b, ds, dsmax, ws_arno, dt_sec,
              c_expt=None, wetland_moist=None, wetland_max_moist=None,
              wetland_rel_moist=None, active=None, lane_mask=None,
              blowing: bool = False) -> LakeStepResult:
    """One model step: solve_lake then the water balance once PER HRU lane,
    as full_energy.c:793-800 calls it (vic_tpu/physics/lake.py:1553; the
    quirk is kept: inflow and evaporation are re-booked on every pass and
    the last lane's fluxes are the ones reported). wetland_moist etc.:
    [cell, lane, nl] with lane_mask [cell, lane]. blowing: the blowing-snow
    flux over lake ice (BLOWING)."""
    if active is None:
        active = torch.ones_like(st.volume, dtype=torch.bool)
    res = solve_lake(
        lp, st, snowfall_mm=snowfall_mm, rainfall_mm=rainfall_mm, tair=tair,
        wind=wind, vp=vp_air, sw_in=sw_in, lw_in=lw_in, vpd=vpd,
        pressure=pressure, air_density=air_density, dt_sec=dt_sec,
        wind_h=wind_h, snow_rough=snow_rough, lat=lat,
        day_in_year=day_in_year, new_snow_alb=new_snow_alb,
        alb_accum_a=alb_accum_a, alb_accum_b=alb_accum_b,
        alb_thaw_a=alb_thaw_a, alb_thaw_b=alb_thaw_b, active=active,
        blowing=blowing)

    if wetland_moist is not None and wetland_moist.dim() == 2:
        wetland_moist = wetland_moist[:, None, :]
        if wetland_max_moist.dim() == 2:
            wetland_max_moist = wetland_max_moist[:, None, :]
        if wetland_rel_moist is not None:
            wetland_rel_moist = wetland_rel_moist[:, None]
    n_lane = 1 if wetland_moist is None else wetland_moist.shape[1]
    if lane_mask is None:
        lane_mask = torch.ones(st.volume.shape + (n_lane,), dtype=torch.bool,
                               device=st.volume.device)
    if wetland_max_moist is not None and wetland_max_moist.dim() == 2:
        wetland_max_moist = wetland_max_moist[:, None, :].expand(
            wetland_moist.shape)

    wb = lake_water_balance(
        lp, st, res, runoff_in_m3=runoff_in_m3,
        baseflow_in_m3=baseflow_in_m3, ds=ds, dsmax=dsmax, ws_arno=ws_arno,
        dt_sec=dt_sec, c_expt=c_expt, wetland_moist=wetland_moist,
        wetland_max_moist=wetland_max_moist,
        wetland_rel_moist=wetland_rel_moist, active=active,
        lane_mask=lane_mask)
    s1 = res.state
    live = lp.has_lake & active
    keep = ~live

    def K(new, old):
        return W(keep, old, new)

    new_state = LakeState(
        volume=K(wb.volume, st.volume),
        temp=W(keep[..., None], st.temp, s1.temp),
        ice_water_eq=K(s1.ice_water_eq, st.ice_water_eq),
        ice_area=K(res.new_ice_area, st.ice_area),   # full_energy.c:229
        ice_height=K(s1.ice_height, st.ice_height),
        swe=K(s1.swe, st.swe), tempi=K(s1.tempi, st.tempi),
        surf_temp=K(s1.surf_temp, st.surf_temp),
        pack_temp=K(s1.pack_temp, st.pack_temp),
        surf_water=K(s1.surf_water, st.surf_water),
        pack_water=K(s1.pack_water, st.pack_water),
        salbedo=K(s1.salbedo, st.salbedo),
        last_snow=K(s1.last_snow, st.last_snow),
        melting=W(keep, st.melting, s1.melting))

    def Zm(x):
        return W(keep, 0.0, x)

    return LakeStepResult(
        state=new_state, evap_m3=Zm(wb.evap_m3),
        runoff_out_m3=Zm(wb.runoff_out_m3),
        baseflow_out_m3=Zm(wb.baseflow_out_m3), depth=Zm(wb.depth),
        sarea=Zm(wb.sarea),
        ice_fract=Zm(torch.clamp(res.new_ice_area
                                 / torch.clamp(wb.sarea, min=1.0),
                                 0.0, 1.0)),
        surf_temp=Zm(res.tsurf), recharge_m3=Zm(wb.recharge_m3),
        wetland_dmoist_mm=(None if wb.wetland_dmoist_mm is None
                           else W(keep[:, None, None], 0.0,
                                  wb.wetland_dmoist_mm)),
        max_newfraction=W(live, wb.max_newfraction, 0.0),
        lane_nf=W(keep[:, None], 0.0, wb.lane_nf),
        lane_maxnf=W(keep[:, None], 0.0, wb.lane_maxnf),
        snowmelt_m3=Zm(res.snowmelt_m3), vapor_flux_m3=Zm(res.vapor_flux_m3),
        precip_in_m3=Zm(res.precip_in_m3), water_error_mm=wb.water_error_mm,
        energy_error=Zm(res.energy_error), albedo_lake=Zm(res.albedo_lake),
        net_short=Zm(res.net_short), net_long=Zm(res.net_long),
        sensible=Zm(res.sensible), latent=Zm(res.latent),
        delta_h=Zm(res.delta_h), grnd_flux=Zm(res.grnd_flux),
        refreeze_energy=Zm(res.refreeze_energy),
        advection=Zm(res.advection),
        ice_fbflag=W(keep, False, res.ice_fbflag))


def initial_lake_state(lp: LakeParams, avg_temp) -> LakeState:
    """Cold-start lake state (initialize_lake.c:7-180); avg_temp [c]."""
    vol0 = volume_from_depth(lp, lp.depth_in)
    n_cell = vol0.shape[0]
    temp0 = torch.clamp(avg_temp, min=4.0)[:, None] * torch.ones(
        (1, MAX_LAKE_NODES), dtype=vol0.dtype, device=vol0.device)
    zc = torch.zeros_like(vol0)
    return LakeState(volume=vol0, temp=temp0, ice_water_eq=zc, ice_area=zc,
                     ice_height=zc, swe=zc, tempi=zc, surf_temp=zc,
                     pack_temp=zc, surf_water=zc, pack_water=zc, salbedo=zc,
                     last_snow=zc, melting=torch.zeros(
                         n_cell, dtype=torch.bool, device=vol0.device))
