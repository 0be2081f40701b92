"""Two-layer snowpack: rain/snow partition, albedo decay, densification and
the surface-layer energy balance with the two-pass 0 C melt pattern.

Counterpart of `vic_tpu/physics/snow.py`; the BLOWING option's mass flux
enters the surface vapor flux, and under SPATIAL_SNOW the pack covers a
fraction of the lane (`calc_snow_coverage`, the depletion curve) and takes
the sensible heat advected from its snow-free patches
(`advected_sensible_heat`). The balance's terms at 0 C (the melt test),
the subfreezing surface temperature, a Brent root of `snow_energy_terms`,
and the terms at that temperature come from one call: on the CPU
`snowpack_brent_plain`, on a CUDA device the `snowpack_brent` kernel
(`csrc/vic_kernels.cu` on `csrc/lane_brent.cuh`, its residual in
`csrc/pack_residuals.cuh`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants as c
from ..ops.rootfind import batched_brent
from .evap import svp


def calc_rainonly(air_temp, prec, max_snow_temp, min_rain_temp,
                  method: int = 1):
    """Rain part of precip (mm): 0=VIC_412 linear ramp, 1=KIENZLE S-curve
    (calc_rainonly.c:12-120)."""
    if method == 0:
        frac = torch.clamp((air_temp - min_rain_temp)
                           / torch.clamp(max_snow_temp - min_rain_temp,
                                         min=1e-10), 0.0, 1.0)
        return frac * prec
    tt = min_rain_temp
    d = 1.4 * max_snow_temp
    x = (air_temp - tt) / d
    x2 = x * x
    e1 = 5.0 * (x * x2)
    e2 = 6.76 * x2
    e3 = 3.19 * x
    rfrac = torch.where(air_temp <= tt, e1 + e2 + e3 + 0.5,
                        e1 - e2 + e3 + 0.5)
    return torch.clamp(rfrac, 0.0, 1.0) * prec


def new_snow_density(air_temp, snthrm: bool = False):
    """Fresh snow density kg/m^3."""
    if snthrm:
        return 67.9 + 51.3 * torch.exp(air_temp / 2.6)
    tf = air_temp * 9.0 / 5.0 + 32.0
    t = tf / 100.0
    return torch.where(tf > 0.0, c.NEW_SNOW_DENSITY + 1000.0 * (t * t),
                       torch.full_like(tf, c.NEW_SNOW_DENSITY))


def snow_albedo(new_snow_mm, swq, depth, albedo, cold_content, dt_hours,
                last_snow, melting, new_snow_alb, accum_a, accum_b,
                thaw_a, thaw_b, sun1999: bool = False):
    """Snow surface albedo decay; last_snow = float steps since snowfall."""
    if sun1999:
        deep = 0.5 + (albedo - 0.5) * torch.exp(
            torch.full_like(albedo, -0.01 * dt_hours / 24.0))
        shallow_dry = albedo - 0.006 * dt_hours / 24.0
        shallow_melt = albedo - 0.071 * dt_hours / 24.0
        aged = torch.where(depth > 0.025, deep,
                           torch.where(cold_content < 0.0, shallow_dry,
                                       shallow_melt))
        aged = torch.clamp(aged, min=0.0)
    else:
        days = last_snow * dt_hours / 24.0
        accum = new_snow_alb * torch.pow(accum_a, torch.pow(days, accum_b))
        thaw = new_snow_alb * torch.pow(thaw_a, torch.pow(days, thaw_b))
        aged = torch.where((cold_content < 0.0) & ~melting, accum, thaw)
    return torch.where((new_snow_mm > c.TRACESNOW) & (cold_content < 0.0),
                       new_snow_alb, torch.where(swq > 0.0, aged, 0.0))


def snow_density_update(swq_before, depth_before, density_before,
                        surf_temp, new_snow_mm, air_temp, dt_hours,
                        liquid_water=None, snthrm: bool = False):
    """Snowpack densification (snow_utility.c:snow_density), kg/m^3."""
    dens_new = new_snow_density(air_temp, snthrm)
    tavg = surf_temp + c.KELVIN
    W = torch.where
    if snthrm:
        density = W(new_snow_mm > 0.0,
                    W(depth_before > 0.0, density_before, dens_new),
                    density_before)
        dexpf = torch.exp(-c.SNDENS_C1 * (c.KELVIN - tavg))
        dm = W((new_snow_mm > 0.0) & (dens_new > 0.0),
               torch.clamp(1.15 * dens_new, min=c.SNDENS_DMLIMIT),
               torch.full_like(dens_new, c.SNDENS_DMLIMIT))
        c3 = W(density <= dm, 1.0, torch.exp(-0.046 * (density - dm)))
        lw = liquid_water if liquid_water is not None \
            else torch.zeros_like(swq_before)
        wet = W(depth_before > 0.0,
                lw / torch.clamp(depth_before, min=1e-10), 0.0) > 0.01
        c4 = W(wet, 2.0, 1.0)
        ddz1 = -c.SNDENS_C2 * c3 * c4 * dexpf
        swq_load = new_snow_mm / 1000.0 + c.SNDENS_F * swq_before
        ps = 0.5 * c.G * c.RHO_W * swq_load
        ddz2 = W(new_snow_mm > 0.0,
                 -ps / c.SNDENS_ETA0 * torch.exp(
                     -(-c.SNDENS_C5 * (tavg - c.KELVIN)
                       + c.SNDENS_C6 * density)),
                 0.0)
        cr = -ddz1 - ddz2
        return density * (1.0 + cr * dt_hours * c.SEC_PER_HOUR)

    # DENS_BRAS
    depth, swq = depth_before, swq_before
    dens_safe = torch.clamp(dens_new, min=1.0)
    delta_depth = W(
        (new_snow_mm > 0.0) & (depth > 0.0),
        torch.minimum(((new_snow_mm / 25.4) * (depth / 0.0254)
                       / torch.clamp(swq / 0.0254, min=1e-10)
                       * torch.pow(torch.clamp(depth / 0.0254, min=1e-10)
                                   / 10.0, 0.35)) * 0.0254,
                      0.9 * depth),
        0.0)
    depth_new_snow = new_snow_mm / dens_safe
    has_old = depth > 0.0
    depth1 = W(new_snow_mm > 0.0,
               W(has_old, depth - delta_depth + depth_new_snow,
                 1000.0 * (swq + new_snow_mm / 1000.0) / dens_safe),
               depth)
    swq1 = swq + new_snow_mm / 1000.0
    density = W(new_snow_mm > 0.0,
                W(has_old, 1000.0 * swq1 / torch.clamp(depth1, min=1e-10),
                  dens_new),
                W(depth > 0.0, 1000.0 * swq / torch.clamp(depth, min=1e-10),
                  density_before))
    overburden = 0.5 * c.G * c.RHO_W * swq1
    viscosity = c.SNDENS_ETA0 * torch.exp(-c.SNDENS_C5 * (tavg - c.KELVIN)
                                          + c.SNDENS_C6 * density)
    delta_age = torch.minimum(
        overburden / viscosity * depth1 * dt_hours * c.SEC_PER_HOUR,
        0.9 * depth1)
    depth2 = depth1 - delta_age
    return W(depth2 > 0.0, 1000.0 * swq1 / torch.clamp(depth2, min=1e-10),
             density)


def stability_correction(z, d, tsurf, tair, wind, z0):
    """Richardson-number stability factor (StabilityCorrection.c:41-80)."""
    denom_t = ((tair + c.KELVIN) + (tsurf + c.KELVIN)) / 2.0
    wind2 = torch.clamp(wind * wind, min=1e-10)
    ri = c.G * (tair - tsurf) * (z - d) / (denom_t * wind2)
    ri_limit = (tair + c.KELVIN) / (denom_t * (torch.log((z - d) / z0) + 5.0))
    ri = torch.minimum(ri, ri_limit)
    s = 1.0 - ri / 0.2
    stable = s * s
    unstable = torch.sqrt(1.0 - 16.0 * torch.clamp(ri, min=-0.5))
    corr = torch.where(ri > 0.0, stable, unstable)
    return torch.where(tsurf == tair, 1.0, corr)


def latent_heat_from_snow(air_dens, eact_air, lv, press, ra, tmean, vpd,
                          blowing_flux=0.0):
    """Latent heat fluxes over snow (latent_heat_from_snow.c:66-91).
    blowing_flux: the blowing-snow mass flux, kg/m2/s (BLOWING).
    Returns (latent, latent_sub, vapor mass flux kg/m2/s)."""
    es_snow = svp(tmean)
    surface_flux = air_dens * (c.EPS_RATIO / press) * (eact_air - es_snow) / ra
    surface_flux = torch.where((vpd == 0.0) & (surface_flux < 0.0), 0.0,
                               surface_flux)
    vapor_flux = surface_flux + blowing_flux
    ls = (677.0 - 0.07 * tmean) * c.JOULES_PER_CAL * c.GRAMS_PER_KG
    latent = torch.where(tmean >= 0.0, lv * vapor_flux, 0.0)
    latent_sub = torch.where(tmean >= 0.0, 0.0, ls * vapor_flux)
    return latent, latent_sub, vapor_flux


def advected_sensible_heat(snow_cover_fract, air_dens, tair, tgrnd, ra):
    """Sensible heat advected from snow-free patches onto the snow-covered
    ones (advected_sensible_heat.c:8-48, Marsh, Pomeroy and Neumann 1997);
    zero where the coverage is 0. Under SPATIAL_SNOW only."""
    scf = snow_cover_fract
    qbare = air_dens * c.CP * (tair - tgrnd) / ra
    fs = torch.where(
        scf > 0.6, 1.0,
        torch.where(scf > 0.5, torch.pow(10.0, 3.0 * scf - 1.8),
                    torch.where(scf > 0.2,
                                torch.pow(10.0, 5.6667 * scf - 3.1333),
                                0.01)))
    cov = torch.clamp(scf, min=c.SMALL)
    qadv = qbare * (1.0 - scf) / cov * fs
    return torch.where(scf > 0.0, qadv, 0.0)


class SnowEBTerms(NamedTuple):
    rest: torch.Tensor
    refreeze_energy: torch.Tensor
    vapor_flux: torch.Tensor      # m/step
    latent: torch.Tensor
    latent_sub: torch.Tensor
    sensible: torch.Tensor
    advection: torch.Tensor
    delta_cc: torch.Tensor
    grnd_flux: torch.Tensor
    net_long: torch.Tensor
    advected_sensible: torch.Tensor


def snow_energy_terms(tsurf, *, dt, ra, z_ref, roughness, air_dens, vp_air,
                      longwave_in, lv, pressure, rain_m, net_short, vpd, wind,
                      old_tsurf, snow_depth, snow_density, surf_water,
                      surface_swq, tair, tgrnd, blowing_flux,
                      snow_cover_fract=None) -> SnowEBTerms:
    """Snowpack surface energy balance at candidate tsurf
    (SnowPackEnergyBalance.c:calculate); with SPATIAL_SNOW's
    snow_cover_fract, the advected sensible heat too (:132-143). The CUDA
    residual `SnowpackResidual` in csrc/pack_residuals.cuh is a
    line-for-line copy."""
    ra_corr = torch.where(
        wind > 0.0,
        ra / stability_correction(z_ref, 0.0, tsurf, tair, wind, roughness),
        c.HUGE_RESIST)
    tkelv = tsurf + c.KELVIN
    tk2 = tkelv * tkelv
    net_long = longwave_in - c.STEFAN_B * (tk2 * tk2)
    net_rad = net_short + net_long
    sensible = air_dens * c.CP * (tair - tsurf) / ra_corr
    latent, latent_sub, vapor_mass_flux = latent_heat_from_snow(
        air_dens, vp_air, lv, pressure, ra_corr, tsurf, vpd, blowing_flux)
    vapor_flux = vapor_mass_flux * dt / c.RHO_W

    advection = torch.where(tsurf == 0.0, c.CH_WATER * tair * rain_m / dt, 0.0)
    delta_cc = c.CH_ICE * surface_swq * (tsurf - old_tsurf) / dt
    grnd_flux = torch.where(
        snow_depth > 0.0,
        c.K_SNOW * snow_density * snow_density * (tgrnd - tsurf)
        / torch.clamp(snow_depth, min=1e-10) / dt,
        0.0)
    refreeze_energy = surf_water * c.LF * c.RHO_W / dt
    rest = net_rad + sensible + latent + latent_sub + advection
    if snow_cover_fract is None:
        adv_sens = torch.zeros_like(sensible)
    else:
        adv_sens = advected_sensible_heat(snow_cover_fract, air_dens, tair,
                                          tgrnd, ra_corr)
        rest = rest + adv_sens
    rest = rest - delta_cc + grnd_flux
    # two-pass 0 C pattern (SnowPackEnergyBalance.c:186-195)
    melt_branch = (tsurf == 0.0) & (rest > -refreeze_energy)
    return SnowEBTerms(
        rest=torch.where(melt_branch, 0.0, rest + refreeze_energy),
        refreeze_energy=torch.where(melt_branch, -rest, refreeze_energy),
        vapor_flux=vapor_flux, latent=latent, latent_sub=latent_sub,
        sensible=sensible, advection=advection, delta_cc=delta_cc,
        grnd_flux=grnd_flux, net_long=net_long, advected_sensible=adv_sens)


class SnowpackSolve(NamedTuple):
    """snow_melt's solve of the pack's surface balance: the Brent's result
    (ops.rootfind.RootResult's fields), the melt test (the balance at 0 C
    is 0), and the balance's terms at 0 C and at the accepted temperature
    (the root, or old_tsurf where the lane did not converge)."""
    root: torch.Tensor
    converged: torch.Tensor
    bracketed: torch.Tensor
    iterations: torch.Tensor
    melt_cond: torch.Tensor
    terms0: SnowEBTerms
    terms_b: SnowEBTerms


def snowpack_brent_plain(lo, hi, active, *, dt, max_iter, max_tries,
                         **inputs):
    """Plain version of the `snowpack_brent` kernel: snow_energy_terms at
    0 C and its melt test (snow.py:387 of the JAX package), expand-then-
    Brent on `snow_energy_terms(t).rest` on the lanes of `active` (None:
    every lane) that neither melt at 0 C nor are thin (:443), and the terms
    at the accepted temperature (:448). A SnowpackSolve."""
    if inputs.get("blowing_flux") is None:
        inputs = dict(inputs, blowing_flux=0.0)
    terms0 = snow_energy_terms(torch.zeros_like(lo), dt=dt, **inputs)
    melt_cond = terms0.rest == 0.0
    # INCLUDE_SNOW candidacy (snow_melt.c:324)
    thin = ~melt_cond & (inputs["surface_swq"] <= c.MIN_SWQ_EB_THRES)
    solved = ~melt_cond & ~thin
    if active is not None:
        solved = solved & active
    res = batched_brent(
        lambda t: snow_energy_terms(t, dt=dt, **inputs).rest, lo, hi,
        max_iter=max_iter, max_tries=max_tries, active=solved)
    b_surf_temp = torch.where(res.converged, res.root,
                              inputs["old_tsurf"])   # TFALLBACK
    return SnowpackSolve(*res, melt_cond=melt_cond, terms0=terms0,
                         terms_b=snow_energy_terms(b_surf_temp, dt=dt,
                                                   **inputs))


class SnowMeltResult(NamedTuple):
    swq: torch.Tensor
    surf_temp: torch.Tensor
    pack_temp: torch.Tensor
    surf_water: torch.Tensor
    pack_water: torch.Tensor
    melt: torch.Tensor          # mm/step
    vapor_flux: torch.Tensor    # m/step, loss positive
    cold_content: torch.Tensor
    qnet: torch.Tensor
    surf_temp_fbflag: torch.Tensor
    firn_to_ice: torch.Tensor
    terms: SnowEBTerms
    include_snow: torch.Tensor
    inc_advection0: torch.Tensor


def snow_melt(*, swq, surf_temp, pack_temp, surf_water, pack_water,
              snow_depth, snow_density, coldcontent, rainfall_mm, snowfall_mm,
              air_temp, tcanopy, tgrnd, wind, vp_air, vpd, air_dens,
              pressure, longwave_in, net_short, lv, ra, z_ref, roughness,
              dt_sec, max_iter: int = 30, active_mask=None,
              is_glacier=None, blowing_flux=None,
              snow_cover_fract=None) -> SnowMeltResult:
    """Two-layer snowpack mass/energy update (snow_melt.c:119-560); snow
    states in m of water, precip in mm/step. See vic_tpu/physics/snow.py.
    blowing_flux: the BLOWING option's mass flux (kg/m2/s), a tensor that
    broadcasts to the lanes; none (zero) by default. The balance at 0 C,
    the Brent solve and the balance at its root are one call (K2 on the
    card, snowpack_brent_plain on the CPU). snow_cover_fract:
    SPATIAL_SNOW's coverage, which puts the advected sensible heat in the
    pack's balance; none by default."""
    W = torch.where
    MSW = c.MAX_SURFACE_SWE
    snowfall = snowfall_mm / 1000.0
    rainfall = rainfall_mm / 1000.0
    old_tsurf = surf_temp

    ice = swq - pack_water - surf_water
    surface_swq = torch.clamp(ice, max=MSW)
    pack_swq = ice - surface_swq
    surface_cc = c.CH_ICE * surface_swq * surf_temp
    pack_cc = c.CH_ICE * pack_swq * pack_temp
    snowfall_cc = W(air_temp > 0.0, 0.0, c.CH_ICE * snowfall * air_temp)

    # distribute fresh snowfall between surface and pack (snow_melt.c:199-222)
    room = MSW - surface_swq
    spill = (snowfall > room) & (room > c.SMALL)
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

    # firn -> glacier ice on glacier lanes (snow_melt_glac.c:110-131)
    if is_glacier is not None:
        dens_excess = snow_density - c.SNOW_SURF_DENSITY
        zco = ((c.CUTOFF_DENSITY - c.SNOW_SURF_DENSITY) * (snow_depth / 2.0)
               / torch.clamp(dens_excess, min=c.SMALL))
        density_zsnow = c.SNOW_SURF_DENSITY + 2.0 * dens_excess
        firn_raw = ((density_zsnow + c.CUTOFF_DENSITY) / (2.0 * c.RHO_W)
                    * (snow_depth - zco))
        eligible = (is_glacier & (pack_swq > 0.0) & (dens_excess > 0.0)
                    & (zco < snow_depth))
        firn_to_ice = W(eligible, torch.minimum(firn_raw, pack_swq), 0.0)
        pack_swq = pack_swq - firn_to_ice
        pack_cc = W(eligible & (pack_swq <= 0.0), 0.0, pack_cc)
    else:
        firn_to_ice = torch.zeros_like(pack_swq)

    pack_temp = W(pack_swq > 0.0,
                  pack_cc / (c.CH_ICE * torch.clamp(pack_swq, min=c.SMALL)),
                  0.0)
    ice = ice + snowfall - firn_to_ice
    surf_water = surf_water + rainfall

    term_kwargs = dict(
        ra=ra, z_ref=z_ref, roughness=roughness,
        air_dens=air_dens, vp_air=vp_air, longwave_in=longwave_in, lv=lv,
        pressure=pressure, rain_m=rainfall, net_short=net_short, vpd=vpd,
        wind=wind, old_tsurf=old_tsurf, snow_depth=snow_depth,
        snow_density=snow_density, surf_water=surf_water,
        surface_swq=surface_swq, tair=tcanopy, tgrnd=tgrnd,
        blowing_flux=blowing_flux, snow_cover_fract=snow_cover_fract)

    # the balance at 0 C and its melt test, the Brent solve of branch B
    # (subfreezing surface) and the balance at its root, in one call
    solve = snowpack_brent_plain
    res = solve(old_tsurf - c.SNOW_DT, old_tsurf + c.SNOW_DT, active_mask,
                dt=dt_sec, max_iter=max_iter, max_tries=5, **term_kwargs)
    terms0, melt_cond = res.terms0, res.melt_cond
    # INCLUDE_SNOW candidacy (snow_melt.c:324)
    thin = ~melt_cond & (surface_swq <= c.MIN_SWQ_EB_THRES)

    # ---- branch A: melt at 0 C ----
    refreeze = terms0.refreeze_energy
    refrozen_water = torch.minimum(
        torch.clamp(refreeze * dt_sec / (c.LF * c.RHO_W), min=0.0),
        surf_water)
    refz = W(refreeze >= 0.0, refrozen_water, 0.0)
    a_surface_swq = surface_swq + refz
    a_ice = ice + refz
    a_surf_water = torch.clamp(surf_water - refz, min=0.0)
    snowmelt = W(refreeze >= 0.0, 0.0,
                 torch.abs(refreeze) * dt_sec / (c.LF * c.RHO_W))
    vflux = terms0.vapor_flux
    vflux_a = W(a_surf_water < -vflux, -a_surf_water, vflux)
    a_surf_water = torch.clamp(a_surf_water + vflux_a, min=0.0)
    partial = snowmelt < a_ice
    from_pack = snowmelt <= pack_swq
    a_state = dict(
        surface_swq=W(partial, W(from_pack, a_surface_swq, a_ice - snowmelt),
                      0.0),
        pack_swq=W(partial, W(from_pack, pack_swq - snowmelt, 0.0), 0.0),
        surf_water=W(partial,
                     W(from_pack, a_surf_water + snowmelt,
                       a_surf_water + snowmelt + pack_water),
                     a_surf_water + a_ice),
        pack_water=W(partial, W(from_pack, pack_water, 0.0), 0.0),
        ice=W(partial, a_ice - snowmelt, 0.0),
        surf_temp=torch.zeros_like(swq),
        pack_temp=W(partial, pack_temp, 0.0),
        vapor_flux=vflux_a)

    # ---- branch B: subfreezing surface, at the Brent's root ----
    b_surf_temp = W(res.converged, res.root, old_tsurf)   # TFALLBACK
    fbflag = ~res.converged & ~melt_cond
    terms_b = res.terms_b

    b_surface_swq = surface_swq + surf_water
    b_ice = ice + surf_water
    bv = terms_b.vapor_flux
    short = b_surface_swq < -bv
    bv_adj = W(short, -b_surface_swq, bv)
    b_state = dict(
        surface_swq=torch.clamp(b_surface_swq + bv_adj, min=0.0),
        pack_swq=pack_swq, surf_water=torch.zeros_like(surf_water),
        pack_water=pack_water, ice=W(short, pack_swq, b_ice + bv_adj),
        surf_temp=b_surf_temp, pack_temp=pack_temp, vapor_flux=bv_adj)

    # ---- branch C (thin INCLUDE_SNOW lanes): accumulation only ----
    c_state = dict(
        surface_swq=surface_swq, pack_swq=pack_swq, surf_water=surf_water,
        pack_water=pack_water, ice=ice, surf_temp=old_tsurf,
        pack_temp=pack_temp, vapor_flux=torch.zeros_like(surf_water))
    fbflag = fbflag & ~thin

    def sel(k):
        return W(melt_cond, a_state[k], W(thin, c_state[k], b_state[k]))

    surface_swq = sel("surface_swq")
    pack_swq = sel("pack_swq")
    surf_water = sel("surf_water")
    pack_water = sel("pack_water")
    ice = sel("ice")
    surf_temp = sel("surf_temp")
    pack_temp = sel("pack_temp")
    vapor_flux = sel("vapor_flux")
    terms = SnowEBTerms(*[W(thin, 0.0, W(melt_cond, a, b))
                          for a, b in zip(terms0, terms_b)])

    # ---- liquid-water capacity + pack refreeze (snow_melt.c:446-506) ----
    max_liquid = c.SNOW_LIQUID_WATER_CAPACITY * surface_swq
    outflow1 = torch.clamp(surf_water - max_liquid, min=0.0)
    surf_water = torch.minimum(surf_water, max_liquid)

    pack_water = pack_water + outflow1
    pack_cc = c.CH_ICE * pack_swq * pack_temp
    pack_refreeze_e = pack_water * c.LF * c.RHO_W
    cold_enough = pack_cc < -pack_refreeze_e
    pack_swq_f = pack_swq + pack_water
    ice_f = ice + pack_water
    pack_cc_f = pack_swq_f * 0.0 + pack_cc + pack_refreeze_e
    pack_temp_f = W(
        pack_swq_f > 0.0,
        torch.clamp(pack_cc_f / (c.CH_ICE * torch.clamp(pack_swq_f,
                                                        min=c.SMALL)),
                    max=0.0),
        0.0)
    delta_pack = -pack_cc / (c.LF * c.RHO_W)
    pack_swq = W(cold_enough, pack_swq_f, pack_swq + delta_pack)
    ice = W(cold_enough, ice_f, ice + delta_pack)
    pack_water = W(cold_enough, 0.0, pack_water - delta_pack)
    pack_temp = W(cold_enough, pack_temp_f, 0.0)

    max_liquid_pack = c.SNOW_LIQUID_WATER_CAPACITY * pack_swq
    melt_out = torch.clamp(pack_water - max_liquid_pack, min=0.0)
    pack_water = torch.minimum(pack_water, max_liquid_pack)

    # ---- re-layer the pack around MAX_SURFACE_SWE (snow_melt.c:509-538) ----
    ice = pack_swq + surface_swq
    deep = ice > MSW
    surface_cc = c.CH_ICE * surf_temp * surface_swq
    pack_cc = c.CH_ICE * pack_temp * pack_swq
    excess = surface_swq - MSW
    frac_s = excess / torch.clamp(surface_swq, min=c.SMALL)
    deficit = MSW - surface_swq
    frac_p = deficit / torch.clamp(pack_swq, min=c.SMALL)
    too_thick = surface_swq > MSW
    exact = surface_swq == MSW
    surface_swq_d = W(exact, surface_swq, MSW)
    pack_swq_d = W(exact, pack_swq,
                   W(too_thick, pack_swq + excess, pack_swq - deficit))
    surface_cc_d = W(exact, surface_cc,
                     W(too_thick, surface_cc * (1.0 - frac_s),
                       surface_cc + pack_cc * frac_p))
    pack_cc_d = W(exact, pack_cc,
                  W(too_thick, pack_cc + surface_cc * frac_s,
                    pack_cc * (1.0 - frac_p)))

    surface_swq = W(deep, surface_swq_d, surface_swq)
    surf_temp_out = W(
        deep,
        surface_cc_d / (c.CH_ICE * torch.clamp(surface_swq_d, min=c.SMALL)),
        surf_temp)
    pack_temp_out = W(
        deep, pack_cc_d / (c.CH_ICE * torch.clamp(pack_swq_d, min=c.SMALL)),
        0.0)

    swq_out = ice + pack_water + surf_water
    empty = swq_out <= 0.0
    surf_temp_out = W(empty, 0.0, surf_temp_out)
    pack_temp_out = W(empty, 0.0, pack_temp_out)
    cold_content = c.CH_ICE * surf_temp_out * torch.clamp(surface_swq, max=MSW)

    return SnowMeltResult(
        swq=swq_out, surf_temp=surf_temp_out, pack_temp=pack_temp_out,
        surf_water=surf_water, pack_water=pack_water, melt=melt_out * 1000.0,
        vapor_flux=-vapor_flux, cold_content=cold_content, qnet=terms.rest,
        surf_temp_fbflag=fbflag, firn_to_ice=firn_to_ice, terms=terms,
        include_snow=thin, inc_advection0=terms0.advection)


class SnowCoverageResult(NamedTuple):
    coverage: torch.Tensor
    store_snow: torch.Tensor      # bool
    store_swq: torch.Tensor       # m
    swq_slope: torch.Tensor       # m/fract (negative)
    store_coverage: torch.Tensor
    max_swq: torch.Tensor         # m


def calc_snow_coverage(*, store_snow, dfsc, old_coverage, swq, old_swq,
                       depth, old_depth, melt_m, max_swq, snowfall_mm,
                       store_swq, swq_slope,
                       store_coverage) -> SnowCoverageResult:
    """SPATIAL_SNOW's partial snow coverage with the depletion curve's
    memory (calc_snow_coverage.c:7-150, Cherkauer 2001): snow spread with a
    slope anchored at depth_full_snow_cover (dfsc); melt shrinks the
    coverage along the stored slope; fresh snow on a partial pack is kept
    apart (store_swq), so that melting it off restores the buried
    depletion state. The reference's branch tree as three lanes evaluated
    in full (accumulating, melting, unchanged); water in m."""
    W = torch.where
    one = torch.ones_like(old_coverage)
    accum = snowfall_mm > 0.0
    melting = ~accum & (melt_m > 0.0)

    # ---- accumulation (calc_snow_coverage.c:44-80) ----
    sc_keep = W(store_swq == 0.0, W(old_coverage < 1.0, old_coverage, one),
                store_coverage)
    ssw_acc = store_swq + (swq - old_swq)
    bury = depth >= dfsc / 2.0   # deep enough to erase the melt memory
    a_store_snow = W(store_snow, ~bury, old_coverage < 1.0)
    a_store_swq = W(store_snow, W(bury, 0.0, ssw_acc),
                    W(old_coverage < 1.0, swq - old_swq, store_swq))
    a_swq_slope = W(store_snow & bury, 0.0, swq_slope)
    a_store_cov = W(store_snow, W(bury, one, sc_keep), store_coverage)

    # ---- melt (calc_snow_coverage.c:82-141) ----
    thin = (store_swq > 0.0) & (swq < old_swq)
    m_ssw1 = W(thin, store_swq + swq - old_swq, store_swq)
    cleared = thin & (m_ssw1 <= 0.0)   # the stored new snow is all gone
    m_ssw = W(cleared, 0.0, m_ssw1)
    m_oldcov = W(cleared, store_coverage, old_coverage)
    m_store_cov = W(cleared, one, store_coverage)
    depleting = m_ssw == 0.0
    need_slope = depleting & (swq_slope == 0.0)
    m_slope = W(need_slope,
                W(old_depth > dfsc / 2.0, -dfsc, -2.0 * old_depth),
                swq_slope)
    m_max0 = W(need_slope, -m_slope, max_swq)
    m_store_snow = W(need_slope, True, store_snow)
    m_max = W(depleting, 2.0 * depth, m_max0)
    # rain or sublimation can raise swq mid-melt: the coverage stays then
    reduce_cov = depleting & ((m_max < m_max0) | (m_max0 == 0.0))
    cov_red = torch.minimum(-m_max / W(m_slope != 0.0, m_slope, -one), one)
    m_cov = W(depleting & reduce_cov, cov_red, m_oldcov)

    def pick(a, m, u):
        return W(accum, a, W(melting, m, u))

    return SnowCoverageResult(
        coverage=pick(one, m_cov, old_coverage),
        store_snow=pick(a_store_snow, m_store_snow, store_snow),
        store_swq=pick(a_store_swq, m_ssw, store_swq),
        swq_slope=pick(a_swq_slope, m_slope, swq_slope),
        store_coverage=pick(a_store_cov, m_store_cov, store_coverage),
        max_swq=pick(max_swq, m_max, max_swq))
