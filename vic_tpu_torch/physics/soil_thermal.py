"""Soil thermal properties and the quick-flux between-layer temperature.
Counterpart of `vic_tpu/physics/soil_thermal.py` (soil_conduction.c,
estimate_T1.c)."""
from __future__ import annotations

import torch

from ..constants import LF


def soil_conductivity(moist, wu, soil_dens_min, bulk_dens_min, quartz,
                      soil_density, bulk_density, organic):
    """Johansen soil thermal conductivity, W/m/K; moist/wu volumetric."""
    ki, kw = 2.2, 0.57
    kdry_org, ks_org = 0.05, 0.25
    kdry_min = (0.135 * bulk_dens_min + 64.7) / (
        soil_dens_min - 0.947 * bulk_dens_min)
    kdry = (1.0 - organic) * kdry_min + organic * kdry_org

    porosity = 1.0 - bulk_density / soil_density
    sr = torch.clamp(moist / torch.clamp(porosity, min=1e-10), min=1e-10)
    p77 = torch.pow(torch.full_like(quartz, 7.7), quartz)
    ks_min = torch.where(
        quartz < 0.2,
        p77 * torch.pow(torch.full_like(quartz, 3.0), 1.0 - quartz),
        p77 * torch.pow(torch.full_like(quartz, 2.2), 1.0 - quartz))
    ks = (1.0 - organic) * ks_min + organic * ks_org

    unfrozen = wu == moist
    ks_pow = torch.pow(ks, 1.0 - porosity)
    ksat_u = ks_pow * torch.pow(torch.full_like(porosity, kw), porosity)
    ke_u = 0.7 * torch.log10(sr) + 1.0
    ksat_f = (ks_pow
              * torch.pow(torch.full_like(porosity, ki),
                          torch.clamp(porosity - wu, min=0.0))
              * torch.pow(torch.full_like(wu, kw), wu))
    ksat = torch.where(unfrozen, ksat_u, ksat_f)
    ke = torch.where(unfrozen, ke_u, sr)
    k = torch.maximum((ksat - kdry) * ke + kdry, kdry)
    return torch.where(moist > 0.0, k, kdry)


def volumetric_heat_capacity(soil_fract, water_fract, ice_fract,
                             organic_fract):
    """J/m^3/K (soil_conduction.c)."""
    cs = 2.0e6 * soil_fract * (1.0 - organic_fract)
    cs = cs + 2.7e6 * soil_fract * organic_fract
    cs = cs + 4.2e6 * water_fract
    cs = cs + 1.9e6 * ice_fract
    cs = cs + 1.3e3 * (1.0 - (soil_fract + water_fract + ice_fract))
    return cs


def maximum_unfrozen_water(t, max_moist, bubble, expt):
    """Maximum liquid water at temperature t (C), in max_moist's units."""
    return unfrozen_water_from_terms(t, max_moist, 9.81 * bubble / 100.0,
                                     -(2.0 / (expt - 3.0)))


def unfrozen_water_from_terms(t, max_moist, bubble_term, power):
    """maximum_unfrozen_water with its parameter-only terms given:
    bubble_term = 9.81*bubble/100 and power = -2/(expt-3). Callers whose
    parameters are float64 host arrays form the terms there and round them
    once, as the JAX package does with its numpy node geometry."""
    arg = (-LF * torch.clamp(t, max=-1e-10)) / 273.16 / bubble_term
    unfrozen = max_moist * torch.pow(torch.clamp(arg, min=1e-30), power)
    unfrozen = torch.minimum(torch.clamp(unfrozen, min=0.0), max_moist)
    return torch.where(t <= 0.0, unfrozen, max_moist)


def layer_thermal_props(moist_mm, ice_mm, depth, soil_dens_min, bulk_dens_min,
                        quartz, soil_density, bulk_density, organic):
    """kappa (W/m/K) and Cs (J/m^3/K) per soil layer; moist/ice in mm."""
    moist = moist_mm / depth / 1000.0
    ice = ice_mm / depth / 1000.0
    kappa = soil_conductivity(moist, moist - ice, soil_dens_min,
                              bulk_dens_min, quartz, soil_density,
                              bulk_density, organic)
    cs = volumetric_heat_capacity(bulk_density / soil_density,
                                  moist - ice, ice, organic)
    return kappa, cs


def estimate_t1(ts, t1_old, t2, d1, d2, kappa1, kappa2, cs1, cs2, dp, delta_t):
    """Liang et al. 1999 between-layer temperature (estimate_T1.c)."""
    c1 = cs2 * dp / d2 * (1.0 - torch.exp(-d2 / dp))
    c2 = -(1.0 - torch.exp(d1 / dp)) * torch.exp(-d2 / dp)
    c3 = kappa1 / d1 - kappa2 / d1 + kappa2 / d1 * torch.exp(-d1 / dp)
    return ((kappa1 / 2.0 / d1 / d2 * ts + c1 / delta_t * t1_old
             + (2.0 * c2 - 1.0 + torch.exp(-d1 / dp)) * kappa2 / 2.0 / d1
             / d2 * t2)
            / (c1 / delta_t + kappa2 / d1 / d2 * c2 + c3 / 2.0 / d2))
