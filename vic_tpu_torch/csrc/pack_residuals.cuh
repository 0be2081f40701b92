// The residuals of the snowpack (K2) and bare-glacier (K1) surface energy
// balances, shared by their Brent kernels (vic_kernels.cu) and the
// fixed-count bisection (K17, bisection.cu). Line-for-line copies of
// physics/snow.snow_energy_terms and physics/glacier.glacier_energy_terms,
// all of their terms (K2 and K1 write them); each residual is its terms'
// rest, the same operations in the same order.
#pragma once

#include "physics.cuh"

namespace vicres {

using namespace vicphys;

constexpr float kSmall = 1.0e-12f;

// snow.advected_sensible_heat (advected_sensible_heat.c:8-48): sensible heat
// advected from the snow-free patches onto a pack covering
// snow_cover_fract of the lane; 10^x as powf(10, x), as torch.pow does
__device__ __forceinline__ float advected_sensible_heat(float scf,
                                                        float air_dens,
                                                        float tair,
                                                        float tgrnd,
                                                        float ra) {
  const float qbare = air_dens * kCp * (tair - tgrnd) / ra;
  const float fs = scf > 0.6f   ? 1.0f
                   : scf > 0.5f ? powf(10.0f, 3.0f * scf - 1.8f)
                   : scf > 0.2f ? powf(10.0f, 5.6667f * scf - 3.1333f)
                                : 0.01f;
  const float cov = nan_max(scf, kSmall);
  const float qadv = qbare * (1.0f - scf) / cov * fs;
  return scf > 0.0f ? qadv : 0.0f;
}

// glacier.GlacierEBTerms at one surface temperature
struct GlacierTerms {
  float rest, melt_energy, vapor_flux, latent, latent_sub, sensible,
      advection, delta_cc, grnd_flux, net_long;
};

// K1 residual: glacier.glacier_energy_terms(t).rest; terms() is every term
// of glacier_energy_terms, the residual its rest
struct GlacierResidual {
  float dt, ra, z_ref, roughness, air_dens, vp_air, longwave_in, lv,
      pressure, rain_m, net_short, vpd, wind, old_tsurf, ice_depth_mm, tair;

  __device__ GlacierTerms terms(float ts) const {
    GlacierTerms o;
    const float tgrnd = 0.0f;  // GLAC_TEMP
    const float tmean = (ts + tgrnd) / 2.0f;
    const float old_tmean = (old_tsurf + tgrnd) / 2.0f;
    const float ice_depth = ice_depth_mm / 1000.0f;
    const float ra_corr =
        wind > 0.0f
            ? ra / stability_correction(z_ref, 0.0f, ts, tair, wind, roughness)
            : kHugeResist;
    o.net_long = longwave_in - kStefanB * pow4(ts + kKelvin);
    const float net_rad = net_short + o.net_long;
    o.sensible = air_dens * kCp * (tair - ts) / ra_corr;
    float vmf = air_dens * (kEpsRatio / pressure) * (vp_air - svp(ts)) / ra_corr;
    if (vpd == 0.0f && vmf < 0.0f) vmf = 0.0f;
    // m of water a step (glacier.py: vmf * dt / RHO_W)
    o.vapor_flux = div_s(vmf * dt, kRhoW);
    o.latent = ts >= 0.0f ? lv * vmf : 0.0f;
    o.latent_sub = ts >= 0.0f ? 0.0f : ls_of(ts) * vmf;
    o.advection = ts == 0.0f ? kChWater * tair * rain_m / dt : 0.0f;
    o.delta_cc = kChIce * ice_depth * (tmean - old_tmean) / dt;
    o.grnd_flux = (kGlacKIce + ts * (-0.0142f)) * (tgrnd - ts) /
                  nan_max(ice_depth, 1e-6f);
    const float rest = net_rad + o.sensible + o.latent + o.latent_sub +
                       o.advection - o.delta_cc + o.grnd_flux;
    o.melt_energy = rest;
    o.rest = ts == 0.0f && rest >= 0.0f ? 0.0f : rest;
    return o;
  }

  __device__ float operator()(float ts) const { return terms(ts).rest; }
};

// snow.SnowEBTerms at one surface temperature
struct SnowTerms {
  float rest, refreeze, vapor_flux, latent, latent_sub, sensible, advection,
      delta_cc, grnd_flux, net_long, advected_sensible;
};

// K2 residual: snow.snow_energy_terms(t).rest, with the blowing-snow mass
// flux (kg/m^2/s) added to the surface vapor flux and, under SPATIAL_SNOW
// (spatial), the sensible heat advected from the snow-free patches of a
// lane whose pack covers snow_cover_fract of it; terms() is every term of
// snow_energy_terms, the residual its rest
struct SnowpackResidual {
  float dt, ra, z_ref, roughness, air_dens, vp_air, longwave_in, lv,
      pressure, rain_m, net_short, vpd, wind, old_tsurf, snow_depth,
      snow_density, surf_water, surface_swq, tair, tgrnd, blowing_flux,
      snow_cover_fract;
  bool spatial;

  __device__ SnowTerms terms(float ts) const {
    SnowTerms o;
    const float ra_corr =
        wind > 0.0f
            ? ra / stability_correction(z_ref, 0.0f, ts, tair, wind, roughness)
            : kHugeResist;
    o.net_long = longwave_in - kStefanB * pow4(ts + kKelvin);
    const float net_rad = net_short + o.net_long;
    o.sensible = air_dens * kCp * (tair - ts) / ra_corr;
    const SnowLatent lh = latent_heat_from_snow(
        air_dens, vp_air, lv, pressure, ra_corr, ts, vpd, blowing_flux);
    o.latent = lh.latent;
    o.latent_sub = lh.latent_sub;
    // m of water a step (snow.py: vapor_mass_flux * dt / RHO_W)
    o.vapor_flux = div_s(lh.vapor_flux * dt, kRhoW);
    o.advection = ts == 0.0f ? kChWater * tair * rain_m / dt : 0.0f;
    o.delta_cc = kChIce * surface_swq * (ts - old_tsurf) / dt;
    o.grnd_flux =
        snow_depth > 0.0f ? kKSnow * snow_density * snow_density *
                                (tgrnd - ts) / nan_max(snow_depth, 1e-10f) / dt
                          : 0.0f;
    const float refreeze = surf_water * kLf * kRhoW / dt;
    float rest = net_rad + o.sensible + o.latent + o.latent_sub + o.advection;
    o.advected_sensible = 0.0f;
    if (spatial) {
      o.advected_sensible = advected_sensible_heat(snow_cover_fract, air_dens,
                                                   tair, tgrnd, ra_corr);
      rest = rest + o.advected_sensible;
    }
    rest = rest - o.delta_cc + o.grnd_flux;
    // two-pass 0 C pattern (SnowPackEnergyBalance.c:186-195)
    if (ts == 0.0f && rest > -refreeze) {
      o.rest = 0.0f;
      o.refreeze = -rest;
    } else {
      o.rest = rest + refreeze;
      o.refreeze = refreeze;
    }
    return o;
  }

  __device__ float operator()(float ts) const { return terms(ts).rest; }
};

}  // namespace vicres
