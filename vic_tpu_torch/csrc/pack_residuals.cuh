// The residuals of the snowpack (K2) and bare-glacier (K1) surface energy
// balances, shared by their Brent kernels (vic_kernels.cu) and the
// fixed-count bisection (K17, bisection.cu). Line-for-line copies of
// physics/snow.snow_energy_terms and physics/glacier.glacier_energy_terms.
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

// K1 residual: glacier.glacier_energy_terms(t).rest
struct GlacierResidual {
  float dt, ra, z_ref, roughness, air_dens, vp_air, longwave_in, lv,
      pressure, rain_m, net_short, vpd, wind, old_tsurf, ice_depth_mm, tair;

  __device__ float operator()(float ts) const {
    const float tgrnd = 0.0f;  // GLAC_TEMP
    const float tmean = (ts + tgrnd) / 2.0f;
    const float old_tmean = (old_tsurf + tgrnd) / 2.0f;
    const float ice_depth = ice_depth_mm / 1000.0f;
    const float ra_corr =
        wind > 0.0f
            ? ra / stability_correction(z_ref, 0.0f, ts, tair, wind, roughness)
            : kHugeResist;
    const float net_long = longwave_in - kStefanB * pow4(ts + kKelvin);
    const float net_rad = net_short + net_long;
    const float sensible = air_dens * kCp * (tair - ts) / ra_corr;
    float vmf = air_dens * (kEpsRatio / pressure) * (vp_air - svp(ts)) / ra_corr;
    if (vpd == 0.0f && vmf < 0.0f) vmf = 0.0f;
    const float latent = ts >= 0.0f ? lv * vmf : 0.0f;
    const float latent_sub = ts >= 0.0f ? 0.0f : ls_of(ts) * vmf;
    const float advection = ts == 0.0f ? kChWater * tair * rain_m / dt : 0.0f;
    const float delta_cc = kChIce * ice_depth * (tmean - old_tmean) / dt;
    const float grnd_flux = (kGlacKIce + ts * (-0.0142f)) * (tgrnd - ts) /
                            nan_max(ice_depth, 1e-6f);
    float rest = net_rad + sensible + latent + latent_sub + advection -
                 delta_cc + grnd_flux;
    if (ts == 0.0f && rest >= 0.0f) rest = 0.0f;
    return rest;
  }
};

// K2 residual: snow.snow_energy_terms(t).rest, with the blowing-snow mass
// flux (kg/m^2/s) added to the surface vapor flux and, under SPATIAL_SNOW
// (spatial), the sensible heat advected from the snow-free patches of a
// lane whose pack covers snow_cover_fract of it
struct SnowpackResidual {
  float dt, ra, z_ref, roughness, air_dens, vp_air, longwave_in, lv,
      pressure, rain_m, net_short, vpd, wind, old_tsurf, snow_depth,
      snow_density, surf_water, surface_swq, tair, tgrnd, blowing_flux,
      snow_cover_fract;
  bool spatial;

  __device__ float operator()(float ts) const {
    const float ra_corr =
        wind > 0.0f
            ? ra / stability_correction(z_ref, 0.0f, ts, tair, wind, roughness)
            : kHugeResist;
    const float net_long = longwave_in - kStefanB * pow4(ts + kKelvin);
    const float net_rad = net_short + net_long;
    const float sensible = air_dens * kCp * (tair - ts) / ra_corr;
    const SnowLatent lh = latent_heat_from_snow(
        air_dens, vp_air, lv, pressure, ra_corr, ts, vpd, blowing_flux);
    const float latent = lh.latent;
    const float latent_sub = lh.latent_sub;
    const float advection = ts == 0.0f ? kChWater * tair * rain_m / dt : 0.0f;
    const float delta_cc = kChIce * surface_swq * (ts - old_tsurf) / dt;
    const float grnd_flux =
        snow_depth > 0.0f ? kKSnow * snow_density * snow_density *
                                (tgrnd - ts) / nan_max(snow_depth, 1e-10f) / dt
                          : 0.0f;
    const float refreeze = surf_water * kLf * kRhoW / dt;
    float rest = net_rad + sensible + latent + latent_sub + advection;
    if (spatial)
      rest = rest + advected_sensible_heat(snow_cover_fract, air_dens, tair,
                                           tgrnd, ra_corr);
    rest = rest - delta_cc + grnd_flux;
    // two-pass 0 C pattern (SnowPackEnergyBalance.c:186-195)
    if (ts == 0.0f && rest > -refreeze) return 0.0f;
    return rest + refreeze;
  }
};

}  // namespace vicres
