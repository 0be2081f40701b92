// Constants and residual pieces shared by the kernels' residuals, each a
// line-for-line copy of its PyTorch version in vic_tpu_torch/physics/ (same
// operation order; x^4 as (x*x)*(x*x) like lax.integer_pow; Python constant
// products that evaluate in double before the float32 op as
// static_cast<float>(a*b)).
#pragma once

#include <cmath>

namespace vicphys {

constexpr float kKelvin = 273.15f;
constexpr float kStefanB = 5.6696e-8f;
constexpr float kLf = 3.337e5f;
constexpr float kRhoW = 999.842594f;
constexpr float kCp = 1013.0f;
constexpr float kChIce = 2100.0e3f;
constexpr float kChWater = 4186.8e3f;
constexpr float kKSnow = 2.9302e-6f;
constexpr float kEpsRatio = 0.62196351f;
constexpr float kG = 9.81f;
constexpr float kJoulesPerCal = 4.1868f;
constexpr float kGramsPerKg = 1000.0f;
constexpr float kHugeResist = 1.0e20f;
constexpr float kGlacKIce = 2.14f;
constexpr float kSecPerDay = 86400.0f;
// python-constant products evaluate in double before the float32 op
constexpr float kSvpBC = static_cast<float>(17.269 * 237.3);
constexpr float kGasOverG = static_cast<float>(287.0 / 9.81);
constexpr float kTwoThirds = static_cast<float>(2.0 / 3.0);
constexpr float kNegRhoIceLf = static_cast<float>(-917.0 * 3.337e5);

// PyTorch on CUDA divides a tensor by a host scalar as a product with the
// scalar's float reciprocal, and a host scalar by a tensor as the tensor's
// reciprocal times the scalar (Tensor.__rtruediv__). Residuals that repeat a
// plain version's arithmetic on the card divide the same way there.
__device__ __forceinline__ float div_s(float x, float s) {
  return x * (1.0f / s);
}
__device__ __forceinline__ float rdiv_s(float s, float x) {
  return (1.0f / x) * s;
}

// evap.svp (svp.c:7-23)
__device__ __forceinline__ float svp(float t) {
  float s = 0.61078f * expf((17.269f * t) / (237.3f + t));
  if (t < 0.0f) s = s * (1.0f + 0.00972f * t + 0.000042f * t * t);
  return s * 1000.0f;
}

// snow.stability_correction (StabilityCorrection.c:41-80)
__device__ __forceinline__ float stability_correction(float z, float d,
                                                      float tsurf, float tair,
                                                      float wind, float z0) {
  const float denom_t = ((tair + kKelvin) + (tsurf + kKelvin)) / 2.0f;
  const float wind2 = fmaxf(wind * wind, 1e-10f);
  float ri = kG * (tair - tsurf) * (z - d) / (denom_t * wind2);
  const float ri_limit =
      (tair + kKelvin) / (denom_t * (logf((z - d) / z0) + 5.0f));
  ri = fminf(ri, ri_limit);
  float corr;
  if (ri > 0.0f) {
    const float s = 1.0f - div_s(ri, 0.2f);
    corr = s * s;
  } else {
    corr = sqrtf(1.0f - 16.0f * fmaxf(ri, -0.5f));
  }
  return tsurf == tair ? 1.0f : corr;
}

__device__ __forceinline__ float pow4(float x) {
  const float x2 = x * x;
  return x2 * x2;
}

// soil_thermal.maximum_unfrozen_water (soil_conduction.c)
__device__ __forceinline__ float max_unfrozen(float t, float max_moist,
                                              float bubble, float expt) {
  const float bubble_term = div_s(9.81f * bubble, 100.0f);
  const float power = -rdiv_s(2.0f, expt - 3.0f);
  const float arg =
      div_s(-kLf * fminf(t, -1e-10f), 273.16f) / bubble_term;
  float unfrozen = max_moist * powf(fmaxf(arg, 1e-30f), power);
  unfrozen = fminf(fmaxf(unfrozen, 0.0f), max_moist);
  return t <= 0.0f ? unfrozen : max_moist;
}

// sublimation latent heat, J/kg
__device__ __forceinline__ float ls_of(float t) {
  return (677.0f - 0.07f * t) * kJoulesPerCal * kGramsPerKg;
}

// snow.latent_heat_from_snow (latent_heat_from_snow.c:66-91): the latent
// and sublimation fluxes and the vapor mass flux (kg/m^2/s, the blowing
// flux added) over snow or ice at surface temperature t, resistance ra.
struct SnowLatent {
  float latent, latent_sub, vapor_flux;
};

__device__ __forceinline__ SnowLatent latent_heat_from_snow(
    float air_dens, float eact_air, float lv, float press, float ra, float t,
    float vpd, float blowing_flux) {
  float vf = air_dens * (kEpsRatio / press) * (eact_air - svp(t)) / ra;
  if (vpd == 0.0f && vf < 0.0f) vf = 0.0f;
  vf = vf + blowing_flux;
  return SnowLatent{t >= 0.0f ? lv * vf : 0.0f,
                    t >= 0.0f ? 0.0f : ls_of(t) * vf, vf};
}

}  // namespace vicphys
