// K8 blowing_snow: the blowing-snow sublimation and transport of every lane,
// for sm_90a (H100).
//
// Replaces vic_tpu/physics/blowing_snow.py:171 (calc_blowing_snow, with the
// shear bisection fori_loop solve_shear :65-87 and the suspension
// quadrature of _sub_flux_one :112-168). On the TPU the ten Laplace wind
// increments were unrolled over the batch, each a 24-trip bisection loop
// and two 16-point quadratures of batch-wide fusions. Here one thread runs
// one lane's whole calc_blowing_snow in registers: the ten increments, each
// with its 24 bisection steps, the saltation terms and the 16-point
// log-trapezoid suspension and transport integrals, then the probability
// weighting and the -5e-5 floor. A lane reads ~15 floats and writes 2
// while it runs ~10 x (24 + 17 + 16) evaluations of pow/exp/log-heavy
// arithmetic: bound by operations, not by bytes. Lanes without snow write
// zeros at once (the plain version's where(snowdepth > 0, ...)).
//
// A line-for-line copy of vic_tpu_torch/physics/blowing_snow.py's plain
// version, divisions by a host scalar as PyTorch does them on the card
// (physics.cuh); the 16 quadrature nodes come from the same table the plain
// version uses (blowing_snow.QUAD_NODES, as jax.numpy.linspace forms them).
//
// C interface for ctypes: returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "lanes.cuh"
#include "physics.cuh"

namespace {

using namespace vicphys;

constexpr int kBlock = 128;
constexpr int kNumIncs = 10;             // NUMINCS
constexpr int kQuad = 16;                // quadrature nodes
constexpr int kShearIters = 24;          // bisection steps
constexpr float kKaAir = 0.0245187f;     // thermal conductivity of air
constexpr float kCsalt = 0.68f;
constexpr float kKinVis = 1.3e-5f;
constexpr float kSettling = 0.3f;
constexpr float kMw = 18.0148e-3f;
constexpr float kRGas = 8.3143f;
constexpr float kGStd = 9.80665f;
constexpr float kVonK = 0.40f;
constexpr float kIceDensity = 917.0f;
// python-constant expressions, folded in double before the float32 op
constexpr float kLogShear = static_cast<float>(2.0 * 9.80665 * 10.0 / 0.12);
constexpr float kTwoG = static_cast<float>(2.0 * 9.80665);
constexpr float kMzCoef =
    static_cast<float>(4.0 / 3.0 * 3.141592653589793 * 917.0);
constexpr float kRmeanDen = static_cast<float>(4.0 * 3.141592653589793 * 917.0);
constexpr float kOneThird = static_cast<float>(1.0 / 3.0);
constexpr float kCosPi4 = static_cast<float>(0.7071067811865476);
constexpr float kTwoPi = static_cast<float>(2.0 * 3.141592653589793);
constexpr float kFourThirds = static_cast<float>(4.0 / 3.0);
constexpr float kArea = static_cast<float>(1.0 / kNumIncs);
constexpr float kPi = static_cast<float>(3.141592653589793);

// float inputs, in the order of kernels.BLOWING_INPUTS; mask: is_bare
enum In {
  kTair, kLastSnow, kSurfWater, kWind2m, kLs, kAirDens, kEact, kZ0, kDepth,
  kLagOne, kSigmaSlope, kFetch, kDispl, kRough, kNumIn
};

// get_thresh's log-profile shear velocity term and shear_residual
__device__ __forceinline__ float shear_residual(float x, float u_r) {
  return logf(kLogShear) + logf(rdiv_s(1.0f, x * x)) - kVonK * u_r / x;
}

// sub_with_height (sub_with_height:508-551), kg/m^3/s at height z
__device__ __forceinline__ float sub_with_height(float z, float es, float u10,
                                                 float eact, float F,
                                                 float hsalt, float phi_s,
                                                 float ushear) {
  const float rrz = 4.6e-5f * powf(z, -0.258f);
  const float alphaz = 4.08f + 12.6f * z;
  const float mz = kMzCoef * (rrz * rrz * rrz) *
                   (1.0f + rdiv_s(3.0f, alphaz) +
                    rdiv_s(2.0f, alphaz * alphaz));
  const float rmean = powf(div_s(3.0f * mz, kRmeanDen), kOneThird);
  const float terminal_v = 1.1e7f * powf(rmean, 1.8f);
  const float fluct_v = 0.005f * powf(u10, 1.36f);
  const float vtz = terminal_v + 3.0f * fluct_v * kCosPi4;
  const float re = div_s(2.0f * rmean * vtz, kKinVis);
  const float nu = 1.79f + 0.606f * sqrtf(re);
  const float sigz = (eact / es - 1.0f) * (1.019f + 0.027f * logf(z));
  const float dmdt = kTwoPi * rmean * sigz * nu / F;
  const float psi_t = dmdt / mz;
  const float temp = (0.5f * ushear * ushear) / (u10 * kSettling);
  const float phi_t =
      phi_s * ((temp + 1.0f) *
                   powf(z / hsalt, rdiv_s(-kSettling, kVonK * ushear)) -
               temp);
  return psi_t * phi_t;
}

struct Flux {
  float sub, transport;
};

// _sub_flux_one: sublimation and transport at one wind speed
__device__ Flux sub_flux_one(float u10, float es, float eact, float air_dens,
                             float z0, float fe, float F, float utshear,
                             const float* nodes) {
  // solve_shear: bisection on [utshear, k*U10], log profile if unbracketed
  const float umin = utshear, umax = kVonK * u10;
  const float f_lo = shear_residual(umin, u10);
  const float f_hi = shear_residual(umax, u10);
  const bool bracketed = f_lo * f_hi < 0.0f;
  float lo = umin, hi = umax, flo = f_lo;
  for (int k = 0; k < kShearIters; ++k) {
    const float mid = 0.5f * (lo + hi);
    const float fm = shear_residual(mid, u10);
    if (flo * fm <= 0.0f) {
      hi = mid;
    } else {
      lo = mid;
      flo = fm;
    }
  }
  const float ushear_fb = kVonK * u10 / logf(rdiv_s(10.0f, z0));
  const float ushear = bracketed ? 0.5f * (lo + hi) : ushear_fb;
  const float zo_salt =
      bracketed ? div_s(0.12f * ushear * ushear, kTwoG) : z0;
  const bool saltating = ushear > utshear;

  float qsalt = div_s(kCsalt * air_dens, kGStd) * (utshear / ushear) *
                nan_max(ushear * ushear - utshear * utshear, 0.0f);
  const float e_fe = expf(div_s(-3.0f * fe, 500.0f));
  qsalt = qsalt * (1.0f + rdiv_s(500.0f, 3.0f * fe) * (e_fe - 1.0f));
  const float hsalt = 0.08436f * powf(ushear, 1.27f);
  const float particle = utshear * 2.8f;
  const float phi_s = qsalt / nan_max(hsalt * particle, 1e-12f);
  const float T = 0.5f * ushear * ushear / (u10 * kSettling);
  const float ztop =
      hsalt * powf(T / (T + 1.0f), div_s(kVonK * ushear, -kSettling));
  // saltation layer: phi_s * psi_s * hsalt, psi_s at hsalt / 2
  const float psi_s = sub_with_height(div_s(hsalt, 2.0f), es, u10, eact, F,
                                      hsalt, phi_s, ushear);
  const float sub_salt = phi_s * psi_s * hsalt;
  // suspension layer: 16-point trapezoid in log z
  const float lo_z = logf(nan_max(hsalt, 1e-4f));
  const float hi_z = logf(nan_max(ztop, nan_max(hsalt, 1e-4f) * 1.0001f));
  const float dt_q = div_s(hi_z - lo_z, static_cast<float>(kQuad - 1));
  const float expo = rdiv_s(-kSettling, kVonK * ushear);
  const float zo_safe = nan_max(zo_salt, 1e-10f);
  float sub_prev = 0.0f, tr_prev = 0.0f, sub_sum = 0.0f, tr_sum = 0.0f;
  for (int k = 0; k < kQuad; ++k) {
    const float z = expf(lo_z + (hi_z - lo_z) * nodes[k]);
    const float fz =
        sub_with_height(z, es, u10, eact, F, hsalt, phi_s, ushear) * z;
    const float uz = div_s(ushear * logf(z / zo_safe), kVonK);
    const float phi_tz = phi_s * ((T + 1.0f) * powf(z / hsalt, expo) - T);
    const float tz = uz * phi_tz * z;
    if (k == 1) {
      sub_sum = sub_prev + fz;
      tr_sum = tr_prev + tz;
    } else if (k > 1) {
      sub_sum = sub_sum + (sub_prev + fz);
      tr_sum = tr_sum + (tr_prev + tz);
    }
    sub_prev = fz;
    tr_prev = tz;
  }
  const float sub_susp = div_s(sub_sum, 2.0f) * dt_q;
  const float trans_susp = div_s(tr_sum, 2.0f) * dt_q;
  const bool undersat = eact < es;
  Flux out;
  out.sub = saltating && undersat ? sub_salt + sub_susp : 0.0f;
  const float trans_salt = qsalt * (1.0f - e_fe);
  out.transport = saltating ? (trans_salt + trans_susp) / fe : 0.0f;
  return out;
}

// get_prob: probability of blowing snow (Li & Pomeroy 1997)
__device__ __forceinline__ float get_prob(float tair, float age_h,
                                          float surf_water, float u10) {
  const float age = nan_max(age_h, 1e-3f);
  const bool dry = surf_water < 0.001f;
  const float mean_u = dry ? 11.2f + 0.365f * tair + 0.00706f * tair * tair +
                                 0.9f * logf(age)
                           : 21.0f;
  const float sigma =
      dry ? 4.3f + 0.145f * tair + 0.00196f * tair * tair : 7.0f;
  const float prob =
      rdiv_s(1.0f, 1.0f + expf(sqrtf(kPi) * (mean_u - u10) / sigma));
  return nan_min(nan_max(prob, 0.0f), 1.0f);
}

__global__ void blowing_snow_kernel(const __grid_constant__ LaneInputs in,
                                    float dt, const float* quad_nodes,
                                    const float* log_terms, int n,
                                    float* flux_out, float* transport_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const LaneRow row = lane_row(in, i);
  auto f = [&](int k) { return lane_f(in, k, row); };
  const float snowdepth = f(kDepth);
  if (!(snowdepth > 0.0f)) {
    flux_out[i] = 0.0f;
    transport_out[i] = 0.0f;
    return;
  }
  float nodes[kQuad];
#pragma unroll
  for (int k = 0; k < kQuad; ++k) nodes[k] = quad_nodes[k];
  const float tair = f(kTair), surf_water = f(kSurfWater), z0 = f(kZ0);
  const float ls = f(kLs), air_dens = f(kAirDens), eact = f(kEact);
  const float age_h = nan_max(div_s(f(kLastSnow) * dt, 3600.0f), 1e-3f);
  const float es = svp(tair);
  const float tk = tair + kKelvin;
  const float ros = 0.622f * es / (287.0f * tk);
  const float diffus = 2.06e-5f * powf(div_s(tk, 273.0f), 1.75f);
  const float F = (ls / (kKaAir * tk)) * (ls * kMw / (kRGas * tk) - 1.0f) +
                  rdiv_s(1.0f, diffus * ros);
  const float wind10 = f(kWind2m) * logf(rdiv_s(10.0f, z0)) /
                       logf((2.0f + z0) / z0);
  const bool bare = lane_m(in, 0, row);
  const float fe = bare ? 1500.0f : f(kFetch);
  const float sslope = bare ? 2.0e-4f : f(kSigmaSlope);
  const float ratio = (2.44f - 0.43f * f(kLagOne)) * sslope;
  const float sigma_w = wind10 * ratio;
  const float uo = wind10;
  const float displ = f(kDispl);
  const float hv = 1.5f * displ;
  const float nd = kFourThirds * f(kRough) / nan_max(displ, 1e-6f);
  const float ut10 = surf_water < 0.001f
                         ? 9.43f + 0.18f * tair + 0.0033f * tair * tair
                         : 9.9f;
  const float utshear = kVonK * ut10 / logf(rdiv_s(10.0f, z0));
  const float sig_safe = nan_max(sigma_w, 1e-10f);

  float total = 0.0f, total_transport = 0.0f;
  for (int p = 0; p < kNumIncs; ++p) {
    // Laplace interval bounds (CalcBlowingSnow.c:203-223); log_terms[p]
    // holds the float32 log of the lower bound's probability argument,
    // log_terms[kNumIncs + p] the upper one's
    float lower, upper;
    if (p == 0) {
      lower = uo - 9999.0f;
      upper = uo + sigma_w * log_terms[kNumIncs + p];
    } else if (p < kNumIncs / 2) {
      lower = uo + sigma_w * log_terms[p];
      upper = uo + sigma_w * log_terms[kNumIncs + p];
    } else if (p < kNumIncs - 1) {
      lower = uo - sigma_w * log_terms[p];
      upper = uo - sigma_w * log_terms[kNumIncs + p];
    } else {
      lower = uo - sigma_w * log_terms[p];
      upper = uo + 9999.0f;
    }
    lower = nan_min(lower, upper);
    // the conditional mean by lower >= Uo (upper tail) or not; exponent
    // arguments clamped at 0 as the plain version evaluates both
    float u10;
    if (lower >= uo) {
      const float eu = expf(nan_min(-(upper - uo) / sig_safe, 0.0f));
      const float el = expf(nan_min(-(lower - uo) / sig_safe, 0.0f));
      u10 = div_s(-0.5f * ((upper + sigma_w) * eu - (lower + sigma_w) * el),
                  kArea);
    } else {
      const float eu = expf(nan_min((upper - uo) / sig_safe, 0.0f));
      const float el = expf(nan_min((lower - uo) / sig_safe, 0.0f));
      u10 = div_s(0.5f * ((upper - sigma_w) * eu - (lower - sigma_w) * el),
                  kArea);
    }
    u10 = nan_min(nan_max(u10, 0.4f), 25.0f);
    const float uveg =
        snowdepth < hv
            ? u10 / sqrtf(1.0f + 170.0f * nd * nan_max(hv - snowdepth, 0.0f))
            : u10;
    const float prob = get_prob(tair, age_h, surf_water, uveg);
    const Flux fl =
        sub_flux_one(u10, es, eact, air_dens, z0, fe, F, utshear, nodes);
    total = total + kArea * fl.sub * prob;
    total_transport = total_transport + kArea * fl.transport * prob;
  }
  flux_out[i] = nan_max(total, -5.0e-5f);
  transport_out[i] = total_transport;
}

}  // namespace

extern "C" {

// f/m: the 14 float inputs of blowing_snow_kernel's In and the is_bare
// mask, as lanes.cuh reads them; quad_nodes: [16] float; log_terms: [20]
// float; flux, transport: [n] float.
int blowing_snow(const int64_t* lanes, int nf, int nm,
                 int h, float dt, const float* quad_nodes,
                 const float* log_terms, int n, float* flux,
                 float* transport, void* stream) {
  LaneInputs in{};
  if (n <= 0 ||
      !fill_lane_inputs(&in, lanes, nf, kNumIn, nm, 1, h))
    return static_cast<int>(cudaErrorInvalidValue);
  blowing_snow_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      in, dt, quad_nodes, log_terms, n, flux, transport);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
