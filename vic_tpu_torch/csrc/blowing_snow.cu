// K8 blowing_snow: the blowing-snow sublimation and transport of every lane,
// for sm_90a (H100).
//
// Replaces vic_tpu/physics/blowing_snow.py:171 (calc_blowing_snow, with the
// shear bisection fori_loop solve_shear :65-87 and the suspension
// quadrature of _sub_flux_one :112-168). On the TPU the ten Laplace wind
// increments were unrolled over the batch, each a 24-trip bisection loop
// and two 16-point quadratures of batch-wide fusions.
//
// What bounds it on this card: operations. A snow lane reads ~15 floats and
// writes 2, and runs ten wind increments of ~200 libm calls each (26
// shear residuals' logf, 24 bisection updates, 17 sub_with_height of four
// powf, a logf and a sqrtf, 16 quadrature nodes' expf, logf and powf), a
// chain of accurate (not fast-math) powf, expf and logf. One thread a lane
// ran all ten in series: the lanes without snow left their warp
// slots idle beside the snow lanes of their warp, and a lane's ten
// increments were one long serial chain.
//
// What this design does about it:
// - Compaction: each block takes a chunk of kBlock lanes; its threads
//   write the zeros of the chunk's lanes without snow (!(snowdepth > 0),
//   so a NaN depth gives zeros, as the plain version's where does) and
//   list the snow lanes in shared memory (a warp ballot and the warps'
//   counts), each snow lane's thread forming the lane's prelude (svp, F,
//   the 10 m wind, the threshold shear, ...) once into its slot. One
//   launch, no global scan.
// - Work items: one (snow lane, increment) a thread, so the ten increments
//   of a lane run side by side and every thread of a warp runs a snow
//   lane's increment (the same trip counts: 24 bisection steps, 16 nodes).
//   An item stores kArea * sub * prob and kArea * transport * prob by slot
//   and increment; then one thread a snow lane adds the ten from 0.0f in
//   increment order and applies the -5e-5 floor: the float sequence of the
//   one-thread loop, so the outputs are bit for bit that loop's.
// - Each repeated transcendental once where the float expression is the
//   same: fluct_v = 0.005 * u10^1.36 once an increment (not at each of the
//   17 heights), one powf(z / hsalt, -SETTLING / (k u*)) a node for the
//   sublimation's phi_t and the transport's phi_tz, and the settling
//   ratio T once (sub_with_height's `temp` is the same expression).
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

// sub_with_height (sub_with_height:508-551), kg/m^3/s at height z, with
// what its callers evaluate once: fluct_v = 0.005 * u10^1.36 (the same for
// every height of a wind speed), sig_e = eact / es - 1, t_set = 0.5 *
// u*^2 / (u10 * SETTLING) (the plain version's `temp` and `T`) and pz =
// (z / hsalt)^(-SETTLING / (k * u*)), which the transport integrand reads
// too: each the same float expression as before, so the same value.
__device__ __forceinline__ float sub_with_height(float z, float sig_e,
                                                 float F, float phi_s,
                                                 float fluct_v, float t_set,
                                                 float pz) {
  const float rrz = 4.6e-5f * powf(z, -0.258f);
  const float alphaz = 4.08f + 12.6f * z;
  const float mz = kMzCoef * (rrz * rrz * rrz) *
                   (1.0f + rdiv_s(3.0f, alphaz) +
                    rdiv_s(2.0f, alphaz * alphaz));
  const float rmean = powf(div_s(3.0f * mz, kRmeanDen), kOneThird);
  const float terminal_v = 1.1e7f * powf(rmean, 1.8f);
  const float vtz = terminal_v + 3.0f * fluct_v * kCosPi4;
  const float re = div_s(2.0f * rmean * vtz, kKinVis);
  const float nu = 1.79f + 0.606f * sqrtf(re);
  const float sigz = sig_e * (1.019f + 0.027f * logf(z));
  const float dmdt = kTwoPi * rmean * sigz * nu / F;
  const float psi_t = dmdt / mz;
  const float phi_t = phi_s * ((t_set + 1.0f) * pz - t_set);
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
  const float fluct_v = 0.005f * powf(u10, 1.36f);
  const float sig_e = eact / es - 1.0f;
  const float expo = rdiv_s(-kSettling, kVonK * ushear);
  // saltation layer: phi_s * psi_s * hsalt, psi_s at hsalt / 2
  const float z_s = div_s(hsalt, 2.0f);
  const float psi_s = sub_with_height(z_s, sig_e, F, phi_s, fluct_v, T,
                                      powf(z_s / hsalt, expo));
  const float sub_salt = phi_s * psi_s * hsalt;
  // suspension layer: 16-point trapezoid in log z, summed in node order
  const float lo_z = logf(nan_max(hsalt, 1e-4f));
  const float hi_z = logf(nan_max(ztop, nan_max(hsalt, 1e-4f) * 1.0001f));
  const float dt_q = div_s(hi_z - lo_z, static_cast<float>(kQuad - 1));
  const float zo_safe = nan_max(zo_salt, 1e-10f);
  float sub_prev = 0.0f, tr_prev = 0.0f, sub_sum = 0.0f, tr_sum = 0.0f;
  for (int k = 0; k < kQuad; ++k) {
    const float z = expf(lo_z + (hi_z - lo_z) * nodes[k]);
    const float pz = powf(z / hsalt, expo);
    const float fz = sub_with_height(z, sig_e, F, phi_s, fluct_v, T, pz) * z;
    const float uz = div_s(ushear * logf(z / zo_safe), kVonK);
    const float phi_tz = phi_s * ((T + 1.0f) * pz - T);
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

// What every wind increment of a snow lane reads, formed once a lane by
// the thread that found the lane under snow (calc_blowing_snow's prelude)
enum Pre {
  kPTair, kPSurfWater, kPZ0, kPAirDens, kPEact, kPAge, kPEs, kPF,
  kPUtshear, kPFe, kPSigmaW, kPSigSafe, kPUo, kPHv, kPNd, kPDepth, kNumPre
};

__device__ __forceinline__ void prelude(const LaneInputs& in, LaneRow row,
                                        float dt, float snowdepth,
                                        float (*pre)[kBlock], int slot) {
  auto f = [&](int k) { return lane_f(in, k, row); };
  const float tair = f(kTair), surf_water = f(kSurfWater), z0 = f(kZ0);
  const float ls = f(kLs);
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
  const float displ = f(kDispl);
  const float ut10 = surf_water < 0.001f
                         ? 9.43f + 0.18f * tair + 0.0033f * tair * tair
                         : 9.9f;
  pre[kPTair][slot] = tair;
  pre[kPSurfWater][slot] = surf_water;
  pre[kPZ0][slot] = z0;
  pre[kPAirDens][slot] = f(kAirDens);
  pre[kPEact][slot] = f(kEact);
  pre[kPAge][slot] = age_h;
  pre[kPEs][slot] = es;
  pre[kPF][slot] = F;
  pre[kPUtshear][slot] = kVonK * ut10 / logf(rdiv_s(10.0f, z0));
  pre[kPFe][slot] = fe;
  pre[kPSigmaW][slot] = sigma_w;
  pre[kPSigSafe][slot] = nan_max(sigma_w, 1e-10f);
  pre[kPUo][slot] = wind10;
  pre[kPHv][slot] = 1.5f * displ;
  pre[kPNd][slot] = kFourThirds * f(kRough) / nan_max(displ, 1e-6f);
  pre[kPDepth][slot] = snowdepth;
}

// One work item: wind increment p of the snow lane in `slot`: its share of
// the lane's flux and transport, kArea * sub * prob and kArea * transport
// * prob, as the one-thread-a-lane loop formed them before adding
__device__ __forceinline__ Flux increment(float (*pre)[kBlock],
                                          int slot, int p,
                                          const float* nodes,
                                          const float* log_terms) {
  auto g = [&](int k) { return pre[k][slot]; };
  const float uo = g(kPUo), sigma_w = g(kPSigmaW), sig_safe = g(kPSigSafe);
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
  const float snowdepth = g(kPDepth), hv = g(kPHv);
  const float uveg =
      snowdepth < hv
          ? u10 / sqrtf(1.0f + 170.0f * g(kPNd) *
                                   nan_max(hv - snowdepth, 0.0f))
          : u10;
  const float prob = get_prob(g(kPTair), g(kPAge), g(kPSurfWater), uveg);
  const Flux fl = sub_flux_one(u10, g(kPEs), g(kPEact), g(kPAirDens),
                               g(kPZ0), g(kPFe), g(kPF), g(kPUtshear), nodes);
  return Flux{kArea * fl.sub * prob, kArea * fl.transport * prob};
}

// Each block takes the chunk of kBlock lanes [blockIdx.x * kBlock, ...):
// its threads test one lane each, write the zeros of the lanes without
// snow and list the snow lanes in shared memory (a warp ballot, then the
// warps' counts summed in order), each snow lane's thread forming its
// prelude into its slot. Then the chunk's (snow lane, increment) items are
// dealt to the threads in turn, each item's shares stored by slot and
// increment; then one thread a snow lane sums its ten shares from 0 in
// increment order, applies the -5e-5 floor and writes the lane.
__global__ void __launch_bounds__(kBlock)
    blowing_snow_kernel(const __grid_constant__ LaneInputs in, float dt,
                        const float* quad_nodes, const float* log_terms,
                        int n, float* flux_out, float* transport_out) {
  constexpr int kWarps = kBlock / 32;
  __shared__ float nodes[kQuad];
  __shared__ float logs[2 * kNumIncs];
  __shared__ int lane_of[kBlock];
  __shared__ int warp_count[kWarps];
  __shared__ float pre[kNumPre][kBlock];
  __shared__ float sub_share[kBlock * kNumIncs];
  __shared__ float tr_share[kBlock * kNumIncs];
  const int t = threadIdx.x;
  if (t < kQuad) nodes[t] = quad_nodes[t];
  if (t < 2 * kNumIncs) logs[t] = log_terms[t];
  const int i = blockIdx.x * kBlock + t;
  LaneRow row{0, 0};
  float snowdepth = 0.0f;
  bool snow = false;
  if (i < n) {
    row = lane_row(in, i);
    snowdepth = lane_f(in, kDepth, row);
    snow = snowdepth > 0.0f;
    if (!snow) {   // also a NaN depth: the plain version's where(> 0)
      flux_out[i] = 0.0f;
      transport_out[i] = 0.0f;
    }
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, snow);
  const int warp = t / 32, bit = t % 32;
  if (bit == 0) warp_count[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? warp_count[w] : 0;
    count += warp_count[w];
  }
  if (count == 0) return;   // the same for every thread of the block
  if (snow) {
    const int slot = before + __popc(ballot & ((1u << bit) - 1u));
    lane_of[slot] = i;
    prelude(in, row, dt, snowdepth, pre, slot);
  }
  __syncthreads();
  for (int item = t; item < count * kNumIncs; item += kBlock) {
    const int slot = item / kNumIncs;
    const Flux share =
        increment(pre, slot, item - slot * kNumIncs, nodes, logs);
    sub_share[item] = share.sub;
    tr_share[item] = share.transport;
  }
  __syncthreads();
  if (t < count) {
    float total = 0.0f, total_transport = 0.0f;
#pragma unroll
    for (int p = 0; p < kNumIncs; ++p) {
      total = total + sub_share[t * kNumIncs + p];
      total_transport = total_transport + tr_share[t * kNumIncs + p];
    }
    flux_out[lane_of[t]] = nan_max(total, -5.0e-5f);
    transport_out[lane_of[t]] = total_transport;
  }
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
