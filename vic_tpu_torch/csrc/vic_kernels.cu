// Hand-written CUDA kernels of the light VIC step, for sm_90a (H100).
//
//   K1 glacier_brent   <- vic_tpu/physics/glacier.py:130     glacier_ablation
//   K2 snowpack_brent  <- vic_tpu/physics/snow.py:443        snow_melt
//   K3 canopy_brent    <- vic_tpu/physics/canopy_snow.py:270 snow_intercept
//   K4 runoff_hourly   <- vic_tpu/physics/runoff.py:171      runoff_step
//
// On the TPU each of these was a lax while_loop/fori_loop over the whole
// [n_cell, max_hru] batch: every trip re-launched the residual's fusions on
// every lane until the slowest lane converged. Here one thread owns one lane
// and runs that lane's whole loop in registers inside a single launch, so a
// lane pays only its own trip count and nothing leaves the chip between
// iterations. Each lane reads ~20 floats and writes a few, while it runs up
// to ~70 residual evaluations (K1-K3) or 24 hourly trips (K4) of transcendental
// arithmetic with divergent trip counts: the kernels are bound by latency and
// occupancy (registers per thread), not by device-memory bytes. Simple and
// right first; no shared memory, TMA or tensor cores are involved.
//
// Every residual is a line-for-line copy of its PyTorch plain version, with
// the same operation order, x^4 as (x*x)*(x*x) like lax.integer_pow, and the
// library is built with -fmad=false, so a kernel and its plain version
// differ only by libm ulps.
//
// C interface for ctypes: float inputs and uint8 masks come as host arrays
// of device pointers with their strides (lanes.cuh), copied into the
// kernel's parameter block; each launcher returns cudaGetLastError()
// (0 = launched).

#include <cuda_runtime.h>

#include <cstdint>

#include "brent.cuh"
#include "lanes.cuh"
#include "pack_residuals.cuh"
#include "physics.cuh"

namespace {

using namespace vicphys;
using namespace vicres;

constexpr int kBlock = 128;

// evap.penman with rc = 0 (penman.c:96-143, coefficients from
// evap.penman_coeffs)
__device__ __forceinline__ float penman_rc0(float tair, float elevation,
                                            float rad, float vpd, float ra,
                                            float rarc) {
  const float t = 237.3f + tair;
  const float slope = kSvpBC / (t * t) * svp(tair);
  const float h =
      kGasOverG * ((tair + 273.15f) + 0.5f * elevation * (-0.006f));
  const float pz = 101300.0f * expf(-elevation / h);
  const float lv = 2501000.0f - 2361.0f * tair;
  const float gamma = 1628.6f * pz / lv;
  const float r_air = 0.003486f * pz / (275.0f + tair);
  const float ra_safe = nan_max(ra, 1e-10f);
  float evap = (slope * rad + r_air * 1013.0f * vpd / ra_safe) /
               (lv * (slope + gamma * (1.0f + (0.0f + rarc) / ra_safe))) *
               kSecPerDay;
  if (vpd >= 0.0f && evap < 0.0f) evap = 0.0f;
  return evap;
}

// evap.wet_canopy_evap's canopy evaporation, mm/step (canopy_evap.c:46-177)
__device__ __forceinline__ float wet_canopy_evap(float wdew, float prec,
                                                 float wdmax, float rarc,
                                                 float rad, float vpd,
                                                 float air_temp,
                                                 float elevation, float ra,
                                                 float dt) {
  const float wdmax_safe = nan_max(wdmax, 1e-10f);
  const float wdew_c = nan_min(wdew, wdmax);
  const float x = nan_min(nan_max(wdew_c / wdmax_safe, 0.0f), 1.0f);
  const float ce = powf(x, kTwoThirds) *
                   penman_rc0(air_temp, elevation, rad, vpd, ra, rarc) * dt /
                   kSecPerDay;
  const float storage = dt == kSecPerDay ? wdew_c + prec : wdew_c;
  const float f = ce > 0.0f ? nan_min(storage / nan_max(ce, 1e-20f), 1.0f) : 1.0f;
  return ce * f;
}

// K3 residual: canopy_snow.canopy_energy_terms(t)["rest"]
struct CanopyResidual {
  float dt, lai_ra_over, air_dens, vp_air, pressure, le, tcanopy, vpd,
      rainfall_m, net_short_over, long_over_in, long_under_out, int_rain,
      ra_plain, wdew_mm, prec_mm, wdmax_mm, rarc, elevation;
  bool has_csnow;

  __device__ float operator()(float tf) const {
    const float long_over_out = kStefanB * pow4(tf + kKelvin);
    const float net_rad =
        net_short_over + long_over_in + long_under_out - 2.0f * long_over_out;
    float latent, latent_sub, ra_over;
    if (has_csnow) {
      // intercepted-snow branch, ra x 10, no stability correction
      float vmf = air_dens * (kEpsRatio / pressure) * (vp_air - svp(tf)) /
                  lai_ra_over / kRhoW;
      if (vpd == 0.0f && vmf < 0.0f) vmf = 0.0f;
      latent = 0.0f;
      latent_sub = ls_of(tf) * vmf * kRhoW;
      ra_over = lai_ra_over;
    } else {
      // snow-free canopy: wet-canopy evaporation at this net radiation
      const float cevap =
          wet_canopy_evap(wdew_mm, prec_mm, wdmax_mm, rarc, net_rad, vpd,
                          tcanopy, elevation, ra_plain, dt);
      latent = le * (cevap / 1000.0f / dt) * kRhoW;
      latent_sub = 0.0f;
      ra_over = ra_plain;
    }
    const float sensible = air_dens * kCp * (tcanopy - tf) / ra_over;
    const float advected = 4186.8f * tcanopy * rainfall_m / dt;
    const float refreeze = int_rain * kLf * kRhoW / dt;
    const float rest = sensible + latent + latent_sub + net_rad + advected;
    if (!has_csnow) return rest;
    if (tf == 0.0f && rest > -refreeze) return 0.0f;
    return rest + refreeze;
  }
};

__global__ void glacier_brent_kernel(const __grid_constant__ LaneInputs in,
                                     const float* lo, const float* hi,
                                     float dt, int max_iter, int max_tries,
                                     int n, BrentOutputs out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const LaneRow row = lane_row(in, i);
  auto f = [&](int k) { return lane_f(in, k, row); };
  const GlacierResidual r{dt,    f(0),  f(1),  f(2),  f(3),  f(4),
                          f(5),  f(6),  f(7),  f(8),  f(9),  f(10),
                          f(11), f(12), f(13), f(14)};
  store(out, i, brent_solve(r, lo[i], hi[i], lane_m(in, 0, row), max_iter,
                            max_tries));
}

__global__ void snowpack_brent_kernel(const __grid_constant__ LaneInputs in,
                                      const float* lo, const float* hi,
                                      float dt, int max_iter, int max_tries,
                                      int n, BrentOutputs out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const LaneRow row = lane_row(in, i);
  auto f = [&](int k) { return lane_f(in, k, row); };
  const SnowpackResidual r{dt,    f(0),  f(1),  f(2),  f(3),  f(4),  f(5),
                           f(6),  f(7),  f(8),  f(9),  f(10), f(11), f(12),
                           f(13), f(14), f(15), f(16), f(17), f(18),
                           f(19), f(20), lane_m(in, 1, row)};
  store(out, i, brent_solve(r, lo[i], hi[i], lane_m(in, 0, row), max_iter,
                            max_tries));
}

__global__ void canopy_brent_kernel(const __grid_constant__ LaneInputs in,
                                    const float* lo, const float* hi,
                                    float dt, int max_iter, int max_tries,
                                    int n, BrentOutputs out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const LaneRow row = lane_row(in, i);
  auto f = [&](int k) { return lane_f(in, k, row); };
  const CanopyResidual r{dt,    f(0),  f(1),  f(2),  f(3),  f(4),  f(5),
                         f(6),  f(7),  f(8),  f(9),  f(10), f(11), f(12),
                         f(13), f(14), f(15), f(16), f(17),
                         lane_m(in, 1, row)};
  store(out, i, brent_solve(r, lo[i], hi[i], lane_m(in, 0, row), max_iter,
                            max_tries));
}

// K4: the hourly loop of runoff.runoff_hourly_plain (runoff.c:446-700).
// Inputs 0-6 are layered (NL values a lane), 7-12 one value a lane.
template <int NL>
__global__ void runoff_hourly_kernel(const __grid_constant__ LaneInputs in,
                                     int dt_hours, int n, float* liq_out,
                                     float* runoff_out, float* base_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const LaneRow row = lane_row(in, i);
  float liq[NL], ice[NL], evap[NL], resid[NL], mm[NL], ksat[NL], expt[NL];
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    liq[l] = lane_fl(in, 0, row, l);
    ice[l] = lane_fl(in, 1, row, l);
    evap[l] = lane_fl(in, 2, row, l);
    resid[l] = lane_fl(in, 3, row, l);
    mm[l] = lane_fl(in, 4, row, l);
    ksat[l] = lane_fl(in, 5, row, l);
    expt[l] = lane_fl(in, 6, row, l);
  }
  const float dt_runoff = lane_f(in, 7, row), dt_inflow = lane_f(in, 8, row);
  const float dsmax_hr = lane_f(in, 9, row), ds = lane_f(in, 10, row);
  const float ws = lane_f(in, 11, row), c_expt = lane_f(in, 12, row);
  constexpr int lb = NL - 1;

  // excess moves up through layers top..0; what leaves layer 0 is runoff
  auto cascade_up = [&](int top, float amount) {
    for (int up = top; up >= 0; --up) {
      liq[up] = liq[up] + amount;
      amount = nan_max(liq[up] + ice[up] - mm[up], 0.0f);
      liq[up] = nan_min(liq[up], mm[up] - ice[up]);
    }
    return amount;
  };

  float runoff_acc = 0.0f, base_acc = 0.0f;
  for (int hour = 0; hour < dt_hours; ++hour) {
    // drainage between layers from the start-of-hour moisture
    float q12[NL - 1];
#pragma unroll
    for (int l = 0; l < NL - 1; ++l) {
      const float tmp_liq = nan_max(liq[l] - evap[l], resid[l]);
      const float frac = nan_min(
          nan_max((tmp_liq - resid[l]) / nan_max(mm[l] - resid[l], 1e-10f), 0.0f),
          1.0f);
      q12[l] = liq[l] > resid[l] ? ksat[l] * powf(frac, expt[l]) : 0.0f;
    }
    float runoff_h = 0.0f;
    float inflow = dt_inflow;
#pragma unroll
    for (int l = 0; l < NL - 1; ++l) {
      const float dro = l == 0 ? dt_runoff : 0.0f;
      liq[l] = liq[l] + (inflow - dro) - (q12[l] + evap[l]);
      const float excess = nan_max(liq[l] + ice[l] - mm[l], 0.0f);
      liq[l] = nan_min(liq[l], mm[l] - ice[l]);
      if (l == 0) {
        q12[0] = q12[0] + excess;
      } else {
        runoff_h = runoff_h + cascade_up(l - 1, excess);
      }
      const float deficit = nan_min(liq[l] + ice[l] - resid[l], 0.0f);
      q12[l] = q12[l] + deficit;
      liq[l] = nan_max(liq[l], resid[l] - ice[l]);
      inflow = q12[l];
    }
    // ARNO baseflow from the bottom layer
    const float rel_moist =
        (liq[lb] - resid[lb]) / nan_max(mm[lb] - resid[lb], 1e-10f);
    float base = dsmax_hr * ds / ws * rel_moist;
    const float over_ws = nan_max((rel_moist - ws) / nan_max(1.0f - ws, 1e-10f),
                                0.0f);
    base = base + (rel_moist > ws ? dsmax_hr * (1.0f - ds / ws) *
                                        powf(over_ws, c_expt)
                                  : 0.0f);
    base = nan_max(base, 0.0f);
    liq[lb] = liq[lb] + q12[lb - 1] - (evap[lb] + base);
    const float deficit = nan_min(liq[lb] + ice[lb] - resid[lb], 0.0f);
    base = base + deficit;
    liq[lb] = nan_max(liq[lb], resid[lb] - ice[lb]);
    const float over = nan_max(liq[lb] + ice[lb] - mm[lb], 0.0f);
    liq[lb] = nan_min(liq[lb], mm[lb] - ice[lb]);
    runoff_h = runoff_h + cascade_up(lb - 1, over);
    runoff_acc = runoff_acc + runoff_h;
    base_acc = base_acc + base;
  }
#pragma unroll
  for (int l = 0; l < NL; ++l) liq_out[i * NL + l] = liq[l];
  runoff_out[i] = runoff_acc;
  base_out[i] = base_acc;
}

}  // namespace

extern "C" {

// Replaces vic_tpu/physics/glacier.py:130 (glacier_ablation's
// batched_brent). Bound by latency and occupancy: one lane per thread,
// divergent Brent trip counts, ~50 registers, ~70 B read per lane.
// 15 float inputs in GlacierResidual order after dt; masks: [active].
int glacier_brent(const void* const* f, const int32_t* f_stride, int nf,
                  const void* const* m, const int32_t* m_stride, int nm,
                  int h,
                  const float* lo, const float* hi, float dt, int max_iter,
                  int max_tries, int n, float* root, uint8_t* converged,
                  uint8_t* bracketed, int32_t* iterations, void* stream) {
  return launch_brent(glacier_brent_kernel, f, f_stride, nf, 15, m, m_stride,
                      nm, 1, h, lo, hi, dt, max_iter, max_tries, n, root,
                      converged, bracketed, iterations, stream);
}

// Replaces vic_tpu/physics/snow.py:443 (snow_melt's batched_brent). Bound
// by latency and occupancy: one lane per thread, divergent Brent trip
// counts, ~100 B read per lane. 21 float inputs in SnowpackResidual order
// after dt; masks: [active, spatial] (spatial: SPATIAL_SNOW's advected
// sensible heat in the residual, a flag broadcast to the lanes).
int snowpack_brent(const void* const* f, const int32_t* f_stride, int nf,
                   const void* const* m, const int32_t* m_stride, int nm,
                   int h,
                   const float* lo, const float* hi, float dt, int max_iter,
                   int max_tries, int n, float* root, uint8_t* converged,
                   uint8_t* bracketed, int32_t* iterations, void* stream) {
  return launch_brent(snowpack_brent_kernel, f, f_stride, nf, 21, m, m_stride,
                      nm, 2, h, lo, hi, dt, max_iter, max_tries, n, root,
                      converged, bracketed, iterations, stream);
}

// Replaces vic_tpu/physics/canopy_snow.py:270 (snow_intercept's
// batched_brent). Bound by latency and occupancy: one lane per thread,
// divergent Brent trip counts and the two branches of has_csnow, ~85 B
// read per lane. 18 float inputs in CanopyResidual order after dt; masks:
// [active, has_csnow].
int canopy_brent(const void* const* f, const int32_t* f_stride, int nf,
                 const void* const* m, const int32_t* m_stride, int nm,
                 int h,
                 const float* lo, const float* hi, float dt, int max_iter,
                 int max_tries, int n, float* root, uint8_t* converged,
                 uint8_t* bracketed, int32_t* iterations, void* stream) {
  return launch_brent(canopy_brent_kernel, f, f_stride, nf, 18, m, m_stride,
                      nm, 2, h, lo, hi, dt, max_iter, max_tries, n, root,
                      converged, bracketed, iterations, stream);
}

// Replaces vic_tpu/physics/runoff.py:171 (runoff_step's hourly fori_loop).
// Bound by latency: dt_hours dependent trips of ~20 flops and 3 powf per
// lane, ~110 B read and 20 B written per lane. 13 float inputs: liq0, ice,
// evap_hr, resid_mm, max_moist, ksat_hr, expt (layered); dt_runoff,
// dt_inflow, dsmax_hr, ds, ws, c_expt; each with its strides.
int runoff_hourly(const void* const* f, const int32_t* f_stride, int nf, int h,
                  int nl, int dt_hours, int n, float* liq_out,
                  float* runoff_out, float* base_out, void* stream) {
  LaneInputs in{};
  if (n <= 0 || dt_hours < 0 ||
      !fill_lane_inputs(&in, f, f_stride, nf, 13, nullptr, nullptr, 0, 0, h))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kBlock - 1) / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nl == 2) {
    runoff_hourly_kernel<2><<<grid, kBlock, 0, s>>>(in, dt_hours, n, liq_out,
                                                    runoff_out, base_out);
  } else if (nl == 3) {
    runoff_hourly_kernel<3><<<grid, kBlock, 0, s>>>(in, dt_hours, n, liq_out,
                                                    runoff_out, base_out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
