// K11 lake_under_ice: the fixed point on the ice/water interface flux qw of
// the column under lake ice, one thread per lake, for sm_90a.
//
// Replaces vic_tpu/physics/lake.py:1112 (water_under_ice, a lax.while_loop
// of up to 50 iterations over the whole [n_cell, 20] batch, each iteration
// temp_area with its Thomas solve and tracer_mixer's 20 red-black sweeps).
// Each thread stops its own lake at |qw_mean - qw| <= 1e-4 or 50
// iterations, the batched loop's result exactly (a done lane keeps its
// outputs and its qw there). Under ice the diffusivity is molecular and the
// shortwave fixed, so the matrix is eliminated once per lake (lake.cuh
// TempArea) and each iteration solves for one surface flux and mixes.
// Lakes that do not converge take the reference's fallback: qw = 0 and the
// column pinned at the freezing point.
//
// Bound by latency: each iteration's 20-layer recurrences and up to 760
// density evaluations of the mix run in one thread's arrays (spilled to
// local memory); a lake reads ~0.3 KB and writes ~0.1 KB.
//
// C interface for ctypes (lanes.cuh): float inputs temp, z, zhalf (20
// layers), surface (21), surfdz, dz, tcutoff, sw_ice, hice, sdepth; masks
// active, mask (20), last (20). Outputs: temp [n, 20]; sc rows qw,
// delta_h, energy_out_bottom [3, n]; converged [n]; the iterations each
// lake ran [n]. Returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "lake.cuh"
#include "lanes.cuh"
#include "physics.cuh"

namespace {

using namespace vicphys;
using namespace vlake;

constexpr int kBlock = 64;
constexpr int kNumIn = 10;
constexpr int kNumMask = 3;
enum In { kTemp, kZ, kZhalf, kSurface, kSurfdz, kDz, kTcutoff, kSwIce,
          kHice, kSdepth };
constexpr float kLamISW = 1.5f, kLamILW = 20.0f;   // ice
constexpr float kLamSSW = 6.0f, kLamSLW = 20.0f;   // snow

__global__ void __launch_bounds__(kBlock)
    lake_under_ice_kernel(const __grid_constant__ LaneInputs in, float dt,
                          int n, float* temp_out, float* sc,
                          uint8_t* converged, int32_t* iterations) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const LaneRow row = lane_row(in, i);
  auto f = [&](int k) { return lane_f(in, k, row); };
  Column col;
  load_column(in, row, kZ, 1, &col);
  float temp[kNN], rho[kNN], cp[kNN];
  for (int k = 0; k < kNN; ++k) {
    temp[k] = lane_fl(in, kTemp, row, k);
    rho[k] = water_density(temp[k]);
    cp[k] = specheat(temp[k]);
  }
  const float tcutoff = f(kTcutoff);
  const float jouleold = energycalc(temp, col, cp, rho);
  const float half_dz = col.surfdz / 2.0f;
  const float qw_init = 0.57f * (temp[0] - tcutoff) / half_dz;
  const float denom = nan_max(col.surface[0] * dt, kSmall);

  float t_new[kNN];
  for (int k = 0; k < kNN; ++k) t_new[k] = temp[k];
  float qw_out = qw_init, dh = 0.0f, e_bot = 0.0f;
  bool done = !lane_m(in, 0, row);
  int trips = 0;
  if (!done) {
    const float sw_ice = f(kSwIce), hice = f(kHice), sdepth = f(kSdepth);
    const float swv =
        kA1 * sw_ice * expf(-1.0f * (kLamISW * hice + kLamSSW * sdepth));
    const float swn =
        kA2 * sw_ice * expf(-1.0f * (kLamILW * hice + kLamSLW * sdepth));
    float de[kNN];
    for (int k = 0; k < kNN; ++k) de[k] = kDM;   // molecular only
    TempArea ta;
    ta.init(temp, rho, cp, de, swv, swn, dt, col);
    float qw = qw_init;
    float t_it[kNN];
    for (int it = 0; it < kEbMaxIter; ++it) {
      ta.solve(-1.0f * qw, t_it);
      const float dh_it = (energycalc(t_it, col, cp, rho) - jouleold) / denom;
      tracer_mix(t_it, col, cp);
      const float qw_final = 0.57f * (t_it[0] - tcutoff) / half_dz;
      const float qw_mean = (qw_final + qw) / 2.0f;
      for (int k = 0; k < kNN; ++k) t_new[k] = t_it[k];
      dh = dh_it;
      e_bot = ta.e_bot;
      qw_out = qw_mean;
      const bool newly = fabsf(qw_mean - qw) <= kEbEps;
      qw = qw_mean;
      trips = it + 1;
      if (newly) {
        done = true;
        break;
      }
    }
    if (!done) {
      // workaround on non-convergence (water_under_ice.c:130-146)
      for (int k = 0; k < kNN; ++k) t_new[k] = tcutoff;
      dh = (energycalc(t_new, col, cp, rho) - jouleold) / denom;
      qw_out = 0.0f;
      e_bot = 0.0f;
    }
  }
  for (int k = 0; k < kNN; ++k) temp_out[static_cast<int64_t>(i) * kNN + k] =
      t_new[k];
  sc[i] = qw_out;
  sc[n + i] = dh;
  sc[2 * static_cast<int64_t>(n) + i] = e_bot;
  converged[i] = done;
  iterations[i] = trips;
}

}  // namespace

extern "C" {

// Replaces vic_tpu/physics/lake.py:1112 (water_under_ice's while_loop, with
// temp_area's Thomas solve and tracer_mixer inside every iteration). h:
// lanes (lakes) per cell row of the inputs' views; n lakes.
int lake_under_ice(const int64_t* lanes, int nf, int nm,
                   int h, float dt, int n, float* temp_out, float* sc,
                   uint8_t* converged, int32_t* iterations, void* stream) {
  LaneInputs in{};
  if (n <= 0 ||
      !fill_lane_inputs(&in, lanes, nf, kNumIn, nm, kNumMask, h))
    return static_cast<int>(cudaErrorInvalidValue);
  lake_under_ice_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      in, dt, n, temp_out, sc, converged, iterations);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
