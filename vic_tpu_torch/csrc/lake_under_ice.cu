// K11 lake_under_ice: the fixed point on the ice/water interface flux qw of
// the column under lake ice, one warp per lake, for sm_90a.
//
// Replaces vic_tpu/physics/lake.py:1112 (water_under_ice, a lax.while_loop
// of up to 50 iterations over the whole [n_cell, 20] batch, each iteration
// temp_area with its Thomas solve and tracer_mixer's 20 red-black sweeps).
// Each warp stops its own lake at |qw_mean - qw| <= 1e-4 or 50
// iterations, the batched loop's result exactly (a done lane keeps its
// outputs and its qw there). Under ice the diffusivity is molecular and the
// shortwave fixed, so the matrix is eliminated once per lake (lake.cuh
// TempArea) and each iteration solves for one surface flux and mixes.
// Lakes that do not converge take the reference's fallback: qw = 0 and the
// column pinned at the freezing point.
//
// The design (lake.cuh): layer k of a lake on lane k, in registers; the
// per-layer set-up in parallel across the lanes; each iteration the two
// Thomas recurrences on lane 0 over the rows the lanes left in the warp's
// shared memory, the column's energy as an ordered chain of broadcasts, and
// the mix run pass by pass across the
// lanes and stopped after its first sweep that mixes no pair (mostly the
// first: an iced column is stably stratified). Persistent blocks deal the
// lakes to their warps; a lake without ice gets its outputs at once: its
// column, qw = 0.57 (T0 - tcutoff) / (surfdz / 2), no change, converged,
// 0 iterations. A lake reads ~0.3 KB and writes ~0.1 KB; the device time
// is the warps' serial chains, ~20 dependent divisions and ~40 shuffles an
// iteration.
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

constexpr int kNumIn = 10;
constexpr int kNumMask = 3;
enum In { kTemp, kZ, kZhalf, kSurface, kSurfdz, kDz, kTcutoff, kSwIce,
          kHice, kSdepth };
constexpr float kLamISW = 1.5f, kLamILW = 20.0f;   // ice
constexpr float kLamSSW = 6.0f, kLamSLW = 20.0f;   // snow
// six blocks an SM: ptxas keeps the kernel in 72 registers with no spill,
// where unbounded it took 80 and spilled 12 B (H100, PERF.md)
constexpr int kMinBlocks = 6;

__global__ void __launch_bounds__(kLakeBlock, kMinBlocks)
    lake_under_ice_kernel(const __grid_constant__ LaneInputs in, float dt,
                          int n, int chunk, float* temp_out, float* sc,
                          uint8_t* converged, int32_t* iterations) {
  for_each_lake(n, chunk, [&](int i, int k, Rows* rows) {
    const LaneRow row = lane_row(in, i);
    auto f = [&](int j) { return lane_f(in, j, row); };
    const bool layer = k < kNN;
    const int64_t at = static_cast<int64_t>(i) * kNN + k;
    // every input read at once (the lake's values on every lane)
    const float temp = layer ? lane_fl(in, kTemp, row, k) : 0.0f;
    const bool active = lane_m(in, 0, row);
    const float tcutoff = f(kTcutoff);
    const float sw_ice = f(kSwIce), hice = f(kHice), sdepth = f(kSdepth);
    const float half_dz = f(kSurfdz) / 2.0f;
    const float qw_init = 0.57f * (bcast(temp, 0) - tcutoff) / half_dz;
    if (!active) {
      if (layer) temp_out[at] = temp;
      if (k == 0) {
        sc[i] = qw_init;
        sc[n + i] = 0.0f;
        sc[2 * static_cast<int64_t>(n) + i] = 0.0f;
        converged[i] = 1;
        iterations[i] = 0;
      }
      return;
    }
    const Layer l = load_layer(in, row, kZ, 1, k);
    const float rho = water_density(temp);
    const float cp = specheat(temp);
    const float jouleold = energycalc(temp, l, cp, rho);
    const float denom = nan_max(l.surface0 * dt, kSmall);
    const float swv =
        kA1 * sw_ice * expf(-1.0f * (kLamISW * hice + kLamSSW * sdepth));
    const float swn =
        kA2 * sw_ice * expf(-1.0f * (kLamILW * hice + kLamSLW * sdepth));
    TempArea ta;
    ta.init(temp, rho, cp, kDM, swv, swn, dt, l, rows);   // molecular only

    float qw = qw_init, qw_out = qw_init, dh = 0.0f, e_bot = 0.0f;
    float t_new = temp;
    bool done = false;
    int trips = 0;
    for (int it = 0; it < kEbMaxIter; ++it) {
      float t_it = ta.solve(-1.0f * qw, k);
      const float dh_it = (energycalc(t_it, l, cp, rho) - jouleold) / denom;
      tracer_mix(t_it, l, cp);
      const float qw_final = 0.57f * (bcast(t_it, 0) - tcutoff) / half_dz;
      const float qw_mean = (qw_final + qw) / 2.0f;
      t_new = t_it;
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
      t_new = tcutoff;
      dh = (energycalc(t_new, l, cp, rho) - jouleold) / denom;
      qw_out = 0.0f;
      e_bot = 0.0f;
    }
    if (layer) temp_out[at] = t_new;
    if (k == 0) {
      sc[i] = qw_out;
      sc[n + i] = dh;
      sc[2 * static_cast<int64_t>(n) + i] = e_bot;
      converged[i] = done;
      iterations[i] = trips;
    }
  });
}

int resident[kMaxDevices];   // blocks of the kernel resident on a device

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
  int blocks = 0, chunk = 0;
  const int err = lake_grid(
      reinterpret_cast<const void*>(lake_under_ice_kernel), n, resident,
      &blocks, &chunk);
  if (err != 0) return err;
  lake_under_ice_kernel<<<blocks, kLakeBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      in, dt, n, chunk, temp_out, sc, converged, iterations);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
