// K15 mass_release <- vic_tpu/physics/canopy_snow.py:126 mass_release
//
// On the TPU this was a lax.fori_loop of 8 rounds over the whole batch of
// [n_cell, max_hru] lanes (massrelease.c re-expressed as fixed rounds):
// while the melt storage reaches 10% of the intercepted snow above
// MIN_INTERCEPTION_STORAGE, up to 17% of it falls as snow; otherwise the
// storage drips off as liquid. Here one thread runs one lane's rounds in
// registers. Bound by bytes: 8 B read and 16 B written per lane against
// ~15 FP32 operations per round. Every min/max propagates NaN as
// jnp.minimum/maximum do.
//
// C interface for ctypes: the two inputs as lanes.cuh passes them; returns
// cudaGetLastError(), or cudaErrorInvalidValue for bad counts.

#include <cuda_runtime.h>

#include <cstdint>

#include "lanes.cuh"
#include "physics.cuh"

namespace {

using namespace vicphys;

constexpr int kBlock = 128;
constexpr float kMinInterceptionStorage = 0.005f;   // m

__global__ void mass_release_kernel(const __grid_constant__ LaneInputs in,
                                    int n_iter, int n, float* int_snow_out,
                                    float* storage_out, float* released_out,
                                    float* drip_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const LaneRow row = lane_row(in, i);
  float isnow = lane_f(in, 0, row), tstore = lane_f(in, 1, row);
  float rel = 0.0f, drp = 0.0f;
  for (int it = 0; it < n_iter; ++it) {
    const bool big = isnow > kMinInterceptionStorage;
    const float threshold = 0.10f * isnow;
    const float max_release = 0.17f * isnow;
    const bool do_release = big && tstore >= threshold;
    const float amount =
        nan_min(nan_max(isnow - kMinInterceptionStorage, 0.0f), max_release);
    const float isnow2 = do_release ? isnow - amount : isnow;
    rel = rel + (do_release ? amount : 0.0f);
    // drip branch: the storage drains as liquid
    const float tempdrip = nan_min(tstore, isnow2);
    drp = drp + (do_release ? 0.0f : tempdrip);
    isnow = do_release ? isnow2 : isnow2 - tempdrip;
    tstore = do_release ? tstore : tstore - tempdrip;
  }
  int_snow_out[i] = isnow;
  storage_out[i] = tstore;
  released_out[i] = rel;
  drip_out[i] = drp;
}

}  // namespace

extern "C" {

// 2 float inputs: int_snow, temp_int_storage (m), each with its strides.
int mass_release(const int64_t* lanes, int nf, int h,
                 int n_iter, int n, float* int_snow_out, float* storage_out,
                 float* released_out, float* drip_out, void* stream) {
  LaneInputs in{};
  if (n <= 0 || n_iter < 0 ||
      !fill_lane_inputs(&in, lanes, nf, 2, 0, 0, h))
    return static_cast<int>(cudaErrorInvalidValue);
  mass_release_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      in, n_iter, n, int_snow_out, storage_out, released_out, drip_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
