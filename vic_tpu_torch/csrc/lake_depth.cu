// K13 lake_depth: volume -> depth of every lake by bisection on its basin's
// volume curve, one thread per lake, for sm_90a.
//
// Replaces vic_tpu/physics/lake.py:204 (depth_from_volume, a fori_loop of
// 30 bisection steps over the whole [n_cell] batch, each step
// volume_from_depth over the 20 trapezoids of the basin, :171, with
// area_from_depth, :189). The lake path calls it 43 times a record (once
// before the step, once in solve_lake, five times in each of the 8 HRU
// passes of the water balance and once at the end); as plain PyTorch each
// call is ~30 steps of ~30 small launches. Here a thread keeps its basin's
// 21 depths and areas in registers and runs the 30 steps in one launch.
// The full layers are summed in index order, as the plain version and
// vic_tpu's XLA sum them, so the comparisons v > volume fall the same way
// and the depths agree bit for bit.
//
// Bound by latency: 30 dependent steps of ~150 operations per lake, 176 B
// read and 4 B written per lake.
//
// C interface for ctypes (lanes.cuh): float inputs z, basin (21 levels),
// maxdepth, volume; output depth [n]. Returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "lanes.cuh"
#include "physics.cuh"

namespace {

using vicphys::nan_max;

constexpr int kBlock = 128;
constexpr int kLevels = 21;     // MAX_LAKE_NODES + 1
constexpr int kIters = 30;
constexpr int kNumIn = 4;

struct Basin {
  float z[kLevels], b[kLevels], layer_vol[kLevels - 1];

  // physics.lake.area_from_depth
  __device__ float area(float d) const {
    float a = 0.0f;
    for (int k = 0; k < kLevels - 1; ++k) {
      const bool inlayer = d <= z[k] && d > z[k + 1];
      const float w = (d - z[k + 1]) / nan_max(z[k] - z[k + 1], 1e-10f);
      if (inlayer) a = b[k + 1] + w * (b[k] - b[k + 1]);
    }
    a = d >= z[0] ? b[0] : a;
    return d <= 0.0f ? 0.0f : a;
  }

  // physics.lake.volume_from_depth, each sum in index order
  __device__ float volume(float d) const {
    const float a_surf = area(d);
    float full = 0.0f, part = 0.0f;
    for (int k = 0; k < kLevels - 1; ++k) {
      const float vf = d >= z[k] ? layer_vol[k] : 0.0f;
      const bool partial = d > z[k + 1] && d < z[k];
      const float h = nan_max(d - z[k + 1], 0.0f);
      const float vp = partial ? h * (a_surf + b[k + 1]) / 2.0f : 0.0f;
      full = k == 0 ? vf : full + vf;
      part = k == 0 ? vp : part + vp;
    }
    return full + part;
  }
};

__global__ void __launch_bounds__(kBlock)
    lake_depth_kernel(const __grid_constant__ LaneInputs in, int n,
                      float* depth) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const LaneRow row = lane_row(in, i);
  Basin bs;
  for (int k = 0; k < kLevels; ++k) {
    bs.z[k] = lane_fl(in, 0, row, k);
    bs.b[k] = lane_fl(in, 1, row, k);
  }
  for (int k = 0; k < kLevels - 1; ++k)
    bs.layer_vol[k] = (bs.z[k] - bs.z[k + 1]) * (bs.b[k] + bs.b[k + 1]) / 2.0f;
  const float maxdepth = lane_f(in, 2, row);
  const float volume = lane_f(in, 3, row);
  float lo = 0.0f, hi = maxdepth * 1.0f;
  for (int it = 0; it < kIters; ++it) {
    const float mid = 0.5f * (lo + hi);
    const bool high = bs.volume(mid) > volume;
    lo = high ? lo : mid;
    hi = high ? mid : hi;
  }
  const float d = 0.5f * (lo + hi);
  depth[i] = volume <= 0.0f ? 0.0f : d;
}

}  // namespace

extern "C" {

// Replaces vic_tpu/physics/lake.py:204 (depth_from_volume's fori_loop).
int lake_depth(const int64_t* lanes, int nf, int h,
               int n, float* depth, void* stream) {
  LaneInputs in{};
  if (n <= 0 || !fill_lane_inputs(&in, lanes, nf, kNumIn, 0, 0, h))
    return static_cast<int>(cudaErrorInvalidValue);
  lake_depth_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(in, n, depth);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
