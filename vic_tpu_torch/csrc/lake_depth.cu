// K13 lake_depth: volume -> depth of every lake by bisection on its basin's
// volume curve, one thread per lake, for sm_90a.
//
// Replaces vic_tpu/physics/lake.py:204 (depth_from_volume, a fori_loop of
// 30 bisection steps over the whole [n_cell] batch, each step
// volume_from_depth over the 20 trapezoids of the basin, :171, with
// area_from_depth, :189). The lake path calls it twice a record (the depth
// before the step and solve_lake's); the water balance's 41 depths are
// solved inside lake_water_balance.cu on the same basin code
// (lake_basin.cuh): a thread keeps its basin's tables in shared memory and
// each of the 30 steps searches them for the layers that hold the depth.
// The decisions are the plain version's, so the depths agree bit for bit.
//
// Bound by latency: 30 dependent steps of two 5-step searches and one
// trapezoid per lake, 176 B read and 4 B written per lake.
//
// C interface for ctypes (lanes.cuh): float inputs z, basin (21 levels),
// maxdepth, volume; output depth [n]. Returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "lake_basin.cuh"
#include "lanes.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kNumIn = 4;

__global__ void __launch_bounds__(kBlock)
    lake_depth_kernel(const __grid_constant__ LaneInputs in, int n,
                      float* depth) {
  __shared__ lakebasin::Table<kBlock> table;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const LaneRow row = lane_row(in, i);
  lakebasin::Basin<kBlock> bs;
  bs.load(
      table, threadIdx.x, [&](int k) { return lane_fl(in, 0, row, k); },
      [&](int k) { return lane_fl(in, 1, row, k); });
  depth[i] = bs.depth(lane_f(in, 3, row), lane_f(in, 2, row));
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
