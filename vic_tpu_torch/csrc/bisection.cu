// K17 bisection <- vic_tpu/ops/rootfind.py:210 batched_bisection
//
// On the TPU this was a lax.fori_loop of n_iter trips over the whole batch,
// each trip one residual evaluation of every lane. vic_tpu's function takes
// any Python callable; a CUDA kernel cannot, so K17 runs the residuals the
// library compiles: the snowpack surface balance of K2 (SnowpackResidual,
// with SPATIAL_SNOW's advected sensible heat where the flag is set) and the
// bare-glacier balance of K1 (GlacierResidual).
//
// What bounds it: every active lane runs n_iter + 2 dependent residual
// evaluations (~55 FP32 operations, an expf, a logf, a sqrtf and 12-15
// IEEE divisions each) against ~90 B read and 10 B written, so the chain
// of one lane's evaluations, not bytes: ~1.5 us an evaluation on an H100
// (PERF.md). The active lanes are few and scattered (K1's
// residual: the bare glacier lanes, at most 2 of a cell's 8): one thread a
// lane left every warp of 4 cells holding a glacier lane issuing all 42
// evaluations with most of its threads idle. Here the lanes run on
// csrc/lane_brent.cuh's driver with BisectionLane as its stepper. Every
// active lane takes the same number of evaluations, so the driver deals
// them from one queue for the whole grid (lane_queue_kernel): the active
// lanes compacted into whole warps of persistent blocks, which solve
// together with no vote between evaluations, an inactive lane's outputs
// written as its warp passes it, and as many rounds as the active lanes
// need of the resident threads (one on light's arguments). Each lane's
// floats are those of the one-thread loop this replaced.
//
// C interface for ctypes as the Brent kernels' (lanes.cuh): lo and hi are
// the lane table's last two float inputs; returns cudaGetLastError(),
// cudaErrorInvalidValue for an unknown residual or input counts that are
// not its own, vicbrent::kNoResidentBlock where no block fits on an SM.

#include <cuda_runtime.h>

#include <cstdint>

#include "brent.cuh"
#include "lane_brent.cuh"
#include "lanes.cuh"
#include "pack_residuals.cuh"

namespace {

using namespace vicres;

enum Residual { kSnowpack = 0, kGlacier = 1 };

struct BisectionParams {
  float dt;
};

// the snowpack residual's lane: the 21 float inputs in SnowpackResidual
// order after dt, then lo and hi; masks [active, spatial]
struct SnowBisectLane : SnowpackResidual {
  static constexpr int kNumIn = 21, kNumMasks = 2;
  static constexpr int kLo = kNumIn, kHi = kNumIn + 1, kActive = 0;
  static constexpr int kMinBlocks = 1;

  __device__ __forceinline__ void init(const LaneInputs& in, LaneRow row,
                                       const BisectionParams& p) {
    auto f = [&](int k) { return lane_f(in, k, row); };
    *static_cast<SnowpackResidual*>(this) = SnowpackResidual{
        p.dt,  f(0),  f(1),  f(2),  f(3),  f(4),  f(5),  f(6),
        f(7),  f(8),  f(9),  f(10), f(11), f(12), f(13), f(14),
        f(15), f(16), f(17), f(18), f(19), f(20), lane_m(in, 1, row)};
  }
};

// the bare-glacier residual's lane: the 15 float inputs in GlacierResidual
// order after dt, then lo and hi; masks [active]
struct GlacierBisectLane : GlacierResidual {
  static constexpr int kNumIn = 15, kNumMasks = 1;
  static constexpr int kLo = kNumIn, kHi = kNumIn + 1, kActive = 0;
  static constexpr int kMinBlocks = 1;

  __device__ __forceinline__ void init(const LaneInputs& in, LaneRow row,
                                       const BisectionParams& p) {
    auto f = [&](int k) { return lane_f(in, k, row); };
    *static_cast<GlacierResidual*>(this) = GlacierResidual{
        p.dt,  f(0),  f(1),  f(2),  f(3),  f(4),  f(5),  f(6),
        f(7),  f(8),  f(9),  f(10), f(11), f(12), f(13), f(14)};
  }
};

template <class Lane>
int launch(const int64_t* lanes, int nf, int nm, int h, float dt,
           int n_iter, int n, const BrentOutputs& out, void* stream) {
  LaneInputs in{};
  if (n <= 0 || n_iter < 0 ||
      !fill_lane_inputs(&in, lanes, nf, Lane::kNumIn + 2, nm,
                        Lane::kNumMasks, h))
    return static_cast<int>(cudaErrorInvalidValue);
  return vicbrent::launch_lane_brent<Lane, BisectionParams,
                                     vicbrent::BisectionLane>(
      in, BisectionParams{dt}, n_iter, 0, n, out,
      static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// residual 0: the snowpack (SnowBisectLane's inputs); 1: bare glacier ice
// (GlacierBisectLane's).
int bisection(int residual, const int64_t* lanes, int nf, int nm, int h,
              float dt, int n_iter, int n, float* root, uint8_t* converged,
              uint8_t* bracketed, int32_t* iterations, void* stream) {
  const BrentOutputs out{root, converged, bracketed, iterations};
  if (residual == kSnowpack)
    return launch<SnowBisectLane>(lanes, nf, nm, h, dt, n_iter, n, out,
                                  stream);
  if (residual == kGlacier)
    return launch<GlacierBisectLane>(lanes, nf, nm, h, dt, n_iter, n, out,
                                     stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
