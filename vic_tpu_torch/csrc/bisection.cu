// K17 bisection <- vic_tpu/ops/rootfind.py:210 batched_bisection
//
// On the TPU this was a lax.fori_loop of n_iter trips over the whole batch,
// each trip one residual evaluation of every lane. vic_tpu's function takes
// any Python callable; a CUDA kernel cannot, so K17 runs the residuals the
// library compiles: the snowpack surface balance of K2 (SnowpackResidual,
// with SPATIAL_SNOW's advected sensible heat where the flag is set) and the
// bare-glacier balance of K1 (GlacierResidual). One thread runs one lane's
// n_iter + 2 evaluations in registers. Bound by operations and latency:
// ~85 FP32 operations (an expf, a logf, a sqrtf) per evaluation against
// ~90 B read and 10 B written per lane.
//
// C interface for ctypes as the Brent kernels' (lanes.cuh): returns
// cudaGetLastError(), or cudaErrorInvalidValue for an unknown residual or
// input counts that are not its own.

#include <cuda_runtime.h>

#include <cstdint>

#include "bisection.cuh"
#include "lanes.cuh"
#include "pack_residuals.cuh"

namespace {

using namespace vicres;

constexpr int kBlock = 128;
enum Residual { kSnowpack = 0, kGlacier = 1 };

__global__ void bisection_kernel(const __grid_constant__ LaneInputs in,
                                 int residual, const float* lo,
                                 const float* hi, float dt, int n_iter, int n,
                                 BrentOutputs out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const LaneRow row = lane_row(in, i);
  auto f = [&](int k) { return lane_f(in, k, row); };
  const bool active = lane_m(in, 0, row);
  if (residual == kSnowpack) {
    const SnowpackResidual r{dt,    f(0),  f(1),  f(2),  f(3),  f(4),  f(5),
                             f(6),  f(7),  f(8),  f(9),  f(10), f(11), f(12),
                             f(13), f(14), f(15), f(16), f(17), f(18),
                             f(19), f(20), lane_m(in, 1, row)};
    store(out, i, bisection_solve(r, lo[i], hi[i], active, n_iter));
  } else {
    const GlacierResidual r{dt,    f(0),  f(1),  f(2),  f(3),  f(4),
                            f(5),  f(6),  f(7),  f(8),  f(9),  f(10),
                            f(11), f(12), f(13), f(14)};
    store(out, i, bisection_solve(r, lo[i], hi[i], active, n_iter));
  }
}

}  // namespace

extern "C" {

// residual 0: the snowpack (21 float inputs in SnowpackResidual order after
// dt; masks [active, spatial]); 1: bare glacier ice (15 floats in
// GlacierResidual order; masks [active]).
int bisection(int residual, const void* const* f, const int32_t* f_stride,
              int nf, const void* const* m, const int32_t* m_stride, int nm,
              int h, const float* lo, const float* hi, float dt, int n_iter,
              int n, float* root, uint8_t* converged, uint8_t* bracketed,
              int32_t* iterations, void* stream) {
  LaneInputs in{};
  const bool snow = residual == kSnowpack;
  if ((!snow && residual != kGlacier) || n <= 0 || n_iter < 0 ||
      !fill_lane_inputs(&in, f, f_stride, nf, snow ? 21 : 15, m, m_stride,
                        nm, snow ? 2 : 1, h))
    return static_cast<int>(cudaErrorInvalidValue);
  const BrentOutputs out{root, converged, bracketed, iterations};
  bisection_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      in, residual, lo, hi, dt, n_iter, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
