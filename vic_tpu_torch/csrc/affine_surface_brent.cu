// K14 affine_surface_brent: the soil-surface temperature of the CLOSE_ENERGY
// passes on finite-difference nodes, for sm_90a (H100).
//
// Replaces vic_tpu/physics/surface.py:438 (solve_surface_temperature's
// batched_brent) in its fd_affine form (:421-433): the node profile is
// solved twice, from the carried temperatures, with the two bracket ends
// t_lower and t_upper as the node-0 boundary (K6, before this launch), and
// the residual :71-378 takes nodes 1 and 2 interpolated affinely between
// those two probes at each candidate Ts (:155-158), then the
// finite-difference ground heat and the top node pair's fusion
// (surface_brent.cuh fd()). A candidate outside the original bracket, once
// the expansion widened it (vic_tpu/ops/rootfind.py:115), extrapolates from
// the same two probes, as the reference does.
//
// Unlike K7's residual, this one is elementwise: the probes are fixed
// before the solve, so no lane's residual depends on another's candidate,
// and a per-lane Brent (brent.cuh) gives the batch loop's result, as K5
// does. One thread owns one lane and runs expansion and Brent in one
// launch. The interpolation's weight is a true float32 division, lane by
// lane, as the plain version's tensor division is.
//
// A lane reads K5's ~64 inputs (~300 B; the dry column's ~80 B more with
// DIST_PRCP), the 5 fusion inputs and 4 probe temperatures, and writes 10 B,
// while it runs ~10-70 residual evaluations of ~170 flops: bound by latency
// and occupancy, as K5, not by device-memory bytes.
//
// C interface for ctypes: K5's float inputs (with the dry column's), the 5
// fusion inputs, the bracket ends ts_a and ts_b of the probes and the two
// probe profiles (layered, nn nodes), then K5's masks and fs_active, as host
// arrays of device pointers with their strides (lanes.cuh); returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "brent.cuh"
#include "lanes.cuh"
#include "surface_brent.cuh"

namespace {

constexpr int kBlock = 128;

// the probes' inputs after the fusion inputs (kernels.AFFINE_INPUTS)
enum AffIn { kTsA, kTsB, kProbeLo, kProbeHi, kNumAffIn };
constexpr int kAffIn = vicsurf::kNumSurfaceIn + vicsurf::kNumFdIn;

template <int NL, bool DIST>
struct AffineResidual {
  vicsurf::SurfaceResidual<NL, DIST> r;
  float ts_a, ts_b, lo1, lo2, hi1, hi2;

  // nodes 1-2 of the profile interpolated between the probes
  // (vic_tpu/physics/surface.py:157-158)
  __device__ float operator()(float ts) const {
    const float wq = (ts - ts_a) / (ts_b - ts_a);
    return r.fd(ts, lo1 + wq * (hi1 - lo1), lo2 + wq * (hi2 - lo2));
  }
};

template <int NL, bool DIST>
__global__ void affine_surface_brent_kernel(
    const __grid_constant__ LaneInputs in, const float* lo, const float* hi,
    float dt, int gft, int frozen, int max_iter, int max_tries, int n,
    float* root, uint8_t* converged, uint8_t* bracketed,
    int32_t* iterations) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const LaneRow row = lane_row(in, i);
  AffineResidual<NL, DIST> f;
  f.r.init(in, row, dt, gft);
  f.r.init_fd(in, row, frozen != 0);
  f.ts_a = lane_f(in, kAffIn + kTsA, row);
  f.ts_b = lane_f(in, kAffIn + kTsB, row);
  f.lo1 = lane_fl(in, kAffIn + kProbeLo, row, 1);
  f.lo2 = lane_fl(in, kAffIn + kProbeLo, row, 2);
  f.hi1 = lane_fl(in, kAffIn + kProbeHi, row, 1);
  f.hi2 = lane_fl(in, kAffIn + kProbeHi, row, 2);
  const BrentOut out =
      brent_solve(f, lo[i], hi[i], lane_m(in, vicsurf::kActive, row),
                  max_iter, max_tries);
  root[i] = out.root;
  converged[i] = out.converged;
  bracketed[i] = out.bracketed;
  iterations[i] = out.iterations;
}

}  // namespace

extern "C" {

// nf, nm: the input counts, checked against the residual's; h: lanes per
// cell; nl: soil layers (2 or 3); dist: the dry column is read (DIST_PRCP);
// nn: nodes of the probe profiles (at least 3); frozen: the fusion term.
int affine_surface_brent(const void* const* f, const int32_t* f_stride,
                         int nf, const void* const* m,
                         const int32_t* m_stride, int nm, int h, int nl,
                         int dist, int nn, const float* lo, const float* hi,
                         float dt, int grnd_flux_type, int frozen,
                         int max_iter, int max_tries, int n, float* root,
                         uint8_t* converged, uint8_t* bracketed,
                         int32_t* iterations, void* stream) {
  LaneInputs in{};
  if (n <= 0 || nn < 3 ||
      !fill_lane_inputs(&in, f, f_stride, nf, kAffIn + kNumAffIn, m,
                        m_stride, nm, vicsurf::kNumSurfaceMask + 1, h))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kBlock - 1) / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VIC_AFFINE_LAUNCH(NL_, DIST_)                                       \
  affine_surface_brent_kernel<NL_, DIST_><<<grid, kBlock, 0, s>>>(          \
      in, lo, hi, dt, grnd_flux_type, frozen, max_iter, max_tries, n, root, \
      converged, bracketed, iterations)
  if (nl == 2 && dist) {
    VIC_AFFINE_LAUNCH(2, true);
  } else if (nl == 2) {
    VIC_AFFINE_LAUNCH(2, false);
  } else if (nl == 3 && dist) {
    VIC_AFFINE_LAUNCH(3, true);
  } else if (nl == 3) {
    VIC_AFFINE_LAUNCH(3, false);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VIC_AFFINE_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
