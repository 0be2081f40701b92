// K5 surface_brent: the soil-surface temperature of the QUICK_FLUX step,
// with or without FROZEN_SOIL's fusion term, for sm_90a (H100).
//
// Replaces vic_tpu/physics/surface.py:438 (solve_surface_temperature's
// batched_brent on surf_energy_terms, residual :71-378). On the TPU the
// Brent was a lax while_loop over the whole [n_cell, max_hru] batch: every
// iteration re-ran the ~300-line residual's fusions on every lane until the
// slowest lane converged; its PyTorch plain version
// (physics/surface.surface_brent_plain) also pays one device-to-host sync
// per iteration. Here one thread owns one lane and runs bracket expansion
// and Brent (brent.cuh) on the residual of surface_brent.cuh inside one
// launch. A lane reads 53 floats, 5 x nl layer floats and 5 masks (~280 B;
// less where an input is shared by the HRUs of a cell; with DIST_PRCP the
// dry column's 7 floats, 4 x nl layer floats and a mask more; with
// FROZEN_SOIL the fusion's 5 floats and a mask more) and writes
// 10 B, while it runs up to ~70 residual evaluations of ~150 flops and a
// few log/sqrt/exp each: the kernel is bound by latency and occupancy (a residual with ~65 live per-lane terms costs registers), not
// by device-memory bytes. Simple and right first: no shared memory.
//
// C interface for ctypes: the 53 float inputs, the 5 layered ones, the dry
// column's 11 and the fusion's 5, and the 7 uint8 masks, as host arrays of
// device pointers with their strides (lanes.cuh); returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "brent.cuh"
#include "lanes.cuh"
#include "surface_brent.cuh"

namespace {

constexpr int kBlock = 128;

template <int NL, bool DIST>
__global__ void surface_brent_kernel(const __grid_constant__ LaneInputs in,
                                     const float* lo, const float* hi,
                                     float dt, int gft, int frozen,
                                     int max_iter, int max_tries, int n,
                                     float* root, uint8_t* converged,
                                     uint8_t* bracketed,
                                     int32_t* iterations) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const LaneRow row = lane_row(in, i);
  vicsurf::SurfaceResidual<NL, DIST> r;
  r.init(in, row, dt, gft);
  r.init_fusion(in, row, frozen != 0);
  const BrentOut out =
      brent_solve(r, lo[i], hi[i], lane_m(in, vicsurf::kActive, row),
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
// frozen: the fusion term is added (FROZEN_SOIL).
int surface_brent(const void* const* f, const int32_t* f_stride, int nf,
                  const void* const* m, const int32_t* m_stride, int nm,
                  int h, int nl, int dist, const float* lo, const float* hi,
                  float dt, int grnd_flux_type, int frozen, int max_iter,
                  int max_tries, int n, float* root, uint8_t* converged,
                  uint8_t* bracketed, int32_t* iterations, void* stream) {
  LaneInputs in{};
  if (n <= 0 ||
      !fill_lane_inputs(&in, f, f_stride, nf,
                        vicsurf::kNumSurfaceIn + vicsurf::kNumFdIn, m,
                        m_stride, nm, vicsurf::kNumSurfaceMask + 1, h))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kBlock - 1) / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VIC_SURFACE_LAUNCH(NL_, DIST_)                                     \
  surface_brent_kernel<NL_, DIST_><<<grid, kBlock, 0, s>>>(                \
      in, lo, hi, dt, grnd_flux_type, frozen, max_iter, max_tries, n,      \
      root,                                                                \
      converged, bracketed, iterations)
  if (nl == 2 && dist) {
    VIC_SURFACE_LAUNCH(2, true);
  } else if (nl == 2) {
    VIC_SURFACE_LAUNCH(2, false);
  } else if (nl == 3 && dist) {
    VIC_SURFACE_LAUNCH(3, true);
  } else if (nl == 3) {
    VIC_SURFACE_LAUNCH(3, false);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VIC_SURFACE_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
