// K6 node_sweep: the frozen-soil Gauss-Seidel node sweep, for sm_90a (H100).
//
// Replaces vic_tpu/physics/frozen_soil.py:311 (solve_t_profile_explicit:
// the sweep while_loop :570 with the 16-step bisection fori_loop :523 of
// the nodes below the soil layers) where it runs outside K7: the two probe
// profiles of each CLOSE_ENERGY pass (K14's). Every [n_cell, max_hru] lane
// of a [.., nn] node profile, 3 <= nn <= 50 (the reference's MAX_NODES), on
// linear or EXP_TRANS node spacing.
//
// One cooperative launch per call (node_sweep.cuh): the lanes' coefficients
// once, then the batch-wide sweeps with a grid sync after each and the stop
// decided there, then the cold-nose fix and the revert; the sweep count
// comes back as a device int. Nothing returns to the host in between, and
// no launch is made for a sweep that does not run. The grid is the
// co-resident block count (at most one block per tile of lanes), each
// block walking its tiles (node_sweep.cuh for_each_lane).
//
// With a share group (the lanes one share of a block split across
// launches, parallel/votes.py) the group instance (G) runs: each sweep's
// decision is also taken over the other shares' lanes (node_sweep.cuh
// share_max), and the grid is the co-resident blocks divided by the shares
// on this device. The instances without a group compile as they did
// before share groups.
//
// Bound: each sweep streams the lane's 7 node-major coefficient rows and
// the iterate (read and write) per node, and up to ~28 residual evaluations
// with a powf and a division each on a frozen node below the soil layers;
// the bound the smoke gives counts both.
//
// C interface for ctypes: returns 0, a CUDA error, or kNoCooperativeLaunch /
// kGridNotCoResident (node_sweep.cuh).

#include <cuda_runtime.h>

#include <cstdint>

#include "node_sweep.cuh"

namespace {

using vicnode::kBlock;
using vicnode::SweepArgs;

template <int NN, bool G>
__global__ void __launch_bounds__(kBlock, vicnode::kMinBlocks)
    node_sweep_kernel(const __grid_constant__ SweepArgs a,
                      const float* surf_temp, int32_t* ctl,
                      int32_t* sweeps_out) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  constexpr int kLanes = vicnode::lanes_of(NN);
  vicnode::for_each_lane<kLanes>(
      a.n, [&](int i) { vicnode::lane_coefficients(a, i); });
  for (int s = vicnode::thread_rank(); s < 2 * a.max_sweeps;
       s += vicnode::thread_count())
    ctl[s] = 0;
  grid.sync();
  const int sweeps = vicnode::solve_profile<NN, true, G>(
      a, [&](int i) { return surf_temp[i]; }, ctl, grid);
  vicnode::for_each_lane<kLanes>(a.n, [&](int i) {
    vicnode::finish_lane<NN, true>(a, i, surf_temp[i], sweeps);
  });
  if (vicnode::thread_rank() == 0) sweeps_out[0] = sweeps;
}

}  // namespace

extern "C" {

// lane: t0, kappa, cs, moist, ice0 ([n, nn]); geom: alpha, beta, gamma,
// e_coef, solver_max_moist, solver_bubble, solver_expt, zp1 ([n_cell, nn])
// and exp_a, bexp ([n_cell]); 3 <= nn <= 50; exp_trans: EXP_TRANS spacing;
// work: the scratch of enum vicnode::Work (fallback counts included);
// surf_temp: [n]; ctl: int32 [2 * max_sweeps], zeroed by the kernel;
// t_out, fb_out: [n, nn]; sweeps: int32 [1]; blocks: the grid (0: the
// co-resident count); group: the share group's table (share_votes.cuh
// fill_share_votes; null: the lanes are the whole batch).
int node_sweep(const void* const* lane, const void* const* geom,
               const uint8_t* fs_active, int nn, int nlayer, int frozen,
               int noflux, int exp_trans, int max_sweeps, float dt,
               float two_dt, float four_dt, const void* const* work,
               const float* surf_temp, int n, int h, int32_t* ctl,
               float* t_out, int32_t* fb_out, int32_t* sweeps, int blocks,
               const int64_t* group, void* stream) {
  SweepArgs a{};
  if (!vicnode::fill_sweep_args(&a, lane, geom, fs_active, n, h, nn, nlayer,
                                frozen, noflux, exp_trans, max_sweeps, dt,
                                two_dt, four_dt, work, group) ||
      a.fb == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  a.t_out = t_out;
  a.fb_out = fb_out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = a.votes.divisor;
  const bool g = a.votes.words != nullptr;
  if (nn == 5)
    return vicnode::launch_cooperative(
        g ? node_sweep_kernel<5, true> : node_sweep_kernel<5, false>, n,
        vicnode::lanes_of(5), blocks, d, s, a, surf_temp, ctl, sweeps);
  return vicnode::launch_cooperative(
      g ? node_sweep_kernel<0, true> : node_sweep_kernel<0, false>, n,
      vicnode::lanes_of(0), blocks, d, s, a, surf_temp, ctl, sweeps);
}

}  // extern "C"
