// K7 fd_surface_brent: the soil-surface temperature of the finite-difference
// (frozen-soil) step, for sm_90a (H100).
//
// Replaces vic_tpu/physics/surface.py:438 (solve_surface_temperature's
// batched_brent, vic_tpu/ops/rootfind.py:89-207) on the residual :71-378 in
// its finite-difference form: every candidate Ts is the node-0 boundary of a
// Gauss-Seidel solve of the node profile (K6's sweep, node_sweep.cuh), and
// the ground heat comes from nodes 1 and 2 with the fusion of the top node
// pair.
//
// Why not one thread per lane, as K5: K6's sweep count is decided over the
// WHOLE batch (a sweep runs while any lane moved more than 1e-2 C), so every
// lane's profile depends on every other lane's candidate, those of lanes
// whose Brent is done included. The batch's Brent therefore advances in
// lock step, as the plain loop does. Here the whole solve is ONE cooperative
// launch: f(lo) and f(hi); up to max_tries expansion rounds; init; up to
// max_iter rounds of propose (the rearrange / secant / inverse-quadratic /
// bisection step on EVERY lane, done or not, exactly as the plain loop
// computes b_next), the profile at b_next, accept (the update masked on done
// and unbracketed lanes); finish. Each profile solve is K6's sweeps with a
// grid sync after each; every decision the plain loop's host takes (does
// any lane still need widening, is any lane not done, does another sweep
// run) is a vote folded with atomics and read by every thread after a grid
// sync. No host read, no Python and no other launch comes between the
// stages. Lane state lives in global scratch between syncs: the Brent rows
// [row][lane], the sweep's coefficients and iterate [..][node][lane].
//
// With a share group (the lanes one share of a block split across
// launches, parallel/votes.py) the group instances (G) run: every one of
// those decisions is also taken over the other shares' lanes (node_sweep.cuh
// share_any, share_max), so each share's Brent trips, profile solves and
// sweeps are the whole block's; the grid is the co-resident blocks divided
// by the shares on this device. The instances without a group compile as
// they did before share groups.
//
// Bound: each sweep streams the lanes' node coefficients and iterate; each
// residual evaluation reads a lane's ~64 inputs (~300 B; with DIST_PRCP the
// dry column's ~80 B more) and does one ~150-flop residual (two ET
// evaluations with DIST_PRCP).
//
// C interface for ctypes: returns 0, a CUDA error, or kNoCooperativeLaunch /
// kGridNotCoResident (node_sweep.cuh).

#include <cuda_runtime.h>

#include <cstdint>

#include "fd_surface_brent.cuh"

// the other instances, each built from its own source
#define VICFD_EXTERN(NL, DIST, G)                                    \
  extern template int vicfd::launch<NL, DIST, G>(                    \
      const LaneInputs&, const vicfd::SweepArgs&, const vicfd::BrentArgs&, \
      int, cudaStream_t);
VICFD_EXTERN(2, false, false)
VICFD_EXTERN(2, true, false)
VICFD_EXTERN(3, true, false)
VICFD_EXTERN(3, false, true)
VICFD_EXTERN(2, false, true)
VICFD_EXTERN(2, true, true)
VICFD_EXTERN(3, true, true)
#undef VICFD_EXTERN

namespace {

using vicfd::BrentArgs;
using vicfd::launch;
using vicfd::State;
using vicfd::SweepArgs;

}  // namespace

extern "C" {

// Residual: nf, nm: the input counts, checked against the residual's; h:
// lanes per cell; nl: soil layers (2 or 3); dist: the dry column is read
// (DIST_PRCP); frozen: the fusion term. Node solve (K6's, node_sweep.cu):
// lane, geom, fs_active, nn, nlayer, sweep_frozen, noflux, exp_trans,
// max_sweeps, sweep_dt, two_dt, four_dt, work (no fallback counts). state:
// float [11][n]; lane_flags: uint8 [3][n]; ctl: int32 [n_ctl] = (2 +
// 2*max_tries + max_iter) * 2 * max_sweeps sweep slots and max_tries +
// max_iter + 1 votes; lo/hi/root/converged/bracketed: [n]; trips, solves,
// sweeps: int32 [1] each; blocks: the grid (0: the co-resident count);
// group: the share group's table (share_votes.cuh fill_share_votes; null:
// the lanes are the whole batch).
int fd_surface_brent(const int64_t* lanes, int nf, int nm,
                     int h, int nl, int dist, float dt, int grnd_flux_type,
                     int frozen, int max_iter, int max_tries,
                     const void* const* lane, const void* const* geom,
                     const uint8_t* fs_active, int nn, int nlayer,
                     int sweep_frozen, int noflux, int exp_trans,
                     int max_sweeps, float sweep_dt, float two_dt,
                     float four_dt, const void* const* work, float* state,
                     uint8_t* lane_flags, int32_t* ctl, int n_ctl, int n,
                     const float* lo, const float* hi, float* root,
                     uint8_t* converged, uint8_t* bracketed, int32_t* trips,
                     int32_t* solves, int32_t* sweeps, int blocks,
                     const int64_t* group, void* stream) {
  LaneInputs in{};
  SweepArgs sa{};
  if (n <= 0 || max_iter < 0 || max_tries < 0 ||
      n_ctl != (2 + 2 * max_tries + max_iter) * 2 * max_sweeps + max_tries +
                   max_iter + 1 ||
      !fill_lane_inputs(&in, lanes, nf,
                        vicsurf::kNumSurfaceIn + vicsurf::kNumFdIn, nm,
                        vicsurf::kNumSurfaceMask + 1, h) ||
      !vicnode::fill_sweep_args(&sa, lane, geom, fs_active, n, h, nn, nlayer,
                                sweep_frozen, noflux, exp_trans, max_sweeps,
                                sweep_dt, two_dt, four_dt, work, group))
    return static_cast<int>(cudaErrorInvalidValue);
  sa.fb = nullptr;
  BrentArgs b{};
  b.st = State{state, lane_flags, n};
  b.lo = lo;
  b.hi = hi;
  b.root = root;
  b.converged = converged;
  b.bracketed = bracketed;
  b.ctl = ctl;
  b.n_ctl = n_ctl;
  b.trips = trips;
  b.solves = solves;
  b.sweeps = sweeps;
  b.dt = dt;
  b.gft = grnd_flux_type;
  b.frozen = frozen;
  b.max_iter = max_iter;
  b.max_tries = max_tries;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool g = sa.votes.words != nullptr;
  if (nl == 2 && dist)
    return g ? launch<2, true, true>(in, sa, b, blocks, s)
             : launch<2, true, false>(in, sa, b, blocks, s);
  if (nl == 2)
    return g ? launch<2, false, true>(in, sa, b, blocks, s)
             : launch<2, false, false>(in, sa, b, blocks, s);
  if (nl == 3 && dist)
    return g ? launch<3, true, true>(in, sa, b, blocks, s)
             : launch<3, true, false>(in, sa, b, blocks, s);
  if (nl == 3)
    return g ? launch<3, false, true>(in, sa, b, blocks, s)
             : launch<3, false, false>(in, sa, b, blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
