// The frozen-soil Gauss-Seidel node sweep of one lane, and the batch-wide
// profile solve built from it, run inside one cooperative launch (K6 alone,
// node_sweep.cu; K6 inside K7, fd_surface_brent.cu).
//
// A line-for-line copy of vic_tpu_torch/physics/frozen_soil
// .solve_t_profile_explicit_plain for ONE lane (frozen_soil.c:305-494 with
// the reference's layer-array ice quirk): the finite-difference coefficients
// on linear or, with exp_trans, EXP_TRANS node spacing, one sweep over nodes
// 1..nn-2 in ascending order (closed-form root of the quirk's linear
// residual for nodes < nlayer, the first bracketing pair of six and 16
// bisection steps below, both only for frozen nodes where frozen soil is
// active), the no-flux bottom node, the post-sweep cold-nose fix and the
// revert of an unconverged lane.
//
// Whether another sweep runs is decided over the WHOLE batch, as the plain
// loop decides it: another sweep runs while any lane moved more than 1e-2 C
// in the last one (a NaN anywhere stops it), up to max_sweeps. So
// solve_profile sweeps every lane once (each block its tiles of kBlock
// lanes, one thread per lane), folds each block's largest change into the
// sweep's slot with an atomicMax on the float's bits (changes are >= 0, so
// the int order is the float order; NaN goes to a flag of its own),
// synchronises the grid and reads the slot: every thread takes the same
// decision, and nothing returns to the host between sweeps. Where the batch
// is one share of a block split across launches (a share group,
// share_votes.cuh), the slot's decision is first combined with the other
// shares' (share_max), so every share sweeps as often as the whole block
// would on one device: in the kernels' group instances (G), so those
// without a group compile as they did before share groups.
//
// Layout: the lane's coefficients A-D, its old temperatures, ice and
// moisture are formed once per call (lane_coefficients) into scratch laid
// out node-major, [coefficient][node][lane], as are the iterate and the
// fallback counts, so a warp's loads of one node are neighbouring
// addresses. A sweep walks the nodes with the iterate's neighbours in
// registers (node j-1 as updated, node j+1 as the last sweep left it) and
// loads each node's coefficients once; the unfrozen-water curve's
// parameter-only terms are formed once per frozen node and sweep, not once
// per residual evaluation. The cell's geometry (E, the solver's
// unfrozen-water parameters) stays per cell. The node loop is unrolled for
// the exact 5-node instance (NN = 5, the frozen and heavy configurations'
// count) and rolled for any other nn (NN = 0).
//
// Cost: a frozen node below the soil layers takes up to 28 residual
// evaluations, each a serial chain with a powf and a division, and at a
// given node a minority of the lanes are frozen while most warps hold one;
// so a tile's frozen nodes are queued and dealt out to the block's first
// threads (sweep_tile), which keeps those warps full.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "physics.cuh"
#include "share_votes.cuh"

namespace vicnode {

using namespace vicphys;
namespace cg = cooperative_groups;

constexpr float kSoilDt = 0.25f;     // SOIL_DT, node bracket half-width (C)
constexpr float kSweepTol = 1e-2f;   // sweep convergence (frozen_soil.c:466)
constexpr int kBisectIters = 16;
constexpr int kPairs = 6;
constexpr int kBlock = 128;          // threads a block of K6 and K7
constexpr int kWarps = kBlock / 32;
// Blocks of K6 and K7 resident on an SM at once (so at most 64 registers a
// thread): the sweeps' frozen nodes run serial chains of residual
// evaluations on the few warps a tile's queue fills, and the SM needs many
// blocks to hide their latency; K7's residual spills instead.
constexpr int kMinBlocks = 8;
// Lanes a thread holds in a sweep of the instance that runs nn nodes (NN,
// 0 for the rolled one): a block sweeps tiles of kBlock * lanes_of(NN)
// lanes, so its queue of frozen nodes fills that many times the warps. The
// rolled instance takes kRolledLanes; the exact 5-node instance one, as its
// single deep node queues little and the K14 probes' 65,536 lanes would
// fill too few blocks.
constexpr int kRolledLanes = 2;
__host__ __device__ constexpr int lanes_of(int nn) {
  return nn == 5 ? 1 : kRolledLanes;
}
constexpr int kMaxTile = kBlock * (kRolledLanes > 1 ? kRolledLanes : 1);
// the C interface's refusals (kernels._check_coop names them)
constexpr int kNoCooperativeLaunch = -1;
constexpr int kGridNotCoResident = -2;

// the lane's per-node scratch rows, [kNumCoef][nn][n]
enum Coef { kA, kB, kC, kD, kT0, kIce0, kMoist, kNumCoef };
// the scratch arrays, in the order of the wrapper's work pointers
enum Work { kWorkCoef, kWorkBLast, kWorkT, kWorkFb, kWorkLastDiff,
            kNumWork };

struct SweepArgs {
  // [n, nn] per lane: old temperatures and the step's node properties
  const float* t0;
  const float* kappa;
  const float* cs;
  const float* moist;
  const float* ice0;
  // [n_cell, nn] geometry, lane -> cell = lane / h
  const float* alpha;
  const float* beta;
  const float* gamma;
  const float* e_coef;
  const float* solver_max_moist;
  const float* solver_bubble;
  const float* solver_expt;
  // EXP_TRANS: Zsum + 1 ([n_cell, nn]), 4*bexp^2 and bexp ([n_cell])
  const float* zp1;
  const float* exp_a;
  const float* bexp;
  const uint8_t* fs_active;    // [n_cell]
  int n, h, nn, nlayer, frozen, noflux, exp_trans, max_sweeps;
  // dt_sec and the floats of 2.0 * dt_sec and 4.0 * dt_sec
  float dt, two_dt, four_dt;
  // scratch, node-major
  float* coef;                 // [kNumCoef][nn][n]
  float* b_last;               // [n] no-flux coefficient of the bottom node
  float* t;                    // [nn][n] the iterate (row 0 unused)
  int32_t* fb;                 // [nn][n] fallback counts; null inside K7
  float* lastdiff;             // [n] the last sweep's largest change
  // K6's outputs, [n, nn] (null inside K7)
  float* t_out;
  int32_t* fb_out;
  // the share group this batch is a share of (words null: none)
  vicvote::ShareVotes votes;
};

// Fills `a` from the wrapper's arrays (kernels._sweep_inputs): lane
// inputs t0, kappa, cs, moist, ice0; geometry alpha, beta, gamma, e_coef,
// solver_max_moist, solver_bubble, solver_expt, zp1, exp_a, bexp; the
// scratch of enum Work; the share group's table (null: none). False on
// arguments out of range.
inline bool fill_sweep_args(SweepArgs* a, const void* const* lane,
                            const void* const* geom,
                            const uint8_t* fs_active, int n, int h, int nn,
                            int nlayer, int frozen, int noflux,
                            int exp_trans, int max_sweeps, float dt,
                            float two_dt, float four_dt,
                            const void* const* work, const int64_t* group) {
  if (n <= 0 || h <= 0 || max_sweeps < 0 || nn < 3 || nn > 50) return false;
  if (!vicvote::fill_share_votes(&a->votes, group)) return false;
  const float* const* l = reinterpret_cast<const float* const*>(lane);
  const float* const* g = reinterpret_cast<const float* const*>(geom);
  a->t0 = l[0];
  a->kappa = l[1];
  a->cs = l[2];
  a->moist = l[3];
  a->ice0 = l[4];
  a->alpha = g[0];
  a->beta = g[1];
  a->gamma = g[2];
  a->e_coef = g[3];
  a->solver_max_moist = g[4];
  a->solver_bubble = g[5];
  a->solver_expt = g[6];
  a->zp1 = g[7];
  a->exp_a = g[8];
  a->bexp = g[9];
  a->fs_active = fs_active;
  a->n = n;
  a->h = h;
  a->nn = nn;
  a->nlayer = nlayer;
  a->frozen = frozen;
  a->noflux = noflux;
  a->exp_trans = exp_trans;
  a->max_sweeps = max_sweeps;
  a->dt = dt;
  a->two_dt = two_dt;
  a->four_dt = four_dt;
  a->coef = static_cast<float*>(const_cast<void*>(work[kWorkCoef]));
  a->b_last = static_cast<float*>(const_cast<void*>(work[kWorkBLast]));
  a->t = static_cast<float*>(const_cast<void*>(work[kWorkT]));
  a->fb = static_cast<int32_t*>(const_cast<void*>(work[kWorkFb]));
  a->lastdiff = static_cast<float*>(const_cast<void*>(work[kWorkLastDiff]));
  a->t_out = nullptr;
  a->fb_out = nullptr;
  return true;
}

__device__ __forceinline__ int64_t node_at(const SweepArgs& a, int j, int i) {
  return static_cast<int64_t>(j) * a.n + i;
}

__device__ __forceinline__ float& coef(const SweepArgs& a, int k, int j,
                                       int i) {
  return a.coef[(static_cast<int64_t>(k) * a.nn + j) * a.n + i];
}

// lane i's coefficients into the node-major scratch, in the plain version's
// operation order (B wraps at the ends like torch.roll)
__device__ __forceinline__ void lane_coefficients(const SweepArgs& a, int i) {
  const int nn = a.nn;
  const int64_t cell = i / a.h;
  const int64_t base = static_cast<int64_t>(i) * nn;
  for (int j = 0; j < nn; ++j) {
    const int64_t k = base + j;
    const int64_t g = cell * nn + j;
    const float kap = a.kappa[k];
    if (a.exp_trans) {
      // the coefficients on the exponential grid (frozen_soil.c:190-212)
      const float zp1 = a.zp1[g];
      coef(a, kA, j, i) = a.exp_a[cell] * a.cs[k] * zp1 * zp1;
      coef(a, kC, j, i) = a.four_dt * kap;
      coef(a, kD, j, i) = a.two_dt * kap * a.bexp[cell];
    } else {
      const float alpha = a.alpha[g];
      coef(a, kA, j, i) = a.cs[k] * alpha * alpha;
      coef(a, kC, j, i) = a.two_dt * kap * alpha / a.gamma[g];
      coef(a, kD, j, i) = a.two_dt * kap * alpha / a.beta[g];
    }
    coef(a, kB, j, i) =
        (a.kappa[base + (j + 1) % nn] - a.kappa[base + (j + nn - 1) % nn]) *
        a.dt;
    coef(a, kT0, j, i) = a.t0[k];
    coef(a, kIce0, j, i) = a.ice0[k];
    coef(a, kMoist, j, i) = a.moist[k];
    if (a.fb) a.fb[node_at(a, j, i)] = 0;
  }
  a.b_last[i] = (a.kappa[base + nn - 1] - a.kappa[base + nn - 2]) * a.dt;
}

// one node's coefficients
struct Node {
  float A, B, C, D, E, t0, ice0;
  bool exp_trans;

  // the C/D terms of the residual (soil_thermal_eqn.c)
  __device__ __forceinline__ float flux2(float t, float tl, float tu) const {
    if (exp_trans) return C * (tl - 2.0f * t + tu) - D * (tl - tu);
    return C * (tl - t) - D * (t - tu);
  }

  // the denominator of the closed-form update
  __device__ __forceinline__ float denom() const {
    return exp_trans ? A + 2.0f * C : A + C + D;
  }

  // the unfrozen closed-form update with the B coefficient b
  // (frozen_soil.c:390-392)
  __device__ __forceinline__ float closed_form(float tl, float tu,
                                               float b) const {
    if (exp_trans)
      return (A * t0 + b * (tl - tu) + C * (tl + tu) - D * (tl - tu) +
              E * (0.0f - ice0)) /
             denom();
    return (A * t0 + b * (tl - tu) + C * tl + D * tu + E * (0.0f - ice0)) /
           denom();
  }
};

__device__ __forceinline__ Node load_node(const SweepArgs& a, int j, int i,
                                          int64_t cell) {
  return Node{coef(a, kA, j, i),    coef(a, kB, j, i),
              coef(a, kC, j, i),    coef(a, kD, j, i),
              a.e_coef[cell * a.nn + j], coef(a, kT0, j, i),
              coef(a, kIce0, j, i), a.exp_trans != 0};
}

// a node's unfrozen-water terms: moisture, the solver's maximum and
// maximum_unfrozen_water's 9.81*bubble/100 and -2/(expt-3), formed as
// physics.cuh's max_unfrozen forms them
struct Ice {
  float moist, mmax, bubble_term, power;
};

__device__ __forceinline__ Ice load_ice(const SweepArgs& a, int j, int i,
                                        int64_t cell) {
  const int64_t g = cell * a.nn + j;
  return Ice{coef(a, kMoist, j, i), a.solver_max_moist[g],
             div_s(9.81f * a.solver_bubble[g], 100.0f),
             -rdiv_s(2.0f, a.solver_expt[g] - 3.0f)};
}

// SoilThermalEqn at node j (soil_thermal_eqn.c) with the node-1 cold-nose
// patch (:58-70); tl, tu: the current iterate at j+1 and j-1
__device__ __forceinline__ float node_residual(const Node& nd, const Ice& ic,
                                               bool fs, int j, float t,
                                               float tl, float tu) {
  float ice = 0.0f;
  if (t < 0.0f && fs) {
    const float iw = nan_max(
        ic.moist - unfrozen_from_terms(t, ic.mmax, ic.bubble_term, ic.power),
        0.0f);
    ice = nan_min(iw, ic.mmax);
  }
  const float f1 = nd.B * (tl - tu);
  const float f2 = nd.flux2(t, tl, tu);
  float val = -nd.A * (t - nd.t0) + f1 + f2 + nd.E * (ice - nd.ice0);
  if (j == 1 && fabsf(tl - tu) > 5.0f && t < tl && t < tu && f1 < 0.0f &&
      f2 > 0.0f && fabsf(f1) > fabsf(f2))
    val = val - f1;
  return val;
}

// The new temperature of a frozen node j of lane i (below 0 C where frozen
// soil is active), tl, tu: the iterate at j+1 and j-1, t_lin: the
// unfrozen closed form; adds the fallback to the scratch counts (FB).
template <bool FB>
__device__ float frozen_node(const SweepArgs& a, int j, int i, int64_t cell,
                             float tl, float tu, float t_lin) {
  const Node nd = load_node(a, j, i, cell);
  const Ice ic = load_ice(a, j, i, cell);
  auto f = [&](float t) { return node_residual(nd, ic, true, j, t, tl, tu); };
  bool bracketed;
  float t_root;
  if (j < a.nlayer) {
    // the quirk's residual is linear in t: its closed-form root, then the
    // bracket test over t0 +/- (SOIL_DT + 50)
    t_root = t_lin;
    if (j == 1) {
      const float f1 = nd.B * (tl - tu);
      const float r1 = t_lin - f1 / nd.denom();
      const float f2_r1 = nd.flux2(r1, tl, tu);
      if (fabsf(tl - tu) > 5.0f && r1 < tl && r1 < tu && f1 < 0.0f &&
          f2_r1 > 0.0f && fabsf(f1) > fabsf(f2_r1))
        t_root = r1;
    }
    const float wide = kSoilDt + 50.0f;
    const float f_lo = f(nd.t0 - wide);
    const float f_hi = f(nd.t0 + wide);
    bracketed = f_lo * f_hi < 0.0f;
  } else {
    // the first of six pairs t0 +/- (SOIL_DT + 10k) that brackets a sign
    // change, then 16 bisection steps
    float lo = nd.t0 - kSoilDt, hi = nd.t0 + kSoilDt;
    float flo = f(lo);
    bracketed = flo * f(hi) < 0.0f;
    for (int k = 1; k < kPairs && !bracketed; ++k) {
      const float delta = kSoilDt + 10.0f * k;
      const float lo_k = nd.t0 - delta, hi_k = nd.t0 + delta;
      const float flo_k = f(lo_k);
      if (flo_k * f(hi_k) < 0.0f) {
        lo = lo_k;
        hi = hi_k;
        flo = flo_k;
        bracketed = true;
      }
    }
    if (bracketed) {
      for (int it = 0; it < kBisectIters; ++it) {
        const float mid = 0.5f * (lo + hi);
        const float fm = f(mid);
        if (flo * fm <= 0.0f) {
          hi = mid;
        } else {
          lo = mid;
          flo = fm;
        }
      }
    }
    t_root = 0.5f * (lo + hi);
  }
  // TFALLBACK to the old temperature when unbracketed
  if (FB && !bracketed) a.fb[node_at(a, j, i)] += 1;
  return bracketed ? t_root : nd.t0;
}

// One Gauss-Seidel sweep in place of the block's tile of lanes from
// `base`: this thread's lanes base + k * blockDim.x + threadIdx.x, k <
// kLanes, with the node-0 boundaries x_of(lane); first: the iterate is the
// initial profile (the old temperatures). Node by node, every thread forms
// its lanes' unfrozen closed form; the lanes whose node is frozen are
// queued in shared memory and their root finding (up to ~28 residual
// evaluations) is dealt out to the block's threads in order, so the warps
// that run it are full rather than mostly idle. Each lane's arithmetic is
// the plain version's, whichever thread runs it. Adds the per-node
// fallbacks to the scratch counts (FB) and writes each lane's largest
// |change| (NaN if any change is NaN) to a.lastdiff. Every thread of the
// block calls it.
// the block's queue of frozen nodes and their neighbours, one per
// translation unit whatever the sweep's template arguments
struct SweepQueue {
  float tl[kMaxTile], tu[kMaxTile], t[kMaxTile];
  int slot[kMaxTile];
  int queued;
};

__device__ __forceinline__ SweepQueue& sweep_queue() {
  __shared__ SweepQueue q;
  return q;
}

template <int NN, bool FB, class X>
__device__ void sweep_tile(const SweepArgs& a, int base, X x_of,
                           bool first) {
  constexpr int kLanes = lanes_of(NN);
  SweepQueue& q = sweep_queue();
  const int nn = NN ? NN : a.nn;
  const int me = threadIdx.x, step = blockDim.x;
  auto t_at = [&](int j, int i) {
    return first ? coef(a, kT0, j, i) : a.t[node_at(a, j, i)];
  };
  // per lane of this thread: node j-1 as this sweep left it, node j before
  // its update, the largest change, frozen soil active
  float tu[kLanes], old_t[kLanes], maxdiff[kLanes];
  bool fs[kLanes];
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    const int i = base + k * step + me;
    const bool valid = i < a.n;
    tu[k] = valid ? x_of(i) : 0.0f;
    old_t[k] = valid ? t_at(1, i) : 0.0f;
    maxdiff[k] = 0.0f;
    fs[k] = valid && a.frozen != 0 && a.fs_active[i / a.h] != 0;
  }
#pragma unroll (NN ? NN : 1)
  for (int j = 1; j < nn - 1; ++j) {
    float tl[kLanes], t_lin[kLanes];
    bool frozen[kLanes];
    if (me == 0) q.queued = 0;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      const int i = base + k * step + me;
      tl[k] = t_lin[k] = 0.0f;
      frozen[k] = false;
      if (i >= a.n) continue;
      tl[k] = t_at(j + 1, i);
      const Node nd = load_node(a, j, i, i / a.h);
      t_lin[k] = nd.closed_form(tl[k], tu[k], nd.B);
      frozen[k] = old_t[k] < 0.0f && fs[k];
      if (frozen[k]) {
        const int slot = k * step + me;
        q.slot[atomicAdd(&q.queued, 1)] = slot;
        q.tl[slot] = tl[k];
        q.tu[slot] = tu[k];
        q.t[slot] = t_lin[k];
      }
    }
    __syncthreads();
    for (int w = me; w < q.queued; w += step) {
      const int slot = q.slot[w];
      const int lane = base + slot;
      q.t[slot] = frozen_node<FB>(a, j, lane, lane / a.h, q.tl[slot],
                                  q.tu[slot], q.t[slot]);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      const int i = base + k * step + me;
      if (i >= a.n) continue;
      const float t_new = frozen[k] ? q.t[k * step + me] : t_lin[k];
      a.t[node_at(a, j, i)] = t_new;
      maxdiff[k] = nan_max(maxdiff[k], fabsf(old_t[k] - t_new));
      tu[k] = t_new;
      old_t[k] = tl[k];
    }
  }
  const int j = nn - 1;
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    const int i = base + k * step + me;
    if (i >= a.n) continue;
    if (a.noflux) {
      // no-flux bottom: the node mirrors itself (B_last)
      const float t_lin = load_node(a, j, i, i / a.h)
                              .closed_form(old_t[k], tu[k], a.b_last[i]);
      a.t[node_at(a, j, i)] = t_lin;
      maxdiff[k] = nan_max(maxdiff[k], fabsf(old_t[k] - t_lin));
    } else if (first) {
      a.t[node_at(a, j, i)] = old_t[k];   // later sweeps read the iterate
    }
    a.lastdiff[i] = maxdiff[k];
  }
}

// nodes 1 and 2 of a lane's final profile
struct Top {
  float t1, t2;
};

// After the last of `sweeps` sweeps (the initial profile if none ran):
// the runaway-cold-nose fix (frozen_soil.c:470-484, the reference's old/new
// mix, ascending j with the already-fixed T[j-1]) and the whole-profile
// revert of a lane whose last sweep moved more than the tolerance
// (:486-494). OUT (K6): writes every node's temperature and fallback count
// to t_out/fb_out; else (K7) the fix runs only as far as nodes 1 and 2 need.
template <int NN, bool OUT>
__device__ Top finish_lane(const SweepArgs& a, int i, float x, int sweeps) {
  const int nn = NN ? NN : a.nn;
  const bool revert = (sweeps ? a.lastdiff[i] : 1.0f) > kSweepTol;
  auto t_at = [&](int j) {
    return j == 0 ? x
                  : (sweeps ? a.t[node_at(a, j, i)] : coef(a, kT0, j, i));
  };
  auto tlast_at = [&](int j) { return j == 0 ? x : coef(a, kT0, j, i); };
  const int64_t out = static_cast<int64_t>(i) * nn;
  Top top{0.0f, 0.0f};
  auto emit = [&](int j, float t, float tlast, int fix) {
    const float v = revert ? tlast : t;
    if (j == 1) top.t1 = v;
    if (j == 2) top.t2 = v;
    if (OUT) {
      a.t_out[out + j] = v;
      a.fb_out[out + j] = (sweeps && j > 0 ? a.fb[node_at(a, j, i)] : 0) +
                          fix + (revert ? 1 : 0);
    }
  };
  const int last = OUT ? nn - 2 : (nn - 2 < 2 ? nn - 2 : 2);
  if (OUT) emit(0, x, x, 0);
  float t_prev = x, tl_prev = x;
  float t_cur = t_at(1), tl_cur = tlast_at(1);
#pragma unroll (NN ? NN : 1)
  for (int j = 1; j <= last; ++j) {
    const float t_next = t_at(j + 1), tl_next = tlast_at(j + 1);
    const bool nose = tl_prev - tl_cur > 0.0f && tl_next - t_cur > 0.0f &&
                      (t_prev - t_cur) - (tl_prev - tl_cur) > 0.0f &&
                      (t_next - t_cur) - (tl_next - tl_cur) > 0.0f;
    if (nose) t_cur = 0.5f * (t_prev + t_next);
    emit(j, t_cur, tl_cur, nose ? 1 : 0);
    t_prev = t_cur;
    tl_prev = tl_cur;
    t_cur = t_next;
    tl_cur = tl_next;
  }
  // node last + 1 (the bottom node, or node 2 of a 3-node K7 lane) as the
  // sweeps left it, and in K6 the rest
  emit(last + 1, t_cur, tl_cur, 0);
  if (OUT)
    for (int j = last + 2; j < nn; ++j) emit(j, t_at(j), tlast_at(j), 0);
  return top;
}

// one warp-aggregated atomicOr of `cond` into *flag
__device__ __forceinline__ void vote(bool cond, int32_t* flag) {
  if (__any_sync(0xffffffffu, cond) && (threadIdx.x % 32) == 0)
    atomicOr(flag, 1);
}

// the block's largest change (NaN apart) into *slot_max by an atomicMax on
// its bits, a NaN anywhere into *slot_nan
__device__ __forceinline__ void fold_block(float v, bool nan,
                                           int32_t* slot_max,
                                           int32_t* slot_nan) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, off));
  const int any_nan = __any_sync(0xffffffffu, nan);
  __shared__ float warp_max[kWarps];
  __shared__ int warp_nan[kWarps];
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    warp_max[warp] = v;
    warp_nan[warp] = any_nan;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = 0.0f;
    int bad = 0;
    for (int w = 0; w < kWarps; ++w) {
      m = fmaxf(m, warp_max[w]);
      bad |= warp_nan[w];
    }
    atomicMax(slot_max, __float_as_int(m));
    if (bad) atomicExch(slot_nan, 1);
  }
}

// The decision of a vote folded into *slot_max / *slot_nan (fold_block)
// taken over every share of the group: thread 0 of block 0 exchanges it
// with the other shares' and writes back the largest change (NaN if any
// share's is), then the grid syncs. Call after the vote's grid sync, on
// every thread, in a group instance.
__device__ __forceinline__ void share_max(const vicvote::ShareVotes& v,
                                          int32_t* slot_max,
                                          int32_t* slot_nan,
                                          cg::grid_group& grid) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const uint32_t mine = __ldcg(slot_nan)
                              ? vicvote::kNanPayload
                              : static_cast<uint32_t>(__ldcg(slot_max));
    const uint32_t all = vicvote::exchange(
        v, mine, vicvote::max_nan, vicvote::kNanPayload);
    if (all == vicvote::kNanPayload)
      *slot_nan = 1;
    else
      *slot_max = static_cast<int32_t>(all);
  }
  grid.sync();
}

// The vote *flag (vote) taken over every share of the group: true where
// any share's is; as share_max.
__device__ __forceinline__ void share_any(const vicvote::ShareVotes& v,
                                          int32_t* flag,
                                          cg::grid_group& grid) {
  if (blockIdx.x == 0 && threadIdx.x == 0)
    *flag = static_cast<int32_t>(vicvote::exchange(
        v, __ldcg(flag) != 0 ? 1u : 0u, vicvote::any_of, 0u));
  grid.sync();
}

// Every stage of an instance walks the lanes in one order: block b takes
// the tiles of L * blockDim.x lanes (L = lanes_of(NN)) from the b-th in
// steps of the grid's, and thread t of a block lanes t, t + blockDim.x, ...
// of each; so a lane's scratch is
// only ever touched by one thread and needs no synchronisation between
// stages. f(lane) for each lane of this thread.
template <int L>
__device__ __forceinline__ int tile() { return blockDim.x * L; }

template <int L, class F>
__device__ __forceinline__ void for_each_lane(int n, F f) {
  for (int base = blockIdx.x * tile<L>(); base < n;
       base += gridDim.x * tile<L>())
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const int i = base + k * blockDim.x + threadIdx.x;
      if (i < n) f(i);
    }
}

// this thread's rank in the grid, and the grid's thread count
__device__ __forceinline__ int thread_rank() {
  return blockIdx.x * blockDim.x + threadIdx.x;
}
__device__ __forceinline__ int thread_count() {
  return gridDim.x * blockDim.x;
}

// The profile of every lane at the node-0 boundary x_of(lane): sweeps of
// the whole batch, each followed by a grid sync and the batch-wide decision
// read from its zeroed slot pair of ctl ([max_sweeps][2]: max bits, NaN),
// taken over the share group's batch in a group instance (G). Returns the
// sweep count, the same on every thread (and every share).
template <int NN, bool FB, bool G, class X>
__device__ int solve_profile(const SweepArgs& a, X x_of, int32_t* ctl,
                             cg::grid_group& grid) {
  int k = 0;
  while (k < a.max_sweeps) {
    for (int base = blockIdx.x * tile<lanes_of(NN)>(); base < a.n;
         base += gridDim.x * tile<lanes_of(NN)>())
      sweep_tile<NN, FB>(a, base, x_of, k == 0);
    float vmax = 0.0f;
    bool vnan = false;
    for_each_lane<lanes_of(NN)>(a.n, [&](int i) {
      const float d = a.lastdiff[i];
      if (d != d)
        vnan = true;
      else
        vmax = fmaxf(vmax, d);
    });
    fold_block(vmax, vnan, &ctl[2 * k], &ctl[2 * k + 1]);
    grid.sync();
    if constexpr (G) share_max(a.votes, &ctl[2 * k], &ctl[2 * k + 1], grid);
    const bool more = __ldcg(&ctl[2 * k + 1]) == 0 &&
                      __int_as_float(__ldcg(&ctl[2 * k])) > kSweepTol;
    ++k;
    if (!more) break;
  }
  return k;
}

// The blocks of `kernel` co-resident on the current device (0 where it has
// no cooperative launch), or a negative CUDA error; remembered per kernel
// and device, as the queries cost host time on every call. The shares of a
// split block launch from host threads of their own, hence the lock.
inline int co_resident_blocks(const void* kernel) {
  struct Entry {
    const void* kernel;
    int dev, blocks;
  };
  static Entry cache[32];
  static int used = 0;
  static std::mutex lock;
  const std::lock_guard<std::mutex> held(lock);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  for (int k = 0; k < used; ++k)
    if (cache[k].kernel == kernel && cache[k].dev == dev)
      return cache[k].blocks;
  int coop = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kBlock, 0);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int blocks = coop ? per_sm * sms : 0;
  if (used < 32) cache[used++] = Entry{kernel, dev, blocks};
  return blocks;
}

template <class T>
struct Same {
  using type = T;
};

// Launches `kernel` cooperatively on kBlock-thread blocks: `blocks` of them,
// or (blocks <= 0) as many as are co-resident on the device divided by
// `divisor` (the shares of a group on this device, whose grids must be
// resident together), at most one per tile of kBlock * lanes of the n
// lanes. Returns kNoCooperativeLaunch or kGridNotCoResident without
// launching where the device cannot run the grid, else the launch's error.
// The arguments take the kernel's parameter types.
template <class... P>
int launch_cooperative(void (*kernel)(P...), int n, int lanes, int blocks,
                       int divisor, cudaStream_t stream,
                       typename Same<P>::type... args) {
  const int co_resident =
      co_resident_blocks(reinterpret_cast<const void*>(kernel));
  if (co_resident < 0) return -co_resident;
  if (co_resident == 0) return kNoCooperativeLaunch;
  const int needed = (n + kBlock * lanes - 1) / (kBlock * lanes);
  const int share = co_resident / divisor;
  if (blocks <= 0) blocks = share < needed ? share : needed;
  if (blocks < 1 || blocks > co_resident) return kGridNotCoResident;
  void* params[] = {static_cast<void*>(&args)...};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(blocks), dim3(kBlock),
      params, 0, stream));
}

}  // namespace vicnode
