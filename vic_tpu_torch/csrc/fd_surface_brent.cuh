// K7's kernel, shared by the sources that instantiate it: the entry
// (fd_surface_brent.cu, with the <3, false, false> instances) and one source
// per other (layers, DIST_PRCP, share group) triple, so nvcc builds the
// sixteen instances eight at a time. See fd_surface_brent.cu for what the
// kernel does.
#pragma once

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#include "lanes.cuh"
#include "node_sweep.cuh"
#include "surface_brent.cuh"

namespace vicfd {

using vicnode::for_each_lane;
using vicnode::kBlock;
using vicnode::SweepArgs;

constexpr float kTstep = 10.0f;          // bracket expansion step
constexpr float kTol = 1e-4f;            // the float32 Brent tol addend
constexpr float kEps2 = 2.0f * FLT_EPSILON;

// float rows of the Brent state, [kNumRows][n]
enum Row { kA, kB, kC, kFa, kFb, kFc, kD, kE, kDNew, kENew, kBNext,
           kNumRows };
// uint8 rows, [kNumFlagRows][n]
enum FlagRow { kNeed, kDone, kBracketed, kNumFlagRows };

struct State {
  float* s;      // [kNumRows][n]
  uint8_t* u;    // [kNumFlagRows][n]
  int n;
  __device__ float& operator()(int r, int i) const {
    return s[static_cast<int64_t>(r) * n + i];
  }
  __device__ uint8_t& flag(int r, int i) const {
    return u[static_cast<int64_t>(r) * n + i];
  }
};

struct BrentArgs {
  State st;
  const float* lo;
  const float* hi;
  float* root;
  uint8_t* converged;
  uint8_t* bracketed;
  // [max_solves][max_sweeps][2] sweep slots, then [max_tries + max_iter + 1]
  // votes; zeroed by the kernel
  int32_t* ctl;
  int n_ctl;
  int32_t* trips;    // the Brent loop's trip count
  int32_t* solves;   // profile solves (residual evaluations of every lane)
  int32_t* sweeps;   // sweeps over all the profile solves
  // int64 running totals the three counts are added to (atomically: shares
  // of a card launch on streams of their own)
  unsigned long long* totals;
  float dt;
  int gft, frozen, max_iter, max_tries;
};

// the residual at x from nodes 1-2 of the profile solved at x
template <int NL, bool DIST>
__device__ __forceinline__ float residual(const LaneInputs& in, int i,
                                          const BrentArgs& b, float x,
                                          vicnode::Top p) {
  vicsurf::SurfaceResidual<NL, DIST> r;
  const LaneRow row = lane_row(in, i);
  r.init(in, row, b.dt, b.gft);
  r.init_fd(in, row, b.frozen != 0);
  return r.fd(x, p.t1, p.t2);
}

// expand_brackets' round on lane i: need = f_lo*f_hi >= 0 on active lanes,
// widened by TSTEP on both sides (ops/rootfind.py:40-44)
__device__ __forceinline__ bool expand_lane(const LaneInputs& in,
                                            const State& st, int i) {
  const bool need = st(kFa, i) * st(kFb, i) >= 0.0f &&
                    lane_m(in, vicsurf::kActive, lane_row(in, i));
  st.flag(kNeed, i) = need;
  if (need) {
    st(kA, i) = st(kA, i) - kTstep;
    st(kB, i) = st(kB, i) + kTstep;
  }
  return need;
}

// after the expansion: the Brent loop's start (ops/rootfind.py:47-68);
// whether the lane is live
__device__ __forceinline__ bool init_lane(const LaneInputs& in,
                                          const State& st, int i) {
  const bool bracketed = st(kFa, i) * st(kFb, i) < 0.0f &&
                         lane_m(in, vicsurf::kActive, lane_row(in, i));
  st.flag(kBracketed, i) = bracketed;
  st.flag(kDone, i) = !bracketed;
  st(kC, i) = st(kA, i);
  st(kFc, i) = st(kFa, i);
  st(kD, i) = st(kB, i) - st(kA, i);
  st(kE, i) = st(kB, i) - st(kA, i);
  return bracketed;
}

// one iteration of batched_brent up to b_next (ops/rootfind.py:73-113), on
// every lane: done lanes are rearranged and propose a candidate too;
// whether the lane is not done
__device__ __forceinline__ bool propose_lane(const State& st, int i) {
  float a = st(kA, i), b = st(kB, i), c = st(kC, i);
  float fa = st(kFa, i), fb = st(kFb, i), fc = st(kFc, i);
  float d = st(kD, i), e = st(kE, i);
  if (fb * fc > 0.0f) {
    c = a;
    fc = fa;
    d = b - a;
    e = d;
  }
  if (fabsf(fc) < fabsf(fb)) {
    const float ob = b, ofb = fb;
    a = ob;
    b = c;
    c = ob;
    fa = ofb;
    fb = fc;
    fc = ofb;
  }
  const float tol_i = kEps2 * fabsf(b) + kTol;
  const float m = 0.5f * (c - b);
  const bool done = st.flag(kDone, i) || fabsf(m) <= tol_i || fb == 0.0f;
  const bool use_bisect = fabsf(e) < tol_i || fabsf(fa) <= fabsf(fb);
  const float s = fb / (fa == 0.0f ? 1.0f : fa);
  float p, q;
  if (a == c) {
    p = 2.0f * m * s;
    q = 1.0f - s;
  } else {
    const float fcs = fc == 0.0f ? 1.0f : fc;
    const float qq = fa / fcs;
    const float r = fb / fcs;
    p = s * (2.0f * m * qq * (qq - r) - (b - a) * (r - 1.0f));
    q = (qq - 1.0f) * (r - 1.0f) * (s - 1.0f);
  }
  if (p > 0.0f) q = -q;
  p = fabsf(p);
  const bool take = !use_bisect &&
                    (2.0f * p < 3.0f * m * q - fabsf(tol_i * q)) &&
                    (p < fabsf(0.5f * e * q));
  const float e_new = take ? d : m;
  const float d_new = take ? p / (q == 0.0f ? 1.0f : q) : m;
  const float step =
      fabsf(d_new) > tol_i ? d_new : (m > 0.0f ? tol_i : -tol_i);
  st(kA, i) = a;
  st(kB, i) = b;
  st(kC, i) = c;
  st(kFa, i) = fa;
  st(kFb, i) = fb;
  st(kFc, i) = fc;
  st(kD, i) = d;
  st(kE, i) = e;
  st(kDNew, i) = d_new;
  st(kENew, i) = e_new;
  st(kBNext, i) = b + step;
  st.flag(kDone, i) = done;
  return !done;
}

// converged where |c - b|/2 <= tol or f(b) == 0; unbracketed or inactive
// lanes return the midpoint of the ORIGINAL bracket (ops/rootfind.py:126-128)
__device__ __forceinline__ void finish_brent(const BrentArgs& b, int i) {
  const State& st = b.st;
  const float x = st(kB, i);
  const bool br = st.flag(kBracketed, i);
  const float tol_f = kEps2 * fabsf(x) + kTol;
  b.converged[i] =
      br && (fabsf(0.5f * (st(kC, i) - x)) <= tol_f || st(kFb, i) == 0.0f);
  b.bracketed[i] = br;
  b.root[i] = br ? x : 0.5f * (b.lo[i] + b.hi[i]);
}

template <int NL, bool DIST, int NN, bool G>
__global__ void __launch_bounds__(kBlock, vicnode::kMinBlocks)
    fd_brent_kernel(const __grid_constant__ LaneInputs in,
                    const __grid_constant__ SweepArgs sa,
                    const __grid_constant__ BrentArgs b) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  constexpr int kLanes = vicnode::lanes_of(NN);
  const State& st = b.st;
  int32_t* votes = b.ctl + b.n_ctl - (b.max_tries + b.max_iter + 1);
  // the coefficients of the node solve, the bracket, zeroed control
  for_each_lane<kLanes>(st.n, [&](int i) {
    vicnode::lane_coefficients(sa, i);
    st(kA, i) = b.lo[i];
    st(kB, i) = b.hi[i];
    st.flag(kNeed, i) = 0;
  });
  for (int s = vicnode::thread_rank(); s < b.n_ctl;
       s += vicnode::thread_count())
    b.ctl[s] = 0;
  grid.sync();
  int solves = 0, sweeps = 0;

  // the profile of every lane at its candidate in row x_row, then for each
  // lane that `use` accepts the residual there, handed to `take`
  auto evaluate = [&](int x_row, auto use, auto take) {
    const int k = vicnode::solve_profile<NN, false, G>(
        sa, [&](int i) { return st(x_row, i); },
        b.ctl + 2 * solves * sa.max_sweeps, grid);
    ++solves;
    sweeps += k;
    for_each_lane<kLanes>(st.n, [&](int i) {
      if (!use(i)) return;
      const float x = st(x_row, i);
      take(i, residual<NL, DIST>(in, i, b, x,
                                 vicnode::finish_lane<NN, false>(sa, i, x,
                                                                 k)));
    });
  };
  auto every = [](int) { return true; };
  auto needing = [&](int i) { return st.flag(kNeed, i) != 0; };
  auto to_fa = [&](int i, float f) { st(kFa, i) = f; };
  auto to_fb = [&](int i, float f) { st(kFb, i) = f; };

  // bracket expansion (ops/rootfind.expand_brackets)
  evaluate(kA, every, to_fa);
  evaluate(kB, every, to_fb);
  for (int t = 0; t < b.max_tries; ++t) {
    bool need = false;
    for_each_lane<kLanes>(st.n,
                          [&](int i) { need |= expand_lane(in, st, i); });
    vicnode::vote(need, &votes[t]);
    grid.sync();
    if constexpr (G) vicnode::share_any(sa.votes, &votes[t], grid);
    if (!__ldcg(&votes[t])) break;
    evaluate(kA, needing, to_fa);
    evaluate(kB, needing, to_fb);
  }
  // Brent (ops/rootfind.batched_brent), one vote per iteration: is any
  // lane not done
  bool live = false;
  for_each_lane<kLanes>(st.n, [&](int i) { live |= init_lane(in, st, i); });
  vicnode::vote(live, &votes[b.max_tries]);
  grid.sync();
  if constexpr (G) vicnode::share_any(sa.votes, &votes[b.max_tries], grid);
  int it = 0;
  while (it < b.max_iter && __ldcg(&votes[b.max_tries + it])) {
    live = false;
    for_each_lane<kLanes>(st.n,
                          [&](int i) { live |= propose_lane(st, i); });
    vicnode::vote(live, &votes[b.max_tries + 1 + it]);
    // f(b_next) and the update of the lanes that are neither done nor
    // unbracketed (ops/rootfind.py:114-123)
    evaluate(
        kBNext,
        [&](int i) {
          return !st.flag(kDone, i) && st.flag(kBracketed, i);
        },
        [&](int i, float f) {
          st(kA, i) = st(kB, i);
          st(kFa, i) = st(kFb, i);
          st(kB, i) = st(kBNext, i);
          st(kFb, i) = f;
          st(kD, i) = st(kDNew, i);
          st(kE, i) = st(kENew, i);
        });
    ++it;
    grid.sync();
    if constexpr (G)
      if (it < b.max_iter)
        vicnode::share_any(sa.votes, &votes[b.max_tries + it], grid);
  }
  for_each_lane<kLanes>(st.n, [&](int i) { finish_brent(b, i); });
  if (vicnode::thread_rank() == 0) {
    b.trips[0] = it;
    b.solves[0] = solves;
    b.sweeps[0] = sweeps;
    atomicAdd(&b.totals[0], static_cast<unsigned long long>(it));
    atomicAdd(&b.totals[1], static_cast<unsigned long long>(solves));
    atomicAdd(&b.totals[2], static_cast<unsigned long long>(sweeps));
  }
}

// the <NL, DIST, G> instances' launch: G with a share group
template <int NL, bool DIST, bool G>
int launch(const LaneInputs& in, const SweepArgs& sa, const BrentArgs& b,
           int blocks, cudaStream_t s) {
  if (sa.nn == 5)
    return vicnode::launch_cooperative(fd_brent_kernel<NL, DIST, 5, G>,
                                       b.st.n, vicnode::lanes_of(5), blocks,
                                       sa.votes.divisor, s, in, sa, b);
  return vicnode::launch_cooperative(fd_brent_kernel<NL, DIST, 0, G>, b.st.n,
                                     vicnode::lanes_of(0), blocks,
                                     sa.votes.divisor, s, in, sa, b);
}

}  // namespace vicfd
