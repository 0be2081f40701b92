// One lane of the frozen-soil Gauss-Seidel node sweep.
//
// A line-for-line copy of vic_tpu_torch/physics/frozen_soil
// .solve_t_profile_explicit_plain for ONE lane (frozen_soil.c:305-494 with
// the reference's layer-array ice quirk): the finite-difference coefficients
// on linear or, with exp_trans, EXP_TRANS node spacing,
// one sweep over nodes 1..nn-2 in ascending order (closed-form root of the
// quirk's linear residual for nodes < nlayer, the first bracketing pair of
// six and 16 bisection steps below, both only for frozen nodes where frozen
// soil is active), the no-flux bottom node, the post-sweep cold-nose fix and
// the revert of an unconverged lane. Whether another sweep runs is decided
// over the whole batch (node_sweep.cu), as the plain loop decides it.
//
// A lane holds up to CAP nodes. EXACT instances run exactly CAP nodes with
// every node loop unrolled, so the lane's arrays live in registers (the
// 5-node instance of the frozen and heavy configurations); the others run
// the launch's node count nn <= CAP with the loops rolled, the arrays in
// local memory.
#pragma once

#include <cstdint>

#include "physics.cuh"

namespace vicnode {

using namespace vicphys;

constexpr float kSoilDt = 0.25f;     // SOIL_DT, node bracket half-width (C)
constexpr float kSweepTol = 1e-2f;   // sweep convergence (frozen_soil.c:466)
constexpr int kBisectIters = 16;
constexpr int kPairs = 6;

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
  const float* surf_temp;      // [n] node-0 boundary condition
  const uint8_t* fs_active;    // [n_cell]
  int n, h, nn, nlayer, frozen, noflux, exp_trans, max_sweeps;
  // dt_sec and the floats of 2.0 * dt_sec and 4.0 * dt_sec
  float dt, two_dt, four_dt;
  // scratch carried between the sweep launches
  float* t_work;               // [n, nn]
  int32_t* fb_work;            // [n, nn]
  float* lastdiff;             // [n]
  int32_t* sweep_max;          // [max_sweeps] float bits of the batch max
  int32_t* sweep_nan;          // [max_sweeps] 1 if any lane's diff was NaN
  // outputs
  float* t_out;                // [n, nn]
  int32_t* fb_out;             // [n, nn]
  int32_t* sweeps;             // [1]
};

// Node loops unroll fully on an EXACT lane (unroll count CAP) and not at all
// on the others (1).
template <int CAP, bool EXACT>
struct NodeLane {
  float t0[CAP], A[CAP], B[CAP], C[CAP], D[CAP], E[CAP], ice0[CAP];
  float moist[CAP], mmax[CAP], bub[CAP], expt[CAP];
  float b_last;   // no-flux coefficient of the bottom node
  bool fs;        // frozen soil active on this lane
  bool exp_trans;
  int nn_;

  // the lane's node count
  __device__ __forceinline__ int nn() const { return EXACT ? CAP : nn_; }

  __device__ void load(const SweepArgs& a, int i) {
    nn_ = a.nn;
    const int nn = this->nn();
    const int64_t cell = i / a.h;
    exp_trans = a.exp_trans != 0;
    float kap[CAP];
#pragma unroll (EXACT ? CAP : 1)
    for (int j = 0; j < nn; ++j) {
      const int64_t k = static_cast<int64_t>(i) * nn + j;
      const int64_t g = cell * nn + j;
      t0[j] = a.t0[k];
      kap[j] = a.kappa[k];
      ice0[j] = a.ice0[k];
      moist[j] = a.moist[k];
      if (exp_trans) {
        // the coefficients on the exponential grid (frozen_soil.c:190-212)
        const float zp1 = a.zp1[g];
        A[j] = a.exp_a[cell] * a.cs[k] * zp1 * zp1;
        C[j] = a.four_dt * kap[j];
        D[j] = a.two_dt * kap[j] * a.bexp[cell];
      } else {
        const float alpha = a.alpha[g];
        A[j] = a.cs[k] * alpha * alpha;
        C[j] = a.two_dt * kap[j] * alpha / a.gamma[g];
        D[j] = a.two_dt * kap[j] * alpha / a.beta[g];
      }
      E[j] = a.e_coef[g];
      mmax[j] = a.solver_max_moist[g];
      bub[j] = a.solver_bubble[g];
      expt[j] = a.solver_expt[g];
    }
    // kappa[j+1] - kappa[j-1], wrapping at the ends like torch.roll
#pragma unroll (EXACT ? CAP : 1)
    for (int j = 0; j < nn; ++j)
      B[j] = (kap[(j + 1) % nn] - kap[(j + nn - 1) % nn]) * a.dt;
    b_last = (kap[nn - 1] - kap[nn - 2]) * a.dt;
    fs = a.frozen != 0 && a.fs_active[cell] != 0;
  }

  // the C/D terms of the residual at node j (soil_thermal_eqn.c)
  __device__ __forceinline__ float flux2(int j, float t, float tl,
                                         float tu) const {
    if (exp_trans) return C[j] * (tl - 2.0f * t + tu) - D[j] * (tl - tu);
    return C[j] * (tl - t) - D[j] * (t - tu);
  }

  // the denominator of the closed-form update at node j
  __device__ __forceinline__ float denom(int j) const {
    return exp_trans ? A[j] + 2.0f * C[j] : A[j] + C[j] + D[j];
  }

  // the unfrozen closed-form update at node j with the B coefficient b
  // (frozen_soil.c:390-392)
  __device__ __forceinline__ float closed_form(int j, float tl, float tu,
                                               float b) const {
    if (exp_trans)
      return (A[j] * t0[j] + b * (tl - tu) + C[j] * (tl + tu) -
              D[j] * (tl - tu) + E[j] * (0.0f - ice0[j])) /
             denom(j);
    return (A[j] * t0[j] + b * (tl - tu) + C[j] * tl + D[j] * tu +
            E[j] * (0.0f - ice0[j])) /
           denom(j);
  }

  // SoilThermalEqn at node j (soil_thermal_eqn.c) with the node-1 cold-nose
  // patch (:58-70); T holds the current iterate
  __device__ float residual(float t, int j, const float* T) const {
    const float tl = T[j + 1], tu = T[j - 1];
    float ice = 0.0f;
    if (t < 0.0f && fs) {
      const float iw =
          nan_max(moist[j] - max_unfrozen(t, mmax[j], bub[j], expt[j]), 0.0f);
      ice = nan_min(iw, mmax[j]);
    }
    const float f1 = B[j] * (tl - tu);
    const float f2 = flux2(j, t, tl, tu);
    float val = -A[j] * (t - t0[j]) + f1 + f2 + E[j] * (ice - ice0[j]);
    if (j == 1 && fabsf(tl - tu) > 5.0f && t < tl && t < tu && f1 < 0.0f &&
        f2 > 0.0f && fabsf(f1) > fabsf(f2))
      val = val - f1;
    return val;
  }

  // one Gauss-Seidel sweep in place; adds the per-node fallbacks to fb and
  // returns the largest |change| (NaN if any change is NaN)
  __device__ float sweep(float* T, int32_t* fb, int nlayer, bool noflux) const {
    const int nn = this->nn();
    float maxdiff = 0.0f;
#pragma unroll (EXACT ? CAP : 1)
    for (int j = 1; j < nn - 1; ++j) {
      const float old_t = T[j], tl = T[j + 1], tu = T[j - 1];
      const float t_lin = closed_form(j, tl, tu, B[j]);
      float t_new = t_lin;
      if (old_t < 0.0f && fs) {
        bool bracketed;
        float t_root;
        if (j < nlayer) {
          // the quirk's residual is linear in t: its closed-form root,
          // then the bracket test over t0 +/- (SOIL_DT + 50)
          t_root = t_lin;
          if (j == 1) {
            const float f1 = B[j] * (tl - tu);
            const float r1 = t_lin - f1 / denom(j);
            const float f2_r1 = flux2(j, r1, tl, tu);
            if (fabsf(tl - tu) > 5.0f && r1 < tl && r1 < tu && f1 < 0.0f &&
                f2_r1 > 0.0f && fabsf(f1) > fabsf(f2_r1))
              t_root = r1;
          }
          const float wide = kSoilDt + 50.0f;
          const float f_lo = residual(t0[j] - wide, j, T);
          const float f_hi = residual(t0[j] + wide, j, T);
          bracketed = f_lo * f_hi < 0.0f;
        } else {
          // the first of six pairs t0 +/- (SOIL_DT + 10k) that brackets a
          // sign change, then 16 bisection steps
          float lo = t0[j] - kSoilDt, hi = t0[j] + kSoilDt;
          float flo = residual(lo, j, T);
          bracketed = flo * residual(hi, j, T) < 0.0f;
          for (int k = 1; k < kPairs && !bracketed; ++k) {
            const float delta = kSoilDt + 10.0f * k;
            const float lo_k = t0[j] - delta, hi_k = t0[j] + delta;
            const float flo_k = residual(lo_k, j, T);
            if (flo_k * residual(hi_k, j, T) < 0.0f) {
              lo = lo_k;
              hi = hi_k;
              flo = flo_k;
              bracketed = true;
            }
          }
          if (bracketed) {
            for (int it = 0; it < kBisectIters; ++it) {
              const float mid = 0.5f * (lo + hi);
              const float fm = residual(mid, j, T);
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
        t_new = bracketed ? t_root : t0[j];
        if (!bracketed) fb[j] += 1;
      }
      T[j] = t_new;
      maxdiff = nan_max(maxdiff, fabsf(old_t - t_new));
    }
    if (noflux) {
      // no-flux bottom: the node mirrors itself (B_last)
      const int j = nn - 1;
      const float old_t = T[j];
      const float t_lin = closed_form(j, T[j], T[j - 1], b_last);
      T[j] = t_lin;
      maxdiff = nan_max(maxdiff, fabsf(old_t - t_lin));
    }
    return maxdiff;
  }
};

// The initial iterate: the old temperatures with the new node-0 boundary
// condition (frozen_soil.c:305); nn nodes
template <int CAP, bool EXACT>
__device__ __forceinline__ void initial_profile(const SweepArgs& a, int i,
                                                int nn, float* T) {
  T[0] = a.surf_temp[i];
#pragma unroll (EXACT ? CAP : 1)
  for (int j = 1; j < nn; ++j)
    T[j] = a.t0[static_cast<int64_t>(i) * nn + j];
}

// After the last sweep: the runaway-cold-nose fix (frozen_soil.c:470-484,
// the reference's old/new mix, ascending j with the already-fixed T[j-1])
// and the whole-profile revert of a lane whose last sweep moved more than
// the tolerance (:486-494). T, fb: the lane's final iterate and counts.
template <int CAP, bool EXACT>
__device__ __forceinline__ void finish_profile(const SweepArgs& a, int i,
                                               int nn, float* T, int32_t* fb,
                                               float lastdiff) {
  float tlast[CAP];
  initial_profile<CAP, EXACT>(a, i, nn, tlast);
#pragma unroll (EXACT ? CAP : 1)
  for (int j = 1; j < nn - 1; ++j) {
    const bool nose = tlast[j - 1] - tlast[j] > 0.0f &&
                      tlast[j + 1] - T[j] > 0.0f &&
                      (T[j - 1] - T[j]) - (tlast[j - 1] - tlast[j]) > 0.0f &&
                      (T[j + 1] - T[j]) - (tlast[j + 1] - tlast[j]) > 0.0f;
    if (nose) {
      T[j] = 0.5f * (T[j - 1] + T[j + 1]);
      fb[j] += 1;
    }
  }
  if (lastdiff > kSweepTol) {
#pragma unroll (EXACT ? CAP : 1)
    for (int j = 0; j < nn; ++j) {
      T[j] = tlast[j];
      fb[j] += 1;
    }
  }
}

}  // namespace vicnode
