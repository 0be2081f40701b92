// Per-thread fixed-count bisection over a residual functor.
//
// A line-for-line match of vic_tpu/ops/rootfind.py:210-234
// (batched_bisection) and of its plain PyTorch copy in
// vic_tpu_torch/ops/rootfind.py, for ONE lane: bracketed = f(lo)*f(hi) < 0;
// n_iter halvings that keep the left half where f(lo)*f(mid) <= 0; the root
// is the midpoint of the final bracket, converged = bracketed, and the
// lane runs all n_iter steps whether it brackets or not. An inactive lane
// returns the midpoint of [lo, hi] with converged = bracketed = false and
// 0 iterations, as the plain version's active mask gives it.
#pragma once

#include "brent.cuh"

template <class Residual>
__device__ __forceinline__ BrentOut bisection_solve(const Residual& f,
                                                    float lo, float hi,
                                                    bool active, int n_iter) {
  BrentOut out{0.5f * (lo + hi), false, false, 0};
  if (!active) return out;
  float f_lo = f(lo);
  const bool bracketed = f_lo * f(hi) < 0.0f;
  for (int it = 0; it < n_iter; ++it) {
    const float mid = 0.5f * (lo + hi);
    const float f_mid = f(mid);
    if (f_lo * f_mid <= 0.0f) {  // f_mid == 0: shrink hi onto the root
      hi = mid;
    } else {
      lo = mid;
      f_lo = f_mid;
    }
  }
  out.root = 0.5f * (lo + hi);
  out.converged = bracketed;
  out.bracketed = bracketed;
  out.iterations = n_iter;
  return out;
}
