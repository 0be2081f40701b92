// Per-thread expand-then-Brent root finder over a residual functor.
//
// A line-for-line match of vic_tpu/ops/rootfind.py:43-207 (expand_brackets
// + batched_brent) and of its plain PyTorch copy in
// vic_tpu_torch/ops/rootfind.py, for ONE lane: the same MAXTRIES x 10 C
// bracket widening, the same tol = 2*FLT_EPSILON*|b| + 1e-4, the same
// fa==0 / fc==0 / q==0 guards. Where the batched versions keep iterating a
// converged lane until every lane is done, this loop stops the lane at
// once: the batch loop's rearrangement (same-side reset, then best-iterate
// swap) runs on frozen lanes too, and it is idempotent after one pass, so
// rearranging first and then testing for convergence leaves (b, c) exactly
// where the batch loop leaves them.
//
// Unbracketed or inactive lanes return the midpoint of the ORIGINAL
// [lo, hi] with converged = bracketed = false (rootfind.py:205).
//
// K12 (lake_ice_brent.cu, one thread a lake) is brent_solve's last user:
// K1-K3, K5 and K14 run lane_brent.cuh's BrentLane, which repeats this
// function step for step, so a change here goes there too. brent_solve
// suits a batch whose lanes are mostly active, one lake a thread; where
// few lanes are active a warp waits on them, which is what the lane driver
// was built for.
#pragma once

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#include "lanes.cuh"

struct BrentOut {
  float root;
  bool converged;
  bool bracketed;
  int iterations;
};

template <class Residual>
__device__ __forceinline__ BrentOut brent_solve(const Residual& f, float lo,
                                                float hi, bool active,
                                                int max_iter, int max_tries) {
  const float kTstep = 10.0f;
  const float kTol = 1e-4f;
  const float kEps2 = 2.0f * FLT_EPSILON;
  BrentOut out{0.5f * (lo + hi), false, false, 0};
  if (!active) return out;

  // bracket expansion (root_brent.c:183-244)
  float a = lo, b = hi;
  float fa = f(a), fb = f(b);
  for (int t = 0; t < max_tries && fa * fb >= 0.0f; ++t) {
    a = a - kTstep;
    b = b + kTstep;
    fa = f(a);
    fb = f(b);
  }
  if (!(fa * fb < 0.0f)) return out;
  out.bracketed = true;

  float c = a, fc = fa;
  float d = b - a, e = b - a;
  int it = 0;
  for (; it < max_iter; ++it) {
    // rearrange so b is the best iterate and [b, c] brackets the root
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
    if (fabsf(m) <= tol_i || fb == 0.0f) break;

    // secant (a == c) or inverse quadratic interpolation, else bisection
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
    const bool interp_ok = (2.0f * p < 3.0f * m * q - fabsf(tol_i * q)) &&
                           (p < fabsf(0.5f * e * q));
    float d_new, e_new;
    if (!use_bisect && interp_ok) {
      e_new = d;
      d_new = p / (q == 0.0f ? 1.0f : q);
    } else {
      e_new = m;
      d_new = m;
    }
    const float step =
        fabsf(d_new) > tol_i ? d_new : (m > 0.0f ? tol_i : -tol_i);
    a = b;
    fa = fb;
    b = b + step;
    fb = f(b);
    d = d_new;
    e = e_new;
  }
  out.iterations = it;
  const float tol_f = kEps2 * fabsf(b) + kTol;
  out.converged = fabsf(0.5f * (c - b)) <= tol_f || fb == 0.0f;
  out.root = b;
  return out;
}

// Outputs of a one-thread-per-lane Brent kernel.
struct BrentOutputs {
  float* root;
  uint8_t* converged;
  uint8_t* bracketed;
  int32_t* iterations;
};

__device__ __forceinline__ void store(const BrentOutputs& out, int i,
                                      const BrentOut& r) {
  out.root[i] = r.root;
  out.converged[i] = r.converged;
  out.bracketed[i] = r.bracketed;
  out.iterations[i] = r.iterations;
}

// Launches kernel(in, lo, hi, dt, max_iter, max_tries, n, out) over n lanes
// in blocks of kBrentBlock; cudaErrorInvalidValue unless the input counts
// are the kernel's, else cudaGetLastError().
constexpr int kBrentBlock = 128;

template <class Kernel>
int launch_brent(Kernel kernel, const int64_t* lanes, int nf,
                 int nf_expected, int nm, int nm_expected, int h,
                 const float* lo, const float* hi, float dt, int max_iter,
                 int max_tries, int n, float* root, uint8_t* converged,
                 uint8_t* bracketed, int32_t* iterations, void* stream) {
  LaneInputs in{};
  if (n <= 0 ||
      !fill_lane_inputs(&in, lanes, nf, nf_expected, nm, nm_expected, h))
    return static_cast<int>(cudaErrorInvalidValue);
  const BrentOutputs out{root, converged, bracketed, iterations};
  kernel<<<(n + kBrentBlock - 1) / kBrentBlock, kBrentBlock, 0,
           static_cast<cudaStream_t>(stream)>>>(in, lo, hi, dt, max_iter,
                                                 max_tries, n, out);
  return static_cast<int>(cudaGetLastError());
}
