// Per-thread tridiagonal (Thomas) solve over N nodes.
//
// Replaces vic_tpu/ops/tridiag.py:16 (thomas_solve, two lax.scans over the
// node axis of the whole batch) inside K16 (implicit_profile.cu; the lake
// column kernels run the same recurrences on a warp, lake.cuh): one thread
// runs its column's forward elimination and back substitution in its own
// arrays, in the order of operations of the scans and of the plain version
// vic_tpu_torch/ops/tridiag.py. The elimination's coefficients (m, c') do
// not depend on the right-hand side, so a column whose matrix is fixed
// across a fixed-point iteration eliminates once (thomas_factor) and solves
// each right-hand side with thomas_apply. The node count is N, or n <= N
// nodes of an N-node array where a caller's count is known only at run time
// (the implicit soil-heat solve's rolled lane).
#pragma once

template <int N>
struct ThomasFactor {
  float m[N];    // pivot d_i - dl_i * c'_{i-1}
  float cp[N];   // c'_i = du_i / m_i
  float dl[N];
};

template <int N>
__device__ __forceinline__ void thomas_factor(const float* dl, const float* d,
                                              const float* du,
                                              ThomasFactor<N>* f,
                                              int n = N) {
  float cp_prev = 0.0f;
  for (int i = 0; i < n; ++i) {
    const float m = d[i] - dl[i] * cp_prev;
    cp_prev = du[i] / m;
    f->m[i] = m;
    f->cp[i] = cp_prev;
    f->dl[i] = dl[i];
  }
}

// x = the solution for right-hand side b (x may alias b)
template <int N>
__device__ __forceinline__ void thomas_apply(const ThomasFactor<N>& f,
                                             const float* b, float* x,
                                             int n = N) {
  float dp[N];
  float dp_prev = 0.0f;
  for (int i = 0; i < n; ++i) {
    dp_prev = (b[i] - f.dl[i] * dp_prev) / f.m[i];
    dp[i] = dp_prev;
  }
  float x_next = 0.0f;
  for (int i = n - 1; i >= 0; --i) {
    x_next = dp[i] - f.cp[i] * x_next;
    x[i] = x_next;
  }
}
