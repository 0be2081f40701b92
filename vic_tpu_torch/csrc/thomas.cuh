// Per-thread tridiagonal (Thomas) solve, one row at a time.
//
// Replaces vic_tpu/ops/tridiag.py:16 (thomas_solve, two lax.scans over the
// node axis of the whole batch) inside K16 (implicit_profile.cu): one
// thread runs its column's forward elimination and back substitution, in
// the order of operations of the scans and of the plain version
// vic_tpu_torch/ops/tridiag.py. K16's matrix changes with every right-hand
// side, so each row's elimination and forward substitution run together as
// the row is formed (thomas_eliminate), then the back substitution from the
// last row up (thomas_substitute), two values kept a row. The lake column
// kernels (lake.cuh) run the same recurrences on a warp's lane 0.
#pragma once

// row i's step of the forward elimination and forward substitution
// together (the pivot m_i = d_i - dl_i c'_{i-1}, c'_i = du_i / m_i and
// d'_i = (b_i - dl_i d'_{i-1}) / m_i), from row i - 1's {c', d'} ({0, 0}
// before row 0)
struct ThomasRow {
  float cp, dp;
};

__device__ __forceinline__ ThomasRow thomas_eliminate(float dl, float d,
                                                      float du, float b,
                                                      ThomasRow prev) {
  const float m = d - dl * prev.cp;
  return ThomasRow{du / m, (b - dl * prev.dp) / m};
}

// x_i from row i's {c', d'} and x_{i+1} (0 below the last row)
__device__ __forceinline__ float thomas_substitute(ThomasRow r,
                                                   float x_next) {
  return r.dp - r.cp * x_next;
}
