// K16 implicit_profile <- vic_tpu/physics/frozen_soil.py:601
//                         solve_t_profile_implicit
//
// The IMPLICIT soil-heat solve (frozen_soil.c:229-300, fda_heat_eqn):
// max_nr Newton-Raphson steps on the node system, each a Thomas solve of
// the row-scaled tridiagonal Jacobian (csrc/thomas.cuh), relaxed by the
// reference's schedule 0.9/0.7/0.2 (newt_raph_func_fast.c:7-15) or a given
// factor, the update clipped to +-10 C; then any lane with a non-finite
// node or a node more than 40 C from its old temperature reverts to the
// old profile (with the new surface temperature), counting those nodes. On
// the TPU every NR step was a lax.fori_loop trip over the whole batch with
// two lax.scans along the nodes. Here one thread runs one lane's whole
// solve. The unfrozen-water curve is physics.cuh's, its terms formed once
// on the host as vic_tpu forms them from its float64 geometry. Bound by
// operations and latency: per step and node ~40 FP32 operations and two
// powf of the ice derivative, against ~24 B read and 8 B written per node.
//
// A lane's node arrays decide its speed: held per thread in an array of
// the largest count (50), they lived in local memory, and 10 nodes took
// 5.9 times the time of 5. So:
// - 3, 5 and 10 nodes (QUICK_FLUX's count and the smoke's smallest; the
//   frozen and heavy configurations'; frozen_exp's) each have an instance
//   whose node count is bound at compile time (RegisterLane<N>): every
//   loop unrolls and the arrays live in registers. 3 and 5 nodes hold the
//   cell's geometry in registers too; 10 nodes read it where they use it
//   (122 registers, where holding it took 156 and left 12 warps an SM);
// - any other count from 3 to 50 runs RolledLane, whose per-node values
//   live in global scratch laid out node-major, [row][node][lane], so a
//   warp's loads of one node are neighbouring addresses (as K6 keeps its
//   coefficients, node_sweep.cuh), the cell's geometry read where it is
//   used.
// Both eliminate row by row (thomas_eliminate: the factor's and the
// forward substitution's values of a row as the row is formed) and
// substitute back while the iterate updates, keeping two values a node
// where the factor and apply kept four.
//
// Every operation follows the plain version
// (physics.frozen_soil.solve_t_profile_implicit_plain) in order, the
// kappa[j+1] - kappa[j-1] of jnp.roll wrapping at the ends (under NOFLUX
// the bottom row reads kappa[0]); every min/max/clip propagates NaN. Both
// lanes run the same operations, so they give the same bits at any count.
//
// C interface for ctypes: implicit_profile returns cudaGetLastError(), or
// cudaErrorInvalidValue for a node count outside 3-50 or a rolled count
// without scratch; implicit_profile_scratch_rows says how much scratch a
// count takes.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "physics.cuh"
#include "thomas.cuh"

namespace {

using namespace vicphys;

constexpr int kBlock = 128;
constexpr int kMaxNodes = 50;

// the rolled lane's scratch rows, [kNumRows][nn][n]
enum Row { kA, kB, kC, kD, kT0, kIce0, kMoist, kT, kCp, kDp, kNumRows };

struct ImplicitArgs {
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
  const float* e_lin;         // rho_ice * Lf * alpha^2
  const float* max_moist;     // mm/mm
  const float* bubble_term;   // 9.81 * bubble / 100
  const float* power;         // -2 / (expt - 3)
  const float* surf_temp;     // [n] node-0 boundary condition
  const uint8_t* fs_active;   // [n_cell]
  int n, h, nn, frozen, noflux, max_nr, use_relax;
  float relax, dt, two_dt;
  float* t_out;               // [n, nn]
  int32_t* fb_out;            // [n, nn]
  float* work;                // [kNumRows][nn][n], the rolled lane's
};

// one node's coefficients, as the plain version forms them
struct NodeCoef {
  float A, B, C, D;
};

__device__ __forceinline__ NodeCoef node_coef(const ImplicitArgs& a,
                                              int64_t lane, int64_t cell,
                                              int nn, int j) {
  const int64_t g = cell * nn + j;
  const float alpha = a.alpha[g];
  const float kap = a.kappa[lane * nn + j];
  // kappa[j+1] - kappa[j-1], wrapping at the ends like jnp.roll
  const float kap_p1 = a.kappa[lane * nn + (j + 1) % nn];
  const float kap_m1 = a.kappa[lane * nn + (j + nn - 1) % nn];
  return NodeCoef{a.cs[lane * nn + j] * alpha * alpha,
                  (kap_p1 - kap_m1) * a.dt,
                  a.two_dt * kap * alpha / a.gamma[g],
                  a.two_dt * kap * alpha / a.beta[g]};
}

// the node's ice at temperature t
__device__ __forceinline__ float ice_at(bool freezes, float t, float moist,
                                        float mmax, float bt, float pw) {
  if (!freezes || !(t < 0.0f)) return 0.0f;
  const float iw =
      nan_max(moist - unfrozen_from_terms(t, mmax, bt, pw), 0.0f);
  return nan_min(iw, mmax);
}

// the row-scaled Newton row of node j: the identity row of a boundary
// node, else the residual's row at t with neighbours tl (below; t itself
// for the NOFLUX bottom, which mirrors itself) and tu (above)
struct NewtonRow {
  float dl, d, du, b;
};

__device__ __forceinline__ NewtonRow newton_row(
    bool interior, bool bottom, float t, float tl, float tu, float t0,
    NodeCoef k, float E, float ice0, bool freezes, float moist, float mmax,
    float bt, float pw) {
  if (!interior) return NewtonRow{0.0f, 1.0f, 0.0f, -0.0f};  // -f / 1
  const float f = -k.A * (t - t0) + k.B * (tl - tu) + k.C * (tl - t) -
                  k.D * (t - tu) +
                  E * (ice_at(freezes, t, moist, mmax, bt, pw) - ice0);
  const float dice =
      div_s(ice_at(freezes, t + 0.05f, moist, mmax, bt, pw) -
                ice_at(freezes, t - 0.05f, moist, mmax, bt, pw),
            0.1f);
  float dmain = -k.A - k.C - k.D + E * dice;
  float dsup = k.B + k.C;
  if (bottom) {
    // tl == T folds the super-diagonal into the diagonal
    dmain = dmain + (k.B + k.C);
    dsup = 0.0f;
  }
  const float scale = fabsf(dmain) + 1e-6f;
  return NewtonRow{(-k.B + k.D) / scale, dmain / scale, dsup / scale,
                   -f / scale};
}

// node j's update from the solve's x: the clip, 0 on a boundary node
__device__ __forceinline__ float relaxed(float T, bool interior, float x,
                                         float relax) {
  const float delta = interior ? nan_min(nan_max(x, -10.0f), 10.0f) : 0.0f;
  return T + relax * delta;
}

__device__ __forceinline__ float step_relax(const ImplicitArgs& a, int it) {
  return a.use_relax ? a.relax : (it == 0 ? 0.9f : (it == 1 ? 0.7f : 0.2f));
}

// the rows the solve updates: 1..nn-2, and the bottom under NOFLUX
__device__ __forceinline__ bool is_interior(int j, int nn, bool noflux) {
  return (j >= 1 && j < nn - 1) || (noflux && j == nn - 1);
}

// Writes the lane's result: the fallback (TFALLBACK) reverts a lane with a
// non-finite or wild node to its old profile with the new surface
// temperature, and the nodes that went wild are counted
// (frozen_soil.c:404-418). T(j) and T0(j): the solve's and the old
// temperatures of nn nodes, N of them where N > 0.
template <int N, class Tf, class T0f>
__device__ __forceinline__ void write_lane(const ImplicitArgs& a, int64_t i,
                                           int nn, float surf, Tf T, T0f T0) {
  if (N > 0) nn = N;
  bool any_bad = false;
  const int64_t base = i * nn;
#pragma unroll
  for (int j = 0; j < nn; ++j) {
    const bool bad = !isfinite(T(j)) || fabsf(T(j) - T0(j)) > 40.0f;
    a.fb_out[base + j] = bad ? 1 : 0;
    any_bad = any_bad || bad;
  }
#pragma unroll
  for (int j = 0; j < nn; ++j)
    a.t_out[base + j] = any_bad ? (j == 0 ? surf : T0(j)) : T(j);
}

// a read of the cell's geometry where it is used: the asm keeps the
// compiler from hoisting it out of the Newton loop into registers
__device__ __forceinline__ float geometry_at(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// a lane of N nodes, N known at compile time: every loop unrolled and its
// arrays in registers. Up to 5 nodes it holds the cell's geometry (E and
// the unfrozen-water terms) too; 10 nodes read it where it is used, which
// keeps 40 registers for more resident lanes.
template <int N>
struct RegisterLane {
  static constexpr bool kHoldGeometry = N <= 5;
  static constexpr int kHeld = kHoldGeometry ? N : 1;
  float t0[N], A[N], B[N], C[N], D[N], ice0[N], moist[N];
  float E[kHeld], mmax[kHeld], bt[kHeld], pw[kHeld];
  int64_t g0;   // the cell's geometry row

  // E, mmax, bt and pw of node j
  __device__ __forceinline__ float4 geometry(const ImplicitArgs& a,
                                             int j) const {
    if constexpr (kHoldGeometry) {
      return make_float4(E[j], mmax[j], bt[j], pw[j]);
    } else {
      return make_float4(
          geometry_at(a.e_lin + g0 + j), geometry_at(a.max_moist + g0 + j),
          geometry_at(a.bubble_term + g0 + j), geometry_at(a.power + g0 + j));
    }
  }

  __device__ void run(const ImplicitArgs& a, int64_t i) {
    const int64_t cell = i / a.h;
    const bool freezes = a.frozen != 0 && a.fs_active[cell] != 0;
    const bool noflux = a.noflux != 0;
    g0 = cell * N;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int64_t k = i * N + j;
      const NodeCoef c = node_coef(a, i, cell, N, j);
      A[j] = c.A;
      B[j] = c.B;
      C[j] = c.C;
      D[j] = c.D;
      t0[j] = a.t0[k];
      ice0[j] = a.ice0[k];
      moist[j] = a.moist[k];
      if constexpr (kHoldGeometry) {
        E[j] = a.e_lin[g0 + j];
        mmax[j] = a.max_moist[g0 + j];
        bt[j] = a.bubble_term[g0 + j];
        pw[j] = a.power[g0 + j];
      }
    }
    const float surf = a.surf_temp[i];
    float T[N];
    T[0] = surf;
#pragma unroll
    for (int j = 1; j < N; ++j) T[j] = t0[j];
    for (int it = 0; it < a.max_nr; ++it) {
      const float relax = step_relax(a, it);
      ThomasRow rows[N];
      ThomasRow prev{0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const bool interior = is_interior(j, N, noflux);
        const bool bottom = j == N - 1;
        const float t = T[j];
        const float tl = bottom ? t : T[j + 1 < N ? j + 1 : j];
        const float tu = T[j > 0 ? j - 1 : 0];
        const float4 geo = interior ? geometry(a, j) : float4{};
        const NewtonRow r = newton_row(
            interior, bottom, t, tl, tu, t0[j],
            NodeCoef{A[j], B[j], C[j], D[j]}, geo.x, ice0[j], freezes,
            moist[j], geo.y, geo.z, geo.w);
        prev = thomas_eliminate(r.dl, r.d, r.du, r.b, prev);
        rows[j] = prev;
      }
      float x = 0.0f;
#pragma unroll
      for (int j = N - 1; j >= 0; --j) {
        x = thomas_substitute(rows[j], x);
        T[j] = relaxed(T[j], is_interior(j, N, noflux), x, relax);
      }
    }
    write_lane<N>(a, i, N, surf, [&](int j) { return T[j]; },
                  [&](int j) { return t0[j]; });
  }
};

// a lane of any count nn from 3 to 50: its per-node values in the
// node-major scratch, the cell's geometry read where it is used
struct RolledLane {
  const ImplicitArgs& a;
  int64_t i, cell;
  int nn;

  __device__ float& at(Row r, int j) const {
    return a.work[(static_cast<int64_t>(r) * nn + j) * a.n + i];
  }

  __device__ void run() {
    const bool freezes = a.frozen != 0 && a.fs_active[cell] != 0;
    const bool noflux = a.noflux != 0;
    const float surf = a.surf_temp[i];
    for (int j = 0; j < nn; ++j) {
      const int64_t k = i * nn + j;
      const NodeCoef c = node_coef(a, i, cell, nn, j);
      at(kA, j) = c.A;
      at(kB, j) = c.B;
      at(kC, j) = c.C;
      at(kD, j) = c.D;
      at(kT0, j) = a.t0[k];
      at(kIce0, j) = a.ice0[k];
      at(kMoist, j) = a.moist[k];
      at(kT, j) = j == 0 ? surf : a.t0[k];
    }
    for (int it = 0; it < a.max_nr; ++it) {
      const float relax = step_relax(a, it);
      ThomasRow prev{0.0f, 0.0f};
      float tu = 0.0f, t = at(kT, 0);
      for (int j = 0; j < nn; ++j) {
        const bool bottom = j == nn - 1;
        const float tl = bottom ? t : at(kT, j + 1);
        const int64_t g = cell * nn + j;
        const NewtonRow r = newton_row(
            is_interior(j, nn, noflux), bottom, t, tl, tu, at(kT0, j),
            NodeCoef{at(kA, j), at(kB, j), at(kC, j), at(kD, j)},
            a.e_lin[g], at(kIce0, j), freezes, at(kMoist, j),
            a.max_moist[g], a.bubble_term[g], a.power[g]);
        prev = thomas_eliminate(r.dl, r.d, r.du, r.b, prev);
        at(kCp, j) = prev.cp;
        at(kDp, j) = prev.dp;
        tu = t;
        t = tl;
      }
      float x = 0.0f;
      for (int j = nn - 1; j >= 0; --j) {
        x = thomas_substitute(ThomasRow{at(kCp, j), at(kDp, j)}, x);
        at(kT, j) = relaxed(at(kT, j), is_interior(j, nn, noflux), x, relax);
      }
    }
    write_lane<0>(a, i, nn, surf, [&](int j) { return at(kT, j); },
               [&](int j) { return at(kT0, j); });
  }
};

// blocks an SM holds at once: 10 nodes fit 128 registers a thread
template <int N>
__global__ void __launch_bounds__(kBlock, N == 10 ? 4 : 1)
    implicit_profile_kernel(const ImplicitArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  if constexpr (N > 0) {
    RegisterLane<N> lane;
    lane.run(a, i);
  } else {
    RolledLane lane{a, i, i / a.h, a.nn};
    lane.run();
  }
}

using Kernel = void (*)(ImplicitArgs);

// the instance that runs nn nodes: RegisterLane<nn> where it exists, else
// the rolled lane
Kernel kernel_for(int nn) {
  switch (nn) {
    case 3: return implicit_profile_kernel<3>;
    case 5: return implicit_profile_kernel<5>;
    case 10: return implicit_profile_kernel<10>;
    default: return implicit_profile_kernel<0>;
  }
}

bool in_registers(int nn) {
  return kernel_for(nn) != implicit_profile_kernel<0>;
}

}  // namespace

extern "C" {

// lane: t0, kappa, cs, moist, ice0 ([n, nn] contiguous); geometry: alpha,
// beta, gamma, e_lin, max_moist, bubble_term, power ([n_cell, nn]); surf
// [n]; fs_active [n_cell]. relax is used where use_relax, else the
// reference's schedule. work: implicit_profile_scratch_rows(nn) * nn * n
// floats of scratch (unused, and may be null, where that is 0).
int implicit_profile(const void* const* lane, const void* const* geo,
                     const float* surf_temp, const uint8_t* fs_active, int n,
                     int h, int nn, int frozen, int noflux, int max_nr,
                     int use_relax, float relax, float dt, float two_dt,
                     float* t_out, int32_t* fb_out, void* stream,
                     float* work) {
  if (n <= 0 || h < 1 || nn < 3 || nn > kMaxNodes || max_nr < 0 ||
      (!in_registers(nn) && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* const* l = reinterpret_cast<const float* const*>(lane);
  const float* const* g = reinterpret_cast<const float* const*>(geo);
  const ImplicitArgs a{l[0], l[1], l[2], l[3], l[4], g[0], g[1], g[2], g[3],
                       g[4], g[5], g[6], surf_temp, fs_active, n, h, nn,
                       frozen, noflux, max_nr, use_relax, relax, dt, two_dt,
                       t_out, fb_out, work};
  const dim3 grid((n + kBlock - 1) / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel_for(nn)<<<grid, kBlock, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// the rows of [rows][nn][n] scratch implicit_profile takes at nn nodes: 0
// where the lane holds its nodes in registers
int implicit_profile_scratch_rows(int nn) {
  return in_registers(nn) ? 0 : kNumRows;
}

}  // extern "C"
