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
// solve: an exact 5-node lane whose arrays live in registers, and one
// rolled lane of capacity 50 (the reference's MAX_NODES) for 3-50 nodes
// with its arrays in local memory, as the node sweep (K6) does. The
// unfrozen-water curve is physics.cuh's, its terms formed once on the host
// as vic_tpu forms them from its float64 geometry. Bound by operations and
// latency: per step and node ~40 FP32 operations and two powf of the ice
// derivative, against ~24 B read and 8 B written per node.
//
// Every operation follows the plain version
// (physics.frozen_soil.solve_t_profile_implicit_plain) in order, the
// kappa[j+1] - kappa[j-1] of jnp.roll wrapping at the ends (under NOFLUX
// the bottom row reads kappa[0]); every min/max/clip propagates NaN.
//
// C interface for ctypes: returns cudaGetLastError(), or
// cudaErrorInvalidValue for a node count outside 3-50.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "physics.cuh"
#include "thomas.cuh"

namespace {

using namespace vicphys;

constexpr int kBlock = 128;
constexpr int kExactNodes = 5;
constexpr int kMaxNodes = 50;

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
};

template <int CAP, bool EXACT>
struct ImplicitLane {
  float t0[CAP], A[CAP], B[CAP], C[CAP], D[CAP], E[CAP], ice0[CAP];
  float moist[CAP], mmax[CAP], bt[CAP], pw[CAP];
  bool frozen, fs, noflux;
  int nn_;

  __device__ __forceinline__ int nn() const { return EXACT ? CAP : nn_; }

  __device__ void load(const ImplicitArgs& a, int i) {
    nn_ = a.nn;
    const int nn = this->nn();
    const int64_t cell = i / a.h;
    float kap[CAP];
#pragma unroll (EXACT ? CAP : 1)
    for (int j = 0; j < nn; ++j) {
      const int64_t k = static_cast<int64_t>(i) * nn + j;
      const int64_t g = cell * nn + j;
      const float alpha = a.alpha[g];
      t0[j] = a.t0[k];
      kap[j] = a.kappa[k];
      ice0[j] = a.ice0[k];
      moist[j] = a.moist[k];
      A[j] = a.cs[k] * alpha * alpha;
      C[j] = a.two_dt * kap[j] * alpha / a.gamma[g];
      D[j] = a.two_dt * kap[j] * alpha / a.beta[g];
      E[j] = a.e_lin[g];
      mmax[j] = a.max_moist[g];
      bt[j] = a.bubble_term[g];
      pw[j] = a.power[g];
    }
    // kappa[j+1] - kappa[j-1], wrapping at the ends like jnp.roll
#pragma unroll (EXACT ? CAP : 1)
    for (int j = 0; j < nn; ++j)
      B[j] = (kap[(j + 1) % nn] - kap[(j + nn - 1) % nn]) * a.dt;
    frozen = a.frozen != 0;
    fs = a.fs_active[cell] != 0;
    noflux = a.noflux != 0;
  }

  // the rows the solve updates: 1..nn-2, and the bottom under NOFLUX
  __device__ __forceinline__ bool interior(int j) const {
    return (j >= 1 && j < nn() - 1) || (noflux && j == nn() - 1);
  }

  // the node's ice at temperature t
  __device__ __forceinline__ float ice_of(float t, int j) const {
    if (!frozen || !(fs && t < 0.0f)) return 0.0f;
    const float iw =
        nan_max(moist[j] - unfrozen_from_terms(t, mmax[j], bt[j], pw[j]),
                0.0f);
    return nan_min(iw, mmax[j]);
  }

  // one Newton-Raphson step of T in place with relaxation `relax`
  __device__ void nr_step(float* T, float relax) const {
    const int nn = this->nn();
    float dl[CAP], d[CAP], du[CAP], b[CAP];
#pragma unroll (EXACT ? CAP : 1)
    for (int j = 0; j < nn; ++j) {
      if (!interior(j)) {
        dl[j] = 0.0f;   // the identity row of a boundary node
        d[j] = 1.0f;
        du[j] = 0.0f;
        b[j] = -0.0f;   // -f / 1 with f = 0
        continue;
      }
      const float t = T[j];
      const bool bottom = j == nn - 1;   // under NOFLUX: mirrors itself
      const float tl = bottom ? t : T[j + 1], tu = T[j - 1];
      const float f = -A[j] * (t - t0[j]) + B[j] * (tl - tu) +
                      C[j] * (tl - t) - D[j] * (t - tu) +
                      E[j] * (ice_of(t, j) - ice0[j]);
      const float dice =
          div_s(ice_of(t + 0.05f, j) - ice_of(t - 0.05f, j), 0.1f);
      float dmain = -A[j] - C[j] - D[j] + E[j] * dice;
      float dsup = B[j] + C[j];
      if (bottom) {
        // tl == T folds the super-diagonal into the diagonal
        dmain = dmain + (B[j] + C[j]);
        dsup = 0.0f;
      }
      const float scale = fabsf(dmain) + 1e-6f;
      dl[j] = (-B[j] + D[j]) / scale;
      d[j] = dmain / scale;
      du[j] = dsup / scale;
      b[j] = -f / scale;
    }
    ThomasFactor<CAP> fac;
    thomas_factor<CAP>(dl, d, du, &fac, nn);
    thomas_apply<CAP>(fac, b, b, nn);
#pragma unroll (EXACT ? CAP : 1)
    for (int j = 0; j < nn; ++j) {
      const float delta =
          interior(j) ? nan_min(nan_max(b[j], -10.0f), 10.0f) : 0.0f;
      T[j] = T[j] + relax * delta;
    }
  }
};

template <int CAP, bool EXACT>
__global__ void implicit_profile_kernel(const ImplicitArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  ImplicitLane<CAP, EXACT> lane;
  lane.load(a, i);
  const int nn = lane.nn();
  const float surf = a.surf_temp[i];
  float T[CAP];
  T[0] = surf;
#pragma unroll (EXACT ? CAP : 1)
  for (int j = 1; j < nn; ++j) T[j] = lane.t0[j];
  for (int it = 0; it < a.max_nr; ++it) {
    const float relax =
        a.use_relax ? a.relax : (it == 0 ? 0.9f : (it == 1 ? 0.7f : 0.2f));
    lane.nr_step(T, relax);
  }
  // fallback (TFALLBACK): non-finite or wild nodes revert the whole lane
  // to its old profile with the new surface temperature; the nodes that
  // went wild are counted (frozen_soil.c:404-418)
  bool any_bad = false;
  const int64_t base = static_cast<int64_t>(i) * nn;
#pragma unroll (EXACT ? CAP : 1)
  for (int j = 0; j < nn; ++j) {
    const bool bad = !isfinite(T[j]) || fabsf(T[j] - lane.t0[j]) > 40.0f;
    a.fb_out[base + j] = bad ? 1 : 0;
    any_bad = any_bad || bad;
  }
#pragma unroll (EXACT ? CAP : 1)
  for (int j = 0; j < nn; ++j)
    a.t_out[base + j] = any_bad ? (j == 0 ? surf : lane.t0[j]) : T[j];
}

}  // namespace

extern "C" {

// lane: t0, kappa, cs, moist, ice0 ([n, nn] contiguous); geometry: alpha,
// beta, gamma, e_lin, max_moist, bubble_term, power ([n_cell, nn]); surf
// [n]; fs_active [n_cell]. relax is used where use_relax, else the
// reference's schedule.
int implicit_profile(const void* const* lane, const void* const* geo,
                     const float* surf_temp, const uint8_t* fs_active, int n,
                     int h, int nn, int frozen, int noflux, int max_nr,
                     int use_relax, float relax, float dt, float two_dt,
                     float* t_out, int32_t* fb_out, void* stream) {
  if (n <= 0 || h < 1 || nn < 3 || nn > kMaxNodes || max_nr < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* const* l = reinterpret_cast<const float* const*>(lane);
  const float* const* g = reinterpret_cast<const float* const*>(geo);
  const ImplicitArgs a{l[0], l[1], l[2], l[3], l[4], g[0], g[1], g[2], g[3],
                       g[4], g[5], g[6], surf_temp, fs_active, n, h, nn,
                       frozen, noflux, max_nr, use_relax, relax, dt, two_dt,
                       t_out, fb_out};
  const dim3 grid((n + kBlock - 1) / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nn == kExactNodes)
    implicit_profile_kernel<kExactNodes, true><<<grid, kBlock, 0, s>>>(a);
  else
    implicit_profile_kernel<kMaxNodes, false><<<grid, kBlock, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
