// K7 fd_surface_brent: the soil-surface temperature of the finite-difference
// (frozen-soil) step, for sm_90a (H100).
//
// Replaces vic_tpu/physics/surface.py:438 (solve_surface_temperature's
// batched_brent, vic_tpu/ops/rootfind.py:89-207) on the residual :71-378 in
// its finite-difference form: every candidate Ts is the node-0 boundary of a
// Gauss-Seidel solve of the node profile (K6, node_sweep.cu), and the ground
// heat comes from nodes 1 and 2 with the fusion of the top node pair.
//
// Why not one thread per lane, as K5: K6's sweep count is decided over the
// WHOLE batch (a sweep runs while any lane moved more than 1e-2 C), so every
// lane's profile depends on every other lane's candidate, those of lanes
// whose Brent is done included. The batch's Brent therefore advances in
// lock step, as the plain loop does: its state lives on the device, one
// entry per lane, and each iteration is a fixed sequence of launches --
// propose (the rearrange / secant / inverse-quadratic / bisection step on
// EVERY lane, done or not, exactly as the plain loop computes b_next), K6 at
// b_next, accept (the residual at b_next from nodes 1-2, the update masked on
// done and unbracketed lanes). The bracket expansion is built the same way.
// The host reads one flag per iteration (are all lanes done / does any lane
// still need widening), the sync the plain loop pays too; the ~300 PyTorch
// launches of each plain residual evaluation become one launch.
//
// Each residual launch reads a lane's ~64 inputs (~300 B; with DIST_PRCP the
// dry column's ~80 B more) and two node temperatures and does one ~150-flop
// residual (two ET evaluations with DIST_PRCP): bound by bytes at these
// sizes, and by K6's sweeps and the launch latency of the sequence overall.
//
// C interface for ctypes: one entry, `op` choosing the launch; returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#include "lanes.cuh"
#include "surface_brent.cuh"

namespace {

constexpr int kBlock = 128;
constexpr float kTstep = 10.0f;          // bracket expansion step
constexpr float kTol = 1e-4f;            // the float32 Brent tol addend
constexpr float kEps2 = 2.0f * FLT_EPSILON;

// float rows of the Brent state, [kNumRows][n]
enum Row { kA, kB, kC, kFa, kFb, kFc, kD, kE, kDNew, kENew, kBNext,
           kNumRows };
// uint8 rows, [kNumFlagRows][n]
enum FlagRow { kNeed, kDone, kBracketed, kNumFlagRows };
// the launches
enum Op {
  kEvalLo,      // fa = f(a) on every lane
  kEvalHi,      // fb = f(b) on every lane
  kEvalLoNeed,  // fa = f(a) where the lane widened its bracket
  kEvalHiNeed,  // fb = f(b) there
  kExpand,      // need = no sign change yet (active lanes); widen; flag any
  kInit,        // bracketed, c, fc, d, e, done; flag any lane not done
  kPropose,     // one Brent step's candidate b_next on every lane
  kAccept,      // f(b_next) and the update of lanes not frozen
  kFinish       // root and converged
};

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

// one warp-aggregated atomicOr of `cond` into *flag
__device__ __forceinline__ void vote(bool cond, int32_t* flag) {
  if (__any_sync(0xffffffffu, cond) && (threadIdx.x % 32) == 0)
    atomicOr(flag, 1);
}

// the residual at x = row x_row from nodes 1-2 of `nodes` ([n, nn])
template <int NL, bool DIST>
__device__ __forceinline__ float residual(const LaneInputs& in, LaneRow row,
                                          float dt, int gft, bool frozen,
                                          float x, const float* nodes, int nn,
                                          int i) {
  vicsurf::SurfaceResidual<NL, DIST> r;
  r.init(in, row, dt, gft);
  r.init_fd(in, row, frozen);
  const int64_t base = static_cast<int64_t>(i) * nn;
  return r.fd(x, nodes[base + 1], nodes[base + 2]);
}

template <int NL, bool DIST>
__global__ void fd_eval_kernel(const __grid_constant__ LaneInputs in, float dt,
                               int gft, int frozen, State st, int x_row,
                               int f_row, int need_only, const float* nodes,
                               int nn) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= st.n) return;
  if (need_only && !st.flag(kNeed, i)) return;
  st(f_row, i) = residual<NL, DIST>(in, lane_row(in, i), dt, gft,
                                    frozen != 0, st(x_row, i), nodes, nn, i);
}

// expand_brackets' round: need = f_lo*f_hi >= 0 on active lanes, widened by
// TSTEP on both sides (ops/rootfind.py:40-44)
__global__ void fd_expand_kernel(const __grid_constant__ LaneInputs in,
                                 State st, int32_t* flag) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool need = false;
  if (i < st.n) {
    need = st(kFa, i) * st(kFb, i) >= 0.0f &&
           lane_m(in, vicsurf::kActive, lane_row(in, i));
    st.flag(kNeed, i) = need;
    if (need) {
      st(kA, i) = st(kA, i) - kTstep;
      st(kB, i) = st(kB, i) + kTstep;
    }
  }
  vote(need, flag);
}

// after the expansion: the Brent loop's start (ops/rootfind.py:47-68)
__global__ void fd_init_kernel(const __grid_constant__ LaneInputs in, State st,
                               int32_t* flag) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool live = false;
  if (i < st.n) {
    const bool bracketed = st(kFa, i) * st(kFb, i) < 0.0f &&
                           lane_m(in, vicsurf::kActive, lane_row(in, i));
    st.flag(kBracketed, i) = bracketed;
    st.flag(kDone, i) = !bracketed;
    st(kC, i) = st(kA, i);
    st(kFc, i) = st(kFa, i);
    st(kD, i) = st(kB, i) - st(kA, i);
    st(kE, i) = st(kB, i) - st(kA, i);
    live = bracketed;
  }
  vote(live, flag);
}

// one iteration of batched_brent up to b_next (ops/rootfind.py:73-113), on
// every lane: frozen lanes are rearranged and propose a candidate too
__global__ void fd_propose_kernel(State st, int32_t* flag) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool live = false;
  if (i < st.n) {
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
    const bool done =
        st.flag(kDone, i) || fabsf(m) <= tol_i || fb == 0.0f;
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
    live = !done;
  }
  vote(live, flag);
}

// f(b_next) and the update of the lanes that are neither done nor
// unbracketed (ops/rootfind.py:114-123)
template <int NL, bool DIST>
__global__ void fd_accept_kernel(const __grid_constant__ LaneInputs in,
                                 float dt, int gft, int frozen, State st,
                                 const float* nodes, int nn) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= st.n) return;
  if (st.flag(kDone, i) || !st.flag(kBracketed, i)) return;
  const float b_next = st(kBNext, i);
  const float fb_next = residual<NL, DIST>(in, lane_row(in, i), dt, gft,
                                           frozen != 0, b_next, nodes, nn, i);
  st(kA, i) = st(kB, i);
  st(kFa, i) = st(kFb, i);
  st(kB, i) = b_next;
  st(kFb, i) = fb_next;
  st(kD, i) = st(kDNew, i);
  st(kE, i) = st(kENew, i);
}

// converged where |c - b|/2 <= tol or f(b) == 0; unbracketed or inactive
// lanes return the midpoint of the ORIGINAL bracket (ops/rootfind.py:126-128)
__global__ void fd_finish_kernel(State st, const float* lo, const float* hi,
                                 float* root, uint8_t* converged,
                                 uint8_t* bracketed) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= st.n) return;
  const float b = st(kB, i);
  const bool br = st.flag(kBracketed, i);
  const float tol_f = kEps2 * fabsf(b) + kTol;
  converged[i] =
      br && (fabsf(0.5f * (st(kC, i) - b)) <= tol_f || st(kFb, i) == 0.0f);
  bracketed[i] = br;
  root[i] = br ? b : 0.5f * (lo[i] + hi[i]);
}

template <int NL, bool DIST>
void launch_residual(int op, const LaneInputs& in, float dt, int gft,
                     int frozen, const State& st, const float* nodes, int nn,
                     dim3 grid, cudaStream_t s) {
  switch (op) {
    case kEvalLo:
    case kEvalLoNeed:
      fd_eval_kernel<NL, DIST><<<grid, kBlock, 0, s>>>(
          in, dt, gft, frozen, st, kA, kFa, op == kEvalLoNeed, nodes, nn);
      break;
    case kEvalHi:
    case kEvalHiNeed:
      fd_eval_kernel<NL, DIST><<<grid, kBlock, 0, s>>>(
          in, dt, gft, frozen, st, kB, kFb, op == kEvalHiNeed, nodes, nn);
      break;
    default:
      fd_accept_kernel<NL, DIST><<<grid, kBlock, 0, s>>>(in, dt, gft, frozen,
                                                         st, nodes, nn);
  }
}

}  // namespace

extern "C" {

// nf, nm: the input counts, checked against the residual's; h: lanes per
// cell; nl: soil layers (2 or 3); dist: the dry column is read (DIST_PRCP);
// state: float [11][n]; lane_flags: uint8
// [3][n]; nodes: the profile K6 solved at the op's candidate ([n, nn], the
// residual ops only); flag: the int32 this op's vote goes to (kExpand,
// kInit, kPropose); lo/hi/root/converged/bracketed: [n] (kFinish).
int fd_surface_brent(int op, const void* const* f, const int32_t* f_stride,
                     int nf, const void* const* m, const int32_t* m_stride,
                     int nm, int h, int nl, int dist, float dt,
                     int grnd_flux_type, int frozen, float* state,
                     uint8_t* lane_flags,
                     const float* nodes, int nn, int32_t* flag, int n,
                     const float* lo, const float* hi, float* root,
                     uint8_t* converged, uint8_t* bracketed, void* stream) {
  LaneInputs in{};
  if (n <= 0 ||
      !fill_lane_inputs(&in, f, f_stride, nf,
                        vicsurf::kNumSurfaceIn + vicsurf::kNumFdIn, m,
                        m_stride, nm, vicsurf::kNumSurfaceMask + 1, h))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kBlock - 1) / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const State st{state, lane_flags, n};
  switch (op) {
    case kExpand:
      fd_expand_kernel<<<grid, kBlock, 0, s>>>(in, st, flag);
      break;
    case kInit:
      fd_init_kernel<<<grid, kBlock, 0, s>>>(in, st, flag);
      break;
    case kPropose:
      fd_propose_kernel<<<grid, kBlock, 0, s>>>(st, flag);
      break;
    case kFinish:
      fd_finish_kernel<<<grid, kBlock, 0, s>>>(st, lo, hi, root, converged,
                                               bracketed);
      break;
    case kEvalLo:
    case kEvalHi:
    case kEvalLoNeed:
    case kEvalHiNeed:
    case kAccept:
      if (nn < 3) return static_cast<int>(cudaErrorInvalidValue);
      if (nl == 2 && dist) {
        launch_residual<2, true>(op, in, dt, grnd_flux_type, frozen, st,
                                 nodes, nn, grid, s);
      } else if (nl == 2) {
        launch_residual<2, false>(op, in, dt, grnd_flux_type, frozen, st,
                                  nodes, nn, grid, s);
      } else if (nl == 3 && dist) {
        launch_residual<3, true>(op, in, dt, grnd_flux_type, frozen, st,
                                 nodes, nn, grid, s);
      } else if (nl == 3) {
        launch_residual<3, false>(op, in, dt, grnd_flux_type, frozen, st,
                                  nodes, nn, grid, s);
      } else {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
