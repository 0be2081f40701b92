// K6 node_sweep: the frozen-soil Gauss-Seidel node sweep, for sm_90a (H100).
//
// Replaces vic_tpu/physics/frozen_soil.py:311 (solve_t_profile_explicit:
// the sweep while_loop :570 with the 16-step bisection fori_loop :523 of
// the nodes below the soil layers). It runs inside every residual
// evaluation of the frozen step's surface Brent, over all [n_cell, max_hru]
// lanes of a [.., nn] node profile.
//
// The sweep loop ends batch-wide: another sweep runs while any lane of the
// whole batch moved more than 1e-2 C in the last one (jnp.max over the
// batch; a NaN anywhere stops it), up to max_sweeps, and converged lanes
// keep sweeping meanwhile. A per-lane stopping rule would move node
// temperatures by up to ~1e-2 C, so the batch's decision is reproduced on
// the device without a host sync: launch k sweeps every lane once (one
// thread per lane, its nn temperatures in registers), reduces the lanes'
// largest change per block and folds it into slot k with an atomicMax on the
// float's bits (changes are >= 0, so the int order is the float order; NaN
// goes to a flag of its own); launch k+1 reads slots 0..k and returns at
// once if the loop has ended. A last launch applies the cold-nose fix and
// the revert and writes the sweep count. Each lane reads ~5 x nn floats
// and its cell's 7 x nn geometry floats per sweep and does up to ~30
// residual evaluations with a powf each per sweep: bound by latency, not
// by bytes.
//
// C interface for ctypes: returns the first launch error (0 = launched).

#include <cuda_runtime.h>

#include <cstdint>

#include "node_sweep.cuh"

namespace {

using vicnode::SweepArgs;

constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;

// whether sweep k runs: every earlier sweep ran and left a batch max above
// the tolerance with no NaN
__device__ __forceinline__ bool sweep_runs(const SweepArgs& a, int k) {
  for (int s = 0; s < k; ++s) {
    if (a.sweep_nan[s] != 0 ||
        !(__int_as_float(a.sweep_max[s]) > vicnode::kSweepTol))
      return false;
  }
  return k < a.max_sweeps;
}

template <int NN>
__global__ void __launch_bounds__(kBlock)
    node_sweep_kernel(SweepArgs a, int k) {
  if (!sweep_runs(a, k)) return;   // the same answer on every thread
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float diff = 0.0f;
  if (i < a.n) {
    vicnode::NodeLane<NN> lane;
    lane.load(a, i);
    float T[NN];
    int32_t fb[NN];
    const int64_t base = static_cast<int64_t>(i) * NN;
    if (k == 0) {
      vicnode::initial_profile<NN>(a, i, T);
#pragma unroll
      for (int j = 0; j < NN; ++j) fb[j] = 0;
    } else {
#pragma unroll
      for (int j = 0; j < NN; ++j) {
        T[j] = a.t_work[base + j];
        fb[j] = a.fb_work[base + j];
      }
    }
    diff = lane.sweep(T, fb, a.nlayer, a.noflux != 0);
#pragma unroll
    for (int j = 0; j < NN; ++j) {
      a.t_work[base + j] = T[j];
      a.fb_work[base + j] = fb[j];
    }
    a.lastdiff[i] = diff;
  }
  // block max of the lanes' changes, NaN apart
  const bool nan = diff != diff;
  float v = nan ? 0.0f : diff;
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
    atomicMax(&a.sweep_max[k], __float_as_int(m));
    if (bad) atomicExch(&a.sweep_nan[k], 1);
  }
}

template <int NN>
__global__ void __launch_bounds__(kBlock) node_finish_kernel(SweepArgs a) {
  int sweeps = 0;
  while (sweeps < a.max_sweeps && sweep_runs(a, sweeps)) ++sweeps;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) a.sweeps[0] = sweeps;
  if (i >= a.n) return;
  float T[NN];
  int32_t fb[NN];
  const int64_t base = static_cast<int64_t>(i) * NN;
  float lastdiff = 1.0f;   // no sweep ran: the loop's initial difference
  if (sweeps == 0) {
    vicnode::initial_profile<NN>(a, i, T);
#pragma unroll
    for (int j = 0; j < NN; ++j) fb[j] = 0;
  } else {
#pragma unroll
    for (int j = 0; j < NN; ++j) {
      T[j] = a.t_work[base + j];
      fb[j] = a.fb_work[base + j];
    }
    lastdiff = a.lastdiff[i];
  }
  vicnode::finish_profile<NN>(a, i, T, fb, lastdiff);
#pragma unroll
  for (int j = 0; j < NN; ++j) {
    a.t_out[base + j] = T[j];
    a.fb_out[base + j] = fb[j];
  }
}

template <int NN>
int launch_all(const SweepArgs& a, cudaStream_t s) {
  const dim3 grid((a.n + kBlock - 1) / kBlock);
  for (int k = 0; k < a.max_sweeps; ++k) {
    node_sweep_kernel<NN><<<grid, kBlock, 0, s>>>(a, k);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  node_finish_kernel<NN><<<grid, kBlock, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// lane: t0, kappa, cs, moist, ice0 ([n, nn]); geom: alpha, beta, gamma,
// e_coef, solver_max_moist, solver_bubble, solver_expt ([n_cell, nn]);
// work: t_work (float [n, nn]), fb_work (int32 [n, nn]), lastdiff (float
// [n]), sweep_max and sweep_nan (int32 [max_sweeps] each, zeroed here).
int node_sweep(const void* const* lane, const void* const* geom,
               const float* surf_temp, const uint8_t* fs_active, int n, int h,
               int nn, int nlayer, int frozen, int noflux, int max_sweeps,
               float dt, float two_dt, void* t_work, void* fb_work,
               void* lastdiff, void* sweep_max, void* sweep_nan,
               float* t_out, int32_t* fb_out, int32_t* sweeps,
               void* stream) {
  if (n <= 0 || h <= 0 || max_sweeps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SweepArgs a{};
  a.t0 = static_cast<const float*>(lane[0]);
  a.kappa = static_cast<const float*>(lane[1]);
  a.cs = static_cast<const float*>(lane[2]);
  a.moist = static_cast<const float*>(lane[3]);
  a.ice0 = static_cast<const float*>(lane[4]);
  a.alpha = static_cast<const float*>(geom[0]);
  a.beta = static_cast<const float*>(geom[1]);
  a.gamma = static_cast<const float*>(geom[2]);
  a.e_coef = static_cast<const float*>(geom[3]);
  a.solver_max_moist = static_cast<const float*>(geom[4]);
  a.solver_bubble = static_cast<const float*>(geom[5]);
  a.solver_expt = static_cast<const float*>(geom[6]);
  a.surf_temp = surf_temp;
  a.fs_active = fs_active;
  a.n = n;
  a.h = h;
  a.nlayer = nlayer;
  a.frozen = frozen;
  a.noflux = noflux;
  a.max_sweeps = max_sweeps;
  a.dt = dt;
  a.two_dt = two_dt;
  a.t_work = static_cast<float*>(t_work);
  a.fb_work = static_cast<int32_t*>(fb_work);
  a.lastdiff = static_cast<float*>(lastdiff);
  a.sweep_max = static_cast<int32_t*>(sweep_max);
  a.sweep_nan = static_cast<int32_t*>(sweep_nan);
  a.t_out = t_out;
  a.fb_out = fb_out;
  a.sweeps = sweeps;
  if (max_sweeps > 0) {
    cudaError_t err =
        cudaMemsetAsync(sweep_max, 0, sizeof(int32_t) * max_sweeps, s);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(sweep_nan, 0, sizeof(int32_t) * max_sweeps, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // built for kernels.SWEEP_NNODE only: the frozen configuration's 5 nodes
  if (nn != 5) return static_cast<int>(cudaErrorInvalidValue);
  return launch_all<5>(a, s);
}

}  // extern "C"
