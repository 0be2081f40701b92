// The lake column pieces shared by K10 (lake_open_water.cu) and K11
// (lake_under_ice.cu): one warp holds one lake, layer k of its
// MAX_LAKE_NODES = 20 on lane k, in registers (its tridiagonal rows also in
// the warp's shared memory). Lanes 20-31 hold neutral
// values (an inactive layer of unit thickness) and only take part in the
// shuffles; nothing of theirs enters a result.
//
// Each function is a line-for-line copy of its plain version in
// vic_tpu_torch/physics/lake.py (water_density, specheat, energycalc,
// temp_area, tracer_mixer, iceform), with the same operation order, so a
// lake's results do not depend on which lane forms what:
// - per-layer values are formed on the layer's own lane, a neighbour's
//   taken by shuffle (the same bits as forming them again);
// - sums over the layers add in index order from the first term, each
//   lane's term broadcast in turn (no tree);
// - the Thomas elimination and substitution keep the plain version's
//   recurrences (ops/tridiag.py) and true divisions: each lane writes its
//   layer's row to the warp's shared memory and lane 0 runs the recurrences
//   over the rows;
// - integer powers are products, a tensor divided by a host scalar is the
//   product with its float reciprocal (div_s) and a host scalar divided by
//   a tensor the tensor's reciprocal times the scalar (rdiv_s), as PyTorch
//   computes them on the card;
// - the density and heat-capacity polynomials are the fused multiply-add
//   chains vic_tpu's XLA computes (explicit fmaf; the library is otherwise
//   built with -fmad=false), which the plain versions emulate.
// Every value a warp branches on (the fixed point's test, a mix's vote) is
// the same on all its lanes, so a lake's control flow is the warp's.
//
// Blocks are persistent (lake_grid: as many as the device keeps resident,
// at most one per kLakeWarps lakes), each owning a contiguous chunk of the
// lakes; a warp takes the next lake of its block's chunk from a counter in
// shared memory (for_each_lake), so an inactive lake is written at once and
// holds its warp no longer than that.
#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "lanes.cuh"
#include "physics.cuh"

namespace vlake {

using namespace vicphys;

constexpr unsigned kAll = 0xffffffffu;
constexpr int kNN = 20;                  // MAX_LAKE_NODES
constexpr int kLakeBlock = 128;
constexpr int kLakeWarps = kLakeBlock / 32;
constexpr float kSmall = 1.0e-12f;
constexpr float kVonK = 0.40f;          // von Karman constant
constexpr float kDM = 1.38889e-07f;      // molecular diffusivity (m^2/s)
constexpr float kLamWSW = 0.3f;          // SW extinction in water, visible
constexpr float kLamWLW = 1.4f;          // SW extinction in water, NIR
constexpr float kA1 = 0.7f;
constexpr float kA2 = 0.3f;
constexpr float kEbEps = 1.0e-4f;
constexpr int kEbMaxIter = 50;
constexpr int kMixSweeps = kNN;
constexpr float kRhoIce = 917.0f;
constexpr float kFracMin = 0.10f;
// python-constant products evaluate in double before the float32 op
constexpr float kRhoWLf = static_cast<float>(999.842594 * 3.337e5);
constexpr float kLfRhoIce = static_cast<float>(3.337e5 * 917.0);

__device__ __forceinline__ float water_density(float t) {
  const float t2 = t * t;
  const float t4 = t2 * t2;
  float r = fmaf(static_cast<float>(6.793952e-2), t,
                 static_cast<float>(999.842594));
  r = fmaf(static_cast<float>(-9.095290e-3), t2, r);
  r = fmaf(static_cast<float>(1.001685e-4), t * t2, r);
  r = fmaf(static_cast<float>(-1.120083e-6), t4, r);
  r = fmaf(static_cast<float>(6.536332e-9), t * t4, r);
  return r - 1000.0f;
}

__device__ __forceinline__ float specheat(float t) {
  const float t2 = t * t;
  float r = fmaf(static_cast<float>(-3.720283), t, static_cast<float>(4217.4));
  r = fmaf(static_cast<float>(0.1412855), t2, r);
  r = fmaf(static_cast<float>(-2.654387e-3), t * t2, r);
  return fmaf(static_cast<float>(2.093236e-5), t2 * t2, r);
}

// v of lane `from`, on every lane
__device__ __forceinline__ float bcast(float v, int from) {
  return __shfl_sync(kAll, v, from);
}

// the sum of the layers' terms (lanes 0..kNN-1) in index order from the
// first, on every lane
__device__ __forceinline__ float ordered_sum(float term) {
  float s = bcast(term, 0);
#pragma unroll
  for (int k = 1; k < kNN; ++k) s = s + bcast(term, k);
  return s;
}

// physics.lake.LayerGrid of one lake, layer k on lane k
struct Layer {
  int k;                        // the lane: the layer's index
  float z, zhalf, s_top, s_next;   // z, zhalf, surface[k], surface[k + 1]
  bool mask, last;
  unsigned masks;               // bit j: layer j active
  float surfdz, dz, surface0;   // the lake's, on every lane
};

// float inputs z, zhalf (layered, kNN), surface (layered, kNN + 1), surfdz,
// dz at indices iz..iz+4; layered masks mask, last at im, im+1
__device__ __forceinline__ Layer load_layer(const LaneInputs& in, LaneRow r,
                                            int iz, int im, int k) {
  Layer l{};
  l.k = k;
  if (k < kNN) {
    l.z = lane_fl(in, iz, r, k);
    l.zhalf = lane_fl(in, iz + 1, r, k);
    l.s_top = lane_fl(in, iz + 2, r, k);
    l.s_next = lane_fl(in, iz + 2, r, k + 1);
    l.mask = lane_ml(in, im, r, k);
    l.last = lane_ml(in, im + 1, r, k);
  } else {
    l.z = 1.0f;
    l.zhalf = 1.0f;
  }
  l.masks = __ballot_sync(kAll, l.mask);
  l.surfdz = lane_f(in, iz + 3, r);
  l.dz = lane_f(in, iz + 4, r);
  l.surface0 = bcast(l.s_top, 0);
  return l;
}

// energycalc: thermal energy of the active column (J), layers summed in
// index order
__device__ __forceinline__ float energycalc(float t, const Layer& l, float cp,
                                            float rho) {
  const float wt = l.last ? l.s_top / 2.0f : (l.s_top + l.s_next) / 2.0f;
  const float e = (t + kKelvin) * l.z * (1.0e3f + rho) * cp * wt;
  return ordered_sum(l.mask ? e : 0.0f);
}

// A warp's tridiagonal system in shared memory: row i's pivot m (the
// diagonal before the elimination), sub-diagonal dl, right-hand side rhs
// and c' (the super-diagonal before the elimination) as one float4, and
// the forward substitution's, then the solution's, value x[i].
struct Rows {
  float4 row[kNN];   // m, dl, rhs, c'
  float x[kNN];
};

// temp_area for a column whose matrix and right-hand side are fixed but for
// the surface force: init() forms everything else once, its elimination
// included, solve() the column for one surface force, of which only the
// first row's right-hand side depends. The same values as temp_area's, in
// its order: each lane forms its layer's row, and the Thomas recurrences
// (ops/tridiag.py's, with true divisions) run on lane 0 over the warp's
// Rows.
struct TempArea {
  Rows* rows;
  float temp;              // the lane's layer at the start
  float temp0, t1_0, s_top0, s_avg0, heat_cap0, cn0;   // layer 0's
  float dt, e_bot;
  bool mask, mask0;

  __device__ void init(float t, float rho, float cp, float de, float swv,
                       float swn, float dt_sec, const Layer& l, Rows* r) {
    rows = r;
    dt = dt_sec;
    temp = t;
    mask = l.mask;
    const bool multi = (l.masks >> 1) & 1u;   // numnod > 1
    const float s_top = l.s_top;
    const bool lm = l.last && multi;
    const float s_bot = lm ? s_top : l.s_next;
    const float s_avg = nan_max(lm ? s_top : (s_top + s_bot) / 2.0f, kSmall);
    const float kf = static_cast<float>(l.k);
    const float top = l.k == 0 ? 0.0f : l.surfdz + (kf - 1.0f) * l.dz;
    const float bot = l.k == 0 ? l.surfdz : l.surfdz + kf * l.dz;
    const float t1 = (swv * (s_top * expf(-kLamWSW * top) -
                             s_bot * expf(-kLamWSW * bot)) +
                      swn * (s_top * expf(-kLamWLW * top) -
                             s_bot * expf(-kLamWLW * bot))) /
                     s_avg;
    // energy out of the bottom of the deepest active node (the last layer
    // flagged, as the serial loop's last assignment)
    const float eb = s_top * (swv * expf(-kLamWSW * bot) +
                              swn * expf(-kLamWLW * bot)) /
                     nan_max(l.surface0, kSmall);
    const unsigned lasts = __ballot_sync(kAll, l.last);
    const float eb_last =
        bcast(eb, lasts ? 31 - __clz(static_cast<int>(lasts)) : 0);
    e_bot = lasts ? eb_last : 0.0f;

    // interface k's conductance, and the neighbours' values
    const float g = de / l.zhalf;
    const float t_below = __shfl_down_sync(kAll, t, 1);
    const float t_above = __shfl_up_sync(kAll, t, 1);
    const float g_above = __shfl_up_sync(kAll, g, 1);
    const bool interior = l.mask && !l.last;
    float term1 = 0.0f, term2 = 0.0f, b_sup = 0.0f, c_sub = 0.0f;
    if (l.k < kNN - 1 && interior) {
      const float dT = t_below - t;
      term1 = 0.5f * g * dT / l.z * s_bot / s_avg;
      b_sup = -0.5f * g * rdiv_s(dt, l.z) * s_bot / s_avg;
    }
    if (l.k > 0 && l.mask) {
      const float dT = t - t_above;
      term2 = -0.5f * g_above * dT / l.z * s_top / s_avg;
      c_sub = -0.5f * g_above * rdiv_s(dt, l.z) * s_top / s_avg;
    }
    const float cn = term1 + term2;
    const float heat_cap = (1.0e3f + rho) * cp * l.z;
    temp0 = bcast(t, 0);
    t1_0 = bcast(t1, 0);
    s_top0 = l.surface0;
    s_avg0 = bcast(s_avg, 0);
    cn0 = bcast(cn, 0);
    heat_cap0 = bcast(heat_cap, 0);
    mask0 = l.masks & 1u;
    if (l.k < kNN)
      r->row[l.k] = make_float4(
          1.0f - b_sup - c_sub, c_sub,
          l.mask ? t + t1 * dt / heat_cap + cn * dt : t, b_sup);
    __syncwarp();
    if (l.k == 0) {
      // the elimination (each row's pivot and c'), each row read a step
      // ahead
      float cp_prev = 0.0f;
      float4 cur = r->row[0];
#pragma unroll
      for (int i = 0; i < kNN; ++i) {
        const float4 next = r->row[i + 1 < kNN ? i + 1 : i];
        const float mi = cur.x - cur.y * cp_prev;
        cp_prev = cur.w / mi;
        r->row[i].x = mi;
        r->row[i].w = cp_prev;
        cur = next;
      }
    }
    __syncwarp();
  }

  // the lane's layer after one step under surface force sf (W/m^2)
  __device__ float solve(float sf, int k) const {
    Rows* r = rows;
    if (k == 0) {
      const float t1 = t1_0 + sf * s_top0 / s_avg0;
      const float b0 =
          mask0 ? temp0 + t1 * dt / heat_cap0 + cn0 * dt : temp0;
      // forward and back substitution (d', then x), each row read a
      // step ahead
      float dp_prev = 0.0f;
      float4 cur = r->row[0];
#pragma unroll
      for (int i = 0; i < kNN; ++i) {
        const float4 next = r->row[i + 1 < kNN ? i + 1 : i];
        dp_prev = ((i == 0 ? b0 : cur.z) - cur.y * dp_prev) / cur.x;
        r->x[i] = dp_prev;
        cur = next;
      }
      float x_next = 0.0f;
#pragma unroll
      for (int i = kNN - 1; i >= 0; --i) {
        x_next = r->x[i] - r->row[i].w * x_next;
        r->x[i] = x_next;
      }
    }
    __syncwarp();
    const float x = k < kNN ? r->x[k] : 0.0f;
    __syncwarp();
    return mask ? x : temp;
  }
};

// tracer_mixer: red-black heat-conserving mixing of density-unstable pairs
// on the warp's column t (lane k: layer k). In a pass of parity par, lane k
// (k % 2 == par) takes the pair (k, k+1) with layer k+1's values by
// shuffle and hands its mean back; the pairs of a pass are disjoint, so
// this is the serial loop's result. A sweep that mixes no pair leaves the
// column as it was, and so would every later sweep: the mix stops there,
// with the bits of all kMixSweeps sweeps.
__device__ __forceinline__ void tracer_mix(float& t, const Layer& l,
                                           float cp) {
  const float s_node = nan_max(l.s_top, kSmall);
  const bool pair = l.k < kNN - 1 && ((l.masks >> (l.k + 1)) & 1u);
  for (int sweep = 0; sweep < kMixSweeps; ++sweep) {
    bool mixed = false;
#pragma unroll
    for (int par = 0; par < 2; ++par) {
      const float r0 = water_density(t);
      const float h0 = l.z * (1.0e3f + r0) * cp * s_node;
      const float t1 = __shfl_down_sync(kAll, t, 1);
      const float r1 = __shfl_down_sync(kAll, r0, 1);
      const float h1 = __shfl_down_sync(kAll, h0, 1);
      const bool mix = pair && (l.k & 1) == par && r0 > r1;
      const float tav = (t * h0 + t1 * h1) / nan_max(h0 + h1, kSmall);
      const float tav_above = __shfl_up_sync(kAll, tav, 1);
      const unsigned mixes = __ballot_sync(kAll, mix);
      const bool mix_above = l.k > 0 && ((mixes >> (l.k - 1)) & 1u);
      if (mix || mix_above) t = mix ? tav : tav_above;
      mixed = mixed || mix;
    }
    if (!__any_sync(kAll, mixed)) return;
  }
}

struct Iceform {
  float qfusion, areaadd, new_ice_height, new_ice_water_eq;
};

// iceform: supercooled layers clamped at tcutoff (in place in t) and the
// ice they make
__device__ __forceinline__ Iceform iceform(float& t, float tcutoff,
                                           float fracprv, float dt,
                                           const Layer& l, float cp,
                                           float lvolume) {
  const float wt = l.last ? l.s_top : (l.s_top + l.s_next) / 2.0f;
  const bool cold = t < tcutoff && l.mask;
  const float extra = cold ? (tcutoff - t) * l.z * kRhoW * cp *
                                 (1.0f - fracprv) * wt
                           : 0.0f;
  const float ssum = ordered_sum(extra);
  if (cold) t = tcutoff;
  const float s0 = l.surface0;
  float new_iwe = div_s(ssum, kRhoWLf);
  const float denom = dt * nan_max(s0 * (1.0f - fracprv), kSmall);
  const bool have_water = lvolume > new_iwe;
  const bool some_water = lvolume > 0.0f;
  new_iwe = have_water ? new_iwe : (some_water ? lvolume : 0.0f);
  const float melt_we = div_s(new_iwe * kRhoW, kRhoIce);
  const float di = have_water ? div_s(ssum, kLfRhoIce)
                              : (some_water ? melt_we : 0.0f);
  const float qfusion = have_water ? ssum / denom
                                   : (some_water ? melt_we / denom : 0.0f);
  float areaadd = div_s(di, kFracMin);
  const float cap = (1.0f - fracprv) * s0;
  const float new_hi = areaadd > cap ? di / nan_max(cap, kSmall) : kFracMin;
  areaadd = nan_min(areaadd, cap);
  return Iceform{qfusion, areaadd, new_hi, new_iwe};
}

// Calls body(lake, lane, rows) on each lake of the block's chunk
// [blockIdx.x * chunk, ...) of the n lakes, one lake a warp at a time, the
// warps taking lakes from a shared counter as they finish; rows: the
// warp's Rows.
template <class Body>
__device__ __forceinline__ void for_each_lake(int n, int chunk, Body body) {
  __shared__ int next_lake;
  __shared__ Rows rows[kLakeWarps];
  const int first = blockIdx.x * chunk;
  const int end = min(first + chunk, n);
  if (threadIdx.x == 0) next_lake = first;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  while (true) {
    int i = 0;
    if (lane == 0) i = atomicAdd(&next_lake, 1);
    i = __shfl_sync(kAll, i, 0);
    if (i >= end) break;
    body(i, lane, &rows[threadIdx.x >> 5]);
  }
}

// The grid of a kernel on for_each_lake over n lakes: the blocks the
// device keeps resident (the occupancy query made once a device into
// resident[], of kMaxDevices), at most one per kLakeWarps lakes, and the
// lakes a block owns. Returns a CUDA error, cudaErrorInvalidConfiguration
// where no block fits on an SM.
constexpr int kMaxDevices = 64;
inline int lake_grid(const void* kernel, int n, int* resident, int* blocks,
                     int* chunk) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kLakeBlock, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident[dev] = per_sm * sms;
  }
  const int needed = (n + kLakeWarps - 1) / kLakeWarps;
  *blocks = resident[dev] < needed ? resident[dev] : needed;
  *chunk = (n + *blocks - 1) / *blocks;
  return 0;
}

}  // namespace vlake
