// The lake column pieces shared by K10 (lake_open_water.cu) and K11
// (lake_under_ice.cu): one thread holds one lake's MAX_LAKE_NODES = 20
// layers in its own arrays.
//
// Each function is a line-for-line copy of its plain version in
// vic_tpu_torch/physics/lake.py (water_density, specheat, energycalc,
// temp_area, tracer_mixer, iceform), with the same operation order: sums
// over the layers in index order, integer powers as products, divisions of
// a tensor by a host scalar as the product with its float reciprocal
// (div_s) and of a host scalar by a tensor as the tensor's reciprocal times
// the scalar (rdiv_s), as PyTorch computes them on the card. The density
// and heat-capacity polynomials are the fused multiply-add chains that
// vic_tpu's XLA computes (explicit fmaf; the library is otherwise built
// with -fmad=false), which the plain versions emulate.
#pragma once

#include <cmath>
#include <cstdint>

#include "lanes.cuh"
#include "physics.cuh"
#include "thomas.cuh"

namespace vlake {

using namespace vicphys;

constexpr int kNN = 20;                  // MAX_LAKE_NODES
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

// physics.lake.LayerGrid of one lake
struct Column {
  float z[kNN], zhalf[kNN], surface[kNN + 1];
  float surfdz, dz;
  bool mask[kNN], last[kNN];
};

// float inputs z, zhalf (layered, kNN), surface (layered, kNN + 1), surfdz,
// dz at indices iz..iz+4; layered masks mask, last at im, im+1
__device__ __forceinline__ void load_column(const LaneInputs& in, LaneRow r,
                                            int iz, int im, Column* c) {
  for (int k = 0; k < kNN; ++k) {
    c->z[k] = lane_fl(in, iz, r, k);
    c->zhalf[k] = lane_fl(in, iz + 1, r, k);
    c->mask[k] = lane_ml(in, im, r, k);
    c->last[k] = lane_ml(in, im + 1, r, k);
  }
  for (int k = 0; k <= kNN; ++k) c->surface[k] = lane_fl(in, iz + 2, r, k);
  c->surfdz = lane_f(in, iz + 3, r);
  c->dz = lane_f(in, iz + 4, r);
}

// energycalc: thermal energy of the active column (J), layers summed in
// index order
__device__ __forceinline__ float energycalc(const float* t, const Column& c,
                                            const float* cp,
                                            const float* rho) {
  float s = 0.0f;
  for (int k = 0; k < kNN; ++k) {
    const float s_top = c.surface[k];
    const float wt = c.last[k] ? s_top / 2.0f
                               : (s_top + c.surface[k + 1]) / 2.0f;
    const float e = (t[k] + kKelvin) * c.z[k] * (1.0e3f + rho[k]) * cp[k] *
                    wt;
    const float term = c.mask[k] ? e : 0.0f;
    s = k == 0 ? term : s + term;
  }
  return s;
}

// temp_area for a column whose matrix and right-hand side are fixed but for
// the surface force: init() forms everything else once, solve() the column
// for one surface force. The same values as temp_area's, in its order.
struct TempArea {
  float temp[kNN];
  float rhs[kNN];          // d_rhs of layers >= 1; layer 0's parts below
  float t1_0, s_top0, s_avg0, heat_cap0, cn0;
  float dt, e_bot;
  bool mask[kNN];
  ThomasFactor<kNN> f;

  __device__ void init(const float* t, const float* rho, const float* cp,
                       const float* de, float swv, float swn, float dt_sec,
                       const Column& c) {
    dt = dt_sec;
    e_bot = 0.0f;
    const bool multi = c.mask[1];   // numnod > 1
    float s_bot[kNN], s_avg[kNN], t1[kNN], cn[kNN];
    float dl[kNN], dd[kNN], du[kNN];
    for (int k = 0; k < kNN; ++k) {
      temp[k] = t[k];
      mask[k] = c.mask[k];
      const float s_top = c.surface[k];
      const bool lm = c.last[k] && multi;
      s_bot[k] = lm ? s_top : c.surface[k + 1];
      s_avg[k] = nan_max(lm ? s_top : (s_top + s_bot[k]) / 2.0f, kSmall);
      const float kf = static_cast<float>(k);
      const float top = k == 0 ? 0.0f : c.surfdz + (kf - 1.0f) * c.dz;
      const float bot = k == 0 ? c.surfdz : c.surfdz + kf * c.dz;
      t1[k] = (swv * (s_top * expf(-kLamWSW * top) -
                      s_bot[k] * expf(-kLamWSW * bot)) +
               swn * (s_top * expf(-kLamWLW * top) -
                      s_bot[k] * expf(-kLamWLW * bot))) /
              s_avg[k];
      if (c.last[k]) {
        // energy out of the bottom of the deepest active node
        e_bot = s_top * (swv * expf(-kLamWSW * bot) +
                         swn * expf(-kLamWLW * bot)) /
                nan_max(c.surface[0], kSmall);
      }
    }
    for (int k = 0; k < kNN; ++k) {
      const bool interior = c.mask[k] && !c.last[k];
      float term1 = 0.0f, term2 = 0.0f, b_sup = 0.0f, c_sub = 0.0f;
      if (k < kNN - 1) {
        const float g = de[k] / c.zhalf[k];
        const float dT = t[k + 1] - t[k];
        if (interior) {
          term1 = 0.5f * g * dT / c.z[k] * s_bot[k] / s_avg[k];
          b_sup = -0.5f * g * rdiv_s(dt, c.z[k]) * s_bot[k] / s_avg[k];
        }
      }
      if (k > 0 && c.mask[k]) {
        const float g = de[k - 1] / c.zhalf[k - 1];
        const float dT = t[k] - t[k - 1];
        term2 = -0.5f * g * dT / c.z[k] * c.surface[k] / s_avg[k];
        c_sub = -0.5f * g * rdiv_s(dt, c.z[k]) * c.surface[k] / s_avg[k];
      }
      cn[k] = term1 + term2;
      dl[k] = c_sub;
      du[k] = b_sup;
      dd[k] = 1.0f - b_sup - c_sub;
      const float heat_cap = (1.0e3f + rho[k]) * cp[k] * c.z[k];
      if (k == 0) heat_cap0 = heat_cap;
      rhs[k] = c.mask[k] ? temp[k] + t1[k] * dt / heat_cap + cn[k] * dt
                         : temp[k];
    }
    t1_0 = t1[0];
    s_top0 = c.surface[0];
    s_avg0 = s_avg[0];
    cn0 = cn[0];
    thomas_factor<kNN>(dl, dd, du, &f);
  }

  // the column after one step under surface force sf (W/m^2)
  __device__ void solve(float sf, float* t_new) const {
    float b[kNN];
    const float t1 = t1_0 + sf * s_top0 / s_avg0;
    b[0] = mask[0] ? temp[0] + t1 * dt / heat_cap0 + cn0 * dt : temp[0];
    for (int k = 1; k < kNN; ++k) b[k] = rhs[k];
    thomas_apply<kNN>(f, b, t_new);
    for (int k = 0; k < kNN; ++k) t_new[k] = mask[k] ? t_new[k] : temp[k];
  }
};

// tracer_mixer: red-black heat-conserving mixing of density-unstable pairs.
// Pairs of one parity are disjoint, so mixing them in place in index order
// reads each pair's start-of-pass densities, as the batched passes do.
__device__ __forceinline__ void tracer_mix(float* t, const Column& c,
                                           const float* cp) {
  float s_node[kNN];
  for (int k = 0; k < kNN; ++k) s_node[k] = nan_max(c.surface[k], kSmall);
  for (int sweep = 0; sweep < kMixSweeps; ++sweep) {
    for (int par = 0; par < 2; ++par) {
      for (int k = par; k < kNN - 1; k += 2) {
        if (!c.mask[k + 1]) continue;
        const float r0 = water_density(t[k]);
        const float r1 = water_density(t[k + 1]);
        if (!(r0 > r1)) continue;
        const float h0 = c.z[k] * (1.0e3f + r0) * cp[k] * s_node[k];
        const float h1 =
            c.z[k + 1] * (1.0e3f + r1) * cp[k + 1] * s_node[k + 1];
        const float tav =
            (t[k] * h0 + t[k + 1] * h1) / nan_max(h0 + h1, kSmall);
        t[k] = tav;
        t[k + 1] = tav;
      }
    }
  }
}

struct Iceform {
  float qfusion, areaadd, new_ice_height, new_ice_water_eq;
};

// iceform: supercooled layers clamped at tcutoff (in place in t) and the
// ice they make
__device__ __forceinline__ Iceform iceform(float* t, float tcutoff,
                                           float fracprv, float dt,
                                           const Column& c, const float* cp,
                                           float lvolume) {
  float ssum = 0.0f;
  for (int k = 0; k < kNN; ++k) {
    const float wt = c.last[k] ? c.surface[k]
                               : (c.surface[k] + c.surface[k + 1]) / 2.0f;
    const bool cold = t[k] < tcutoff && c.mask[k];
    const float extra = cold ? (tcutoff - t[k]) * c.z[k] * kRhoW * cp[k] *
                                   (1.0f - fracprv) * wt
                             : 0.0f;
    ssum = k == 0 ? extra : ssum + extra;
    if (cold) t[k] = tcutoff;
  }
  const float s0 = c.surface[0];
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

}  // namespace vlake
