// A lake basin's geometry and its volume -> depth solve, shared by K13
// (lake_depth.cu) and the lakes' water balance (lake_water_balance.cu).
//
// physics.lake's area_from_depth, volume_from_depth and
// depth_from_volume_plain (vic_tpu/physics/lake.py:171-217): the area at a
// depth is linear inside the trapezoid that holds it; the volume below a
// depth is the full layers under it, summed in index order, plus the
// partial trapezoid at the surface; the depth of a volume is 30 bisection
// steps on that curve from [0, maxdepth]. Each step took ~150 dependent
// operations (both functions walked all 20 trapezoids); here it takes two
// searches of the levels (5 steps at most, fewer as the bracket narrows to
// one trapezoid) and one trapezoid:
//
// - z falls with k, so the full layers (d >= z[k]) are a suffix k0..19 and
//   their index-order sum is the left-to-right sum from k0, whatever the
//   leading zeros added before it. Each lake precomputes those 20 sums
//   once (`full[k0]`, each summed left to right as the plain version sums
//   them).
// - The partial trapezoid (z[k+1] < d < z[k]) can only be k0 - 1, and the
//   area's trapezoid (z[k+1] < d <= z[k]) only j - 1, j the first of the
//   levels z[1..20] below d: binary searches over the levels find both, and
//   each layer's own test is then made exactly as the plain version makes
//   it, so a search that lands on a layer whose test fails gives the
//   plain version's 0. The edges stay the plain version's: d >= z[k] for
//   a full layer, z[k+1] < d < z[k] for the partial one, z[k+1] < d <=
//   z[k] for the area, d >= z[0] -> basin[0] and d <= 0 -> 0; a NaN depth
//   fails every test (area and volume 0), and a NaN volume never compares
//   high, as in the plain version.
// - The searches need levels that fall with k and hold no NaN;
//   physics.lake.check_basin refuses any other basin when the lake
//   parameters load and when the step is built.
//
// The per-lake tables (21 depths, 21 areas, 20 full-layer sums: 248 B a
// lake) live in shared memory, element k of the block's thread t at
// [k][t], so the searches' indexed loads hit consecutive banks; registers
// cannot be indexed by a run-time index.
#pragma once

#include "physics.cuh"

namespace lakebasin {

using vicphys::nan_max;

constexpr int kLevels = 21;     // MAX_LAKE_NODES + 1
constexpr int kLayers = kLevels - 1;
constexpr int kDepthIters = 30;
constexpr int kTable = 2 * kLevels + kLayers;   // floats a lake

// the shared table of a block of kBlock threads
template <int kBlock>
using Table = float[kTable][kBlock];

template <int kBlock>
struct Basin {
  float (*t)[kBlock];
  int lane;

  __device__ float z(int k) const { return t[k][lane]; }
  __device__ float b(int k) const { return t[kLevels + k][lane]; }
  __device__ float full(int k) const { return t[2 * kLevels + k][lane]; }

  // physics.lake.volume_from_depth's layer_vol of trapezoid k
  __device__ float layer_vol(int k) const {
    return (z(k) - z(k + 1)) * (b(k) + b(k + 1)) / 2.0f;
  }

  // stores the lake's levels and areas (zk(k), bk(k)) and its full-layer
  // sums; to be called by the thread of `lane_` before any other member
  template <class Z, class B>
  __device__ void load(Table<kBlock>& table, int lane_, Z zk, B bk) {
    t = table;
    lane = lane_;
    for (int k = 0; k < kLevels; ++k) {
      t[k][lane] = zk(k);
      t[kLevels + k][lane] = bk(k);
    }
    for (int k0 = 0; k0 < kLayers; ++k0) {
      float s = layer_vol(k0);
      for (int k = k0 + 1; k < kLayers; ++k) s = s + layer_vol(k);
      t[2 * kLevels + k0][lane] = s;
    }
  }

  // the first level k in [lo, hi) that is not z(k) >= d (kStrict: not
  // z(k) > d), else hi; the levels fall, so those before it all are
  template <bool kStrict>
  __device__ int first_below(float d, int lo, int hi) const {
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      const float zm = z(mid);
      if (kStrict ? zm > d : zm >= d)
        lo = mid + 1;
      else
        hi = mid;
    }
    return lo;
  }

  // the area of trapezoid k at depth d, 0 unless z(k+1) < d <= z(k)
  __device__ float trapezoid_area(int k, float d) const {
    if (!(d <= z(k) && d > z(k + 1))) return 0.0f;
    const float w = (d - z(k + 1)) / nan_max(z(k) - z(k + 1), 1e-10f);
    return b(k + 1) + w * (b(k) - b(k + 1));
  }

  // the partial trapezoid k's volume below d, 0 unless z(k+1) < d < z(k)
  __device__ float partial_vol(int k, float d, float a_surf) const {
    if (!(d > z(k + 1) && d < z(k))) return 0.0f;
    const float h = nan_max(d - z(k + 1), 0.0f);
    return h * (a_surf + b(k + 1)) / 2.0f;
  }

  // the levels' indices the area and volume at d take: the
  // first of the levels 1..20 below d (z(1..j-1) >= d > z(j)) and the
  // first full layer (z(0..k0-1) > d); searched in [from.j, to.j] and
  // [from.k0, to.k0], which hold them when d lies between the depths
  // `from` and `to` were found at (to the deeper)
  struct Levels {
    int j, k0;
  };
  __device__ Levels levels(float d, Levels from, Levels to) const {
    return Levels{first_below<false>(d, to.j, from.j),
                  first_below<true>(d, to.k0, from.k0)};
  }
  __device__ Levels levels(float d) const {
    return levels(d, Levels{kLevels, kLayers}, Levels{1, 0});
  }

  // physics.lake.area_from_depth, at the levels of d
  __device__ float area(float d, Levels lv) const {
    float a = lv.j < kLevels ? trapezoid_area(lv.j - 1, d) : 0.0f;
    a = d >= z(0) ? b(0) : a;
    return d <= 0.0f ? 0.0f : a;
  }
  __device__ float area(float d) const {
    return area(d, levels(d));
  }

  // physics.lake.volume_from_depth at the levels of d, each sum in index
  // order
  __device__ float volume(float d, Levels lv) const {
    const float a_surf = area(d, lv);
    const float full_v =
        lv.k0 < kLayers && d >= z(lv.k0) ? full(lv.k0) : 0.0f;
    const float part = lv.k0 > 0 ? partial_vol(lv.k0 - 1, d, a_surf) : 0.0f;
    return full_v + part;
  }

  // physics.lake.depth_from_volume_plain: the depth of `vol` by
  // kDepthIters bisection steps on [0, maxdepth] (0 where vol <= 0, which
  // the plain version returns after its steps). Each step searches only
  // the levels between those of lo and hi: mid lies between them, so its
  // levels do too, and after a few steps the bracket holds one trapezoid.
  __device__ float depth(float vol, float maxdepth) const {
    if (vol <= 0.0f) return 0.0f;
    float lo = 0.0f, hi = maxdepth * 1.0f;
    // the search bounds hold while lo <= mid <= hi, so from 0 <= maxdepth
    const bool track = hi >= lo;
    Levels at_lo{}, at_hi{};
    if (track) {
      at_lo = levels(lo);
      at_hi = levels(hi);
    }
    for (int it = 0; it < kDepthIters; ++it) {
      const float mid = 0.5f * (lo + hi);
      const Levels lv = track ? levels(mid, at_lo, at_hi) : levels(mid);
      const bool high = volume(mid, lv) > vol;
      lo = high ? lo : mid;
      hi = high ? mid : hi;
      (high ? at_hi : at_lo) = lv;
    }
    return 0.5f * (lo + hi);
  }
};

}  // namespace lakebasin
