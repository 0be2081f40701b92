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
// cannot be indexed by a run-time index. K13 solves with depth(); the
// water balance, which solves a lake's depth up to 41 times, with solve(),
// whose steps, once the bracket's ends are at most one level apart, take
// the levels from one comparison and the trapezoid from registers (Span).
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

  // What area(d, lv) and volume(d, lv) read where the bracket's ends'
  // levels differ by at most one in each index, held in registers. A
  // midpoint's levels then follow from one comparison each, as the
  // searches between the ends' levels find them (first_below over a range
  // of one level), and its volume is the same operations on these values,
  // without a search or a load. The bracket only narrows, so the span
  // holds for the rest of the solve.
  struct Span {
    // the area's trapezoid j - 1 at each end's j: z(j-1), z(j), b(j), its
    // width and b(j-1) - b(j)
    struct Area {
      int j;
      float za, zb, ba, den, dba;
    };
    // the full layers' sum and the partial trapezoid k0 - 1 at each end's
    // k0: full(k0), z(k0), z(k0-1), b(k0)
    struct Layers {
      int k0;
      float fullv, zk, zp, bk;
    };
    Area a_lo, a_hi;
    Layers l_lo, l_hi;
    float z_j, z_k;   // z(j) and z(k0) of the deeper end: the tests
    float z0, b0;     // the top level

    __device__ Levels levels(float d) const {
      return Levels{a_hi.j < a_lo.j && z_j >= d ? a_lo.j : a_hi.j,
                    l_hi.k0 < l_lo.k0 && z_k > d ? l_lo.k0 : l_hi.k0};
    }
    // volume(d, lv) at the levels of d, each end's value picked by value
    // (a reference to either would put both in local memory)
    __device__ float volume(float d) const {
      const Levels lv = levels(d);
      const bool j_lo = lv.j == a_lo.j, k_lo = lv.k0 == l_lo.k0;
      const float za = j_lo ? a_lo.za : a_hi.za;
      const float zb = j_lo ? a_lo.zb : a_hi.zb;
      const float ba = j_lo ? a_lo.ba : a_hi.ba;
      const float den = j_lo ? a_lo.den : a_hi.den;
      const float dba = j_lo ? a_lo.dba : a_hi.dba;
      float a = 0.0f;
      if (lv.j < kLevels && d <= za && d > zb) a = ba + (d - zb) / den * dba;
      a = d >= z0 ? b0 : a;
      const float a_surf = d <= 0.0f ? 0.0f : a;
      const float fullv = k_lo ? l_lo.fullv : l_hi.fullv;
      const float zk = k_lo ? l_lo.zk : l_hi.zk;
      const float zp = k_lo ? l_lo.zp : l_hi.zp;
      const float bk = k_lo ? l_lo.bk : l_hi.bk;
      const float full_v = lv.k0 < kLayers && d >= zk ? fullv : 0.0f;
      float part = 0.0f;
      if (lv.k0 > 0 && d > zk && d < zp)
        part = nan_max(d - zk, 0.0f) * (a_surf + bk) / 2.0f;
      return full_v + part;
    }
  };
  __device__ typename Span::Area span_area(int j) const {
    typename Span::Area t{j};
    if (j < kLevels) {
      t.za = z(j - 1);
      t.zb = z(j);
      t.ba = b(j);
      t.den = nan_max(t.za - t.zb, 1e-10f);
      t.dba = b(j - 1) - t.ba;
    }
    return t;
  }
  __device__ typename Span::Layers span_layers(int k0) const {
    typename Span::Layers l{k0};
    if (k0 < kLayers) l.fullv = full(k0);
    l.zk = z(k0);
    if (k0 > 0) {
      l.zp = z(k0 - 1);
      l.bk = b(k0);
    }
    return l;
  }
  // the Span of a bracket whose ends have the levels lo and hi (hi the
  // deeper end's)
  __device__ Span span(Levels lo, Levels hi) const {
    return Span{span_area(lo.j), span_area(hi.j), span_layers(lo.k0),
                span_layers(hi.k0), z(hi.j < kLevels ? hi.j : 0), z(hi.k0),
                z(0), b(0)};
  }

  // a solved depth and its levels
  struct Solved {
    float d;
    Levels lv;
  };

  // depth()'s bits, with the levels of the depth (for area(d, lv)); once
  // the bracket's ends' levels differ by at most one, each step's test is
  // the Span's
  __device__ Solved solve(float vol, float maxdepth) const {
    if (vol <= 0.0f) return Solved{0.0f, Levels{kLevels, kLayers}};
    float lo = 0.0f, hi = maxdepth * 1.0f;
    const bool track = hi >= lo;
    Levels at_lo{}, at_hi{};
    if (track) {
      at_lo = levels(lo);
      at_hi = levels(hi);
    }
    Span sp{};
    bool in_span = false;
    for (int it = 0; it < kDepthIters; ++it) {
      if (!in_span && track && at_lo.j - at_hi.j <= 1 &&
          at_lo.k0 - at_hi.k0 <= 1) {
        sp = span(at_lo, at_hi);
        in_span = true;
      }
      const float mid = 0.5f * (lo + hi);
      bool high;
      if (in_span) {
        high = sp.volume(mid) > vol;
      } else {
        const Levels lv = track ? levels(mid, at_lo, at_hi) : levels(mid);
        high = volume(mid, lv) > vol;
        (high ? at_hi : at_lo) = lv;
      }
      lo = high ? lo : mid;
      hi = high ? mid : hi;
    }
    const float d = 0.5f * (lo + hi);
    return Solved{d, in_span ? sp.levels(d)
                             : (track ? levels(d, at_lo, at_hi) : levels(d))};
  }
};

}  // namespace lakebasin
