// lake_water_balance: the lakes' water balance after solve_lake, one thread
// per lake, for sm_90a.
//
// Takes in physics.lake.lake_water_balance_plain (vic_tpu/physics/lake.py:
// 1553's per-HRU water balance, lakes.eb.c:1965-2247, as full_energy.c
// calls it once per HRU lane): in lane order, on every lane, the gains and
// the evaporation cap, the new extent, the flooding recharge of the lane's
// wetland soil, the ARNO baseflow through the lake bed, the weir with its
// growth caps and the dry test, each lane's final and largest new
// fraction; then the final depth, area and the closure telemetry. As
// plain PyTorch that is ~60 small launches and 5 depth bisections (K13)
// per lane, 8 lanes a record; here one thread runs a lake's whole balance,
// its depth solves on lake_basin.cuh's tables, in one launch.
//
// Every operation repeats the plain version's, in its order (a lane outside
// the mask leaves the lake's totals as its masked updates do, exactly,
// since each adds or subtracts a zero; its depth solves past the first
// are skipped, and a depth asked for the volume of the solve before it is
// not solved again), clamps as nan_max/nan_min, the layer sum in index
// order (_isum) and the cumulative sum's running total, and each host
// scalar as PyTorch applies it on the card: a product or division by a
// Python float is a float32 product with the float (a division by the
// float's reciprocal, div_s), so `dsmax / 24.0`, `/ 1000.0`, `/ math.pi`;
// `2.0 * math.pi`, `dt_sec` and `1.6` multiply as the floats PyTorch
// rounds them to; torch.pow on a tensor exponent and on 1.5 is powf.
//
// Bound by latency, not by work: up to 41 depth solves of 30 dependent
// bisection steps per lake (~24 of a changed volume on the lakes
// configuration), one after another as the volume carries from lane to
// lane; ~0.7 KB read and written per lake. So the time is the longest
// lake's chain, whatever the lake count, and a solve's steps, once its
// bracket's ends are at most one level apart (after a few steps; the whole
// solve for a lake near a level), take the levels from one comparison each
// and the trapezoid from registers (lake_basin.cuh's Basin::solve), with
// no search and no shared load. A solve also returns its depth's levels,
// so the area at that depth needs no search either.
//
// C interface for ctypes (lanes.cuh): the lane table of the float inputs
// (kernels.LAKE_BALANCE_INPUTS: per lake, the basin's 21 levels, per
// lane, per lane and soil layer) and the masks (has_lake, active,
// lane_mask); lanes per lake, soil layers (0: no wetland), dt_sec, lakes;
// the outputs: the per-lake fields [kNumOut][n], then lane_nf, lane_maxnf
// [n][lanes] and the wetland's moisture change [n][lanes][layers].
// Returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "lake_basin.cuh"
#include "lanes.cuh"
#include "physics.cuh"

namespace {

using vicphys::div_s;
using vicphys::nan_max;
using vicphys::nan_min;

constexpr int kBlock = 128;
constexpr float kSmall = 1.0e-12f;             // constants.SMALL
constexpr float kTwoPi = static_cast<float>(2.0 * 3.141592653589793);
constexpr float kPi = static_cast<float>(3.141592653589793);

// float inputs, in the order of kernels.LAKE_BALANCE_INPUTS
enum In {
  kZ, kBasin, kMaxDepth, kMinDepth, kMinVolume, kMaxVolume, kWfrac,
  kStVolume, kStIceArea, kStSwe, kVolume, kIceWaterEq, kSwe, kEvap,
  kIceThroughfall, kStoreDump, kSnowmelt, kNewIceArea, kSarea, kPrecipIn,
  kVaporFlux, kRunoffIn, kBaseflowIn, kDs, kDsmax, kWsArno, kCExpt,
  kRelMoist, kMoist, kMaxMoist, kNumIn
};
enum Mask { kHasLake, kActive, kLaneMask, kNumMask };
// the per-lake outputs, in the order of physics.lake.WaterBalance
enum Out {
  kOutVolume, kOutEvap, kOutRunoff, kOutBaseflow, kOutRecharge,
  kOutMaxNewFraction, kOutDepth, kOutSarea, kOutWaterError, kNumOut
};

__device__ __forceinline__ float clamp01(float x) {
  return nan_min(nan_max(x, 0.0f), 1.0f);
}

// two blocks an SM hold a 32,768-lake batch at once; ptxas then need not
// spill to fit the shared tables' occupancy
__global__ void __launch_bounds__(kBlock, 2)
    lake_water_balance_kernel(const __grid_constant__ LaneInputs in,
                              int n_lane, int nl, float dt_sec, int n,
                              float* out, float* lane_nf, float* lane_maxnf,
                              float* dmoist) {
  __shared__ lakebasin::Table<kBlock> table;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const LaneRow row{i, 0};
  auto f = [&](int k) { return lane_f(in, k, row); };
  lakebasin::Basin<kBlock> bs;
  bs.load(
      table, threadIdx.x, [&](int k) { return lane_fl(in, kZ, row, k); },
      [&](int k) { return lane_fl(in, kBasin, row, k); });
  const float maxdepth = f(kMaxDepth);
  // the last depth solved, with its levels, and its volume (a liquid
  // volume is >= 0 or NaN, and a NaN is solved anew): the balance often
  // asks again for the depth of a volume no flux has changed
  float memo_v = -1.0f;
  lakebasin::Basin<kBlock>::Solved memo{};
  auto solve = [&](float v) {
    if (!(v == memo_v)) {
      memo_v = v;
      memo = bs.solve(v, maxdepth);
    }
    return memo;
  };
  auto depth = [&](float v) { return solve(v).d; };
  auto area_of = [&](float v) {
    const auto s = solve(v);
    return bs.area(s.d, s.lv);
  };

  const float basin0 = bs.b(0);
  const float basin0_1 = nan_max(basin0, 1.0f);
  const float sarea = f(kSarea);
  const float new_ice_area = f(kNewIceArea);
  const float lakefrac =
      clamp01(nan_max(sarea, f(kStIceArea)) / basin0_1);
  const float store_start = f(kStVolume) + f(kStSwe) * sarea;
  const bool live = lane_m(in, kHasLake, row) && lane_m(in, kActive, row);
  const float inflow = f(kRunoffIn) + f(kBaseflowIn);
  const float gains =
      f(kIceThroughfall) + f(kStoreDump) + inflow + f(kSnowmelt);
  const float ds = f(kDs), ws_arno = f(kWsArno), cexp = f(kCExpt);
  const float dsmax_step = div_s(f(kDsmax), 24.0f);
  const float mindepth = f(kMinDepth), minvolume = f(kMinVolume);
  const float maxvolume = f(kMaxVolume), wfrac = f(kWfrac);
  const float iwe = f(kIceWaterEq);

  float volume = f(kVolume);
  float evap_call = f(kEvap);
  float gains_total = 0.0f, evap_total = 0.0f, recharge = 0.0f;
  float baseflow_total = 0.0f, runoff_total = 0.0f;
  float baseflow_out = 0.0f, runoff_out = 0.0f, max_newfraction = 0.0f;

  for (int h = 0; h < n_lane; ++h) {
    const LaneRow lr{i, h};
    const int64_t li = static_cast<int64_t>(i) * n_lane + h;
    float* dm = dmoist + li * nl;
    // the new extent before recharge, on every lane
    const bool valid = live && lane_m(in, kLaneMask, lr);
    const float liquid0 = nan_max(volume - iwe, 0.0f);
    const bool over = evap_call > liquid0 + gains;
    const float evap_h = over ? nan_max(liquid0 + gains, 0.0f) : evap_call;
    if (valid) volume = over ? iwe : volume + gains - evap_h;
    const float liquid1 = nan_max(volume - iwe, 0.0f);
    const float surfacearea = nan_max(area_of(liquid1), new_ice_area);
    const float maxnf_h = clamp01(surfacearea / basin0_1);
    lane_maxnf[li] = maxnf_h;
    if (!valid) {
      // the plain version's masked updates leave everything as it was, so
      // the lane's final fraction is its new one
      lane_nf[li] = maxnf_h;
      for (int l = 0; l < nl; ++l) dm[l] = 0.0f;
      continue;
    }
    // gains + evaporation cap, re-booked every call
    evap_call = evap_h;
    gains_total = gains_total + gains;
    evap_total = evap_total + evap_h;
    const float volume_save = volume;
    max_newfraction = maxnf_h;

    // flooding recharge of this lane's soil
    float rel_moist = 1.0f;
    if (nl > 0) {
      const bool grow = maxnf_h > lakefrac;
      const float gfrac =
          (maxnf_h - lakefrac) / nan_max(1.0f - lakefrac, 1e-6f);
      auto room_of = [&](int l) {
        return nan_max(lane_fl(in, kMaxMoist, lr, l) -
                           lane_fl(in, kMoist, lr, l),
                       0.0f);
      };
      float want_sum = 0.0f;
      for (int l = 0; l < nl; ++l) {
        const float want = room_of(l) * gfrac;
        want_sum = l == 0 ? want : want_sum + want;
      }
      float rech_h = div_s(want_sum, 1000.0f) * (1.0f - lakefrac) * basin0;
      const float liquid2 = nan_max(volume - iwe, 0.0f);
      const bool enough = liquid2 > rech_h;
      const float avail_mm =
          1000.0f * liquid2 / nan_max((maxnf_h - lakefrac) * basin0, kSmall);
      float cum = 0.0f;
      for (int l = 0; l < nl; ++l) {
        const float room = room_of(l);
        cum = l == 0 ? room : cum + room;
        const float fill = nan_min(nan_max(avail_mm - (cum - room), 0.0f),
                                   room);
        dm[l] = grow ? (enough ? room * gfrac : fill * gfrac) : 0.0f;
      }
      rech_h = grow ? (enough ? rech_h : liquid2) : 0.0f;
      volume = volume - rech_h;
      recharge = recharge + rech_h;
      rel_moist = clamp01(lane_f(in, kRelMoist, lr));
    }

    // ARNO baseflow through the lake bed, Dsmax/24 per call
    float baseflow_mm = dsmax_step * ds / ws_arno * rel_moist;
    const bool over_ws = rel_moist > ws_arno;
    const float frac2 =
        over_ws ? (rel_moist - ws_arno) / nan_max(1.0f - ws_arno, kSmall)
                : 0.0f;
    baseflow_mm =
        baseflow_mm + (over_ws ? dsmax_step * (1.0f - ds / ws_arno) *
                                     powf(nan_max(frac2, kSmall), cexp)
                               : 0.0f);
    baseflow_mm = nan_max(baseflow_mm, 0.0f);
    const float liquid3 = nan_max(volume - iwe, 0.0f);
    const float area3 = area_of(liquid3);
    const float bf_h =
        nan_min(nan_max(div_s(baseflow_mm * area3, 1000.0f), 0.0f), liquid3);
    volume = volume - bf_h;
    baseflow_total = baseflow_total + bf_h;
    baseflow_out = bf_h;

    // weir outflow
    const float liquid4 = nan_max(volume - iwe, 0.0f);
    const float ldepth4 = depth(liquid4);
    const float circum = kTwoPi * sqrtf(div_s(nan_max(area3, 0.0f), kPi));
    const float head = ldepth4 - mindepth;
    float ro_h = head > 0.0f ? wfrac * circum * dt_sec * 1.6f *
                                   powf(nan_max(head, 0.0f), 1.5f)
                             : 0.0f;
    ro_h = nan_min(ro_h, liquid4);
    ro_h = nan_min(nan_max(ro_h, 0.0f), nan_max(volume - minvolume, 0.0f));
    float vol_after_weir = volume - ro_h;
    // growth caps
    const float excess_save = nan_max(vol_after_weir - volume_save, 0.0f);
    ro_h = ro_h + excess_save;
    vol_after_weir = vol_after_weir - excess_save;
    const float cap = nan_max(maxvolume, iwe);
    const float excess_max = vol_after_weir - maxvolume > kSmall
                                 ? nan_max(vol_after_weir - cap, 0.0f)
                                 : 0.0f;
    ro_h = ro_h + excess_max;
    vol_after_weir = vol_after_weir - excess_max;
    vol_after_weir = vol_after_weir < kSmall ? 0.0f : vol_after_weir;
    // the liquid depth vanishes
    const float liquid5 = nan_max(vol_after_weir - iwe, 0.0f);
    const bool dry = depth(liquid5) <= kSmall;
    ro_h = ro_h + (dry ? liquid5 : 0.0f);
    volume = dry ? iwe : vol_after_weir;
    runoff_total = runoff_total + ro_h;
    runoff_out = ro_h;

    // the lane's final fraction for the storage advection
    const float ar_f = nan_max(area_of(nan_max(volume - iwe, 0.0f)),
                               new_ice_area);
    lane_nf[li] = clamp01(ar_f / basin0_1);
  }

  const float liquid5 = nan_max(volume - iwe, 0.0f);
  const auto solved5 = solve(liquid5);
  const float ldepth5 = solved5.d <= kSmall ? 0.0f : solved5.d;
  const float sarea_end =
      nan_max(bs.area(ldepth5, solved5.lv), new_ice_area);

  // closure telemetry: every pass after the first re-adds the same gains
  const float extra_gains = nan_max(gains_total - gains, 0.0f);
  const float store_end = volume + f(kSwe) * sarea;
  const float water_error_m3 =
      (store_end - store_start) -
      (f(kPrecipIn) + inflow + extra_gains - evap_total - f(kVaporFlux) -
       recharge - baseflow_total - runoff_total);
  const float water_error_mm =
      live ? water_error_m3 / nan_max(sarea, 1.0f) * 1000.0f : 0.0f;

  out[kOutVolume * n + i] = volume;
  out[kOutEvap * n + i] = evap_call;
  out[kOutRunoff * n + i] = runoff_out;
  out[kOutBaseflow * n + i] = baseflow_out;
  out[kOutRecharge * n + i] = recharge;
  out[kOutMaxNewFraction * n + i] = max_newfraction;
  out[kOutDepth * n + i] = ldepth5;
  out[kOutSarea * n + i] = sarea_end;
  out[kOutWaterError * n + i] = water_error_mm;
}

}  // namespace

extern "C" {

// Replaces vic_tpu/physics/lake.py:1553's per-HRU water balance.
int lake_water_balance(const int64_t* lanes, int nf, int nm, int n_lane,
                       int nl, float dt_sec, int n, float* out,
                       float* lane_nf, float* lane_maxnf, float* dmoist,
                       void* stream) {
  LaneInputs in{};
  if (n <= 0 || nl < 0 ||
      !fill_lane_inputs(&in, lanes, nf, kNumIn, nm, kNumMask, n_lane))
    return static_cast<int>(cudaErrorInvalidValue);
  lake_water_balance_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      in, n_lane, nl, dt_sec, n, out, lane_nf, lane_maxnf, dmoist);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
