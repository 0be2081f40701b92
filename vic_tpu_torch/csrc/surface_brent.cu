// K5 surface_brent: the soil-surface temperature of the QUICK_FLUX step,
// with or without FROZEN_SOIL's fusion term, and every term of the balance
// at the accepted temperature, for sm_90a (H100).
//
// Replaces vic_tpu/physics/surface.py:438 (solve_surface_temperature's
// batched_brent on surf_energy_terms, residual :71-378) and the evaluation
// of surf_energy_terms at the accepted root that follows it
// (vic_tpu/model.py:714). On the TPU the Brent was a lax while_loop over the
// whole [n_cell, max_hru] batch: every iteration re-ran the ~300-line
// residual's fusions on every lane until the slowest lane converged, and the
// terms at the root were one more pass of them.
//
// What bounds it on this card: a lane reads 53 floats, 5 x nl layer floats
// and 5 masks (~280 B; less where an input is shared by the HRUs of a cell;
// with DIST_PRCP the dry column's 7 floats, 4 x nl layer floats and a mask
// more; with FROZEN_SOIL the fusion's 5 floats and a mask more) and its
// bracket, runs up to ~70 dependent residual
// evaluations of ~150 flops and a few log/sqrt/exp each, and writes 17 + nl
// terms (with DIST_PRCP 4 + nl more): latency, not device-memory bytes. One
// thread a lane (a one-thread Brent) left a warp waiting on its
// slowest lane with its glacier, lake and finished lanes idle, and the
// caller then evaluated the whole residual once more in ~100 PyTorch
// launches to read its terms.
//
// What the design does: the lanes run on csrc/lane_brent.cuh's driver
// (compacted and dealt to persistent threads, a finished lane's thread
// taking the next), each lane's Ts-independent terms formed once when its
// thread takes it, every input, the bracket too, read where it lies through
// the wrapper's one lane table; its epilogue evaluates the balance once more
// at the accepted temperature (the root, or TFALLBACK's where the lane did
// not converge: its carried surface temperature ts_old, as
// physics/surface.solve_surface_temperature takes it) on every lane and
// writes its terms (surface_brent.cuh terms(), the residual's own
// arithmetic).
//
// C interface for ctypes: K5's float inputs (with the dry column's), the 5
// fusion inputs, lo and hi, then K5's masks and
// fs_active, as the wrapper's lane table (lanes.cuh); the Brent's four
// outputs, the terms (kernels.SURFACE_TERMS, then with DIST_PRCP
// kernels.SURFACE_DRY_TERMS, n floats each) and the layer split ([n, nl],
// then with DIST_PRCP the dry column's); returns cudaGetLastError(),
// cudaErrorInvalidValue on wrong counts or vicbrent::kNoResidentBlock where
// no block fits on an SM.

#include <cuda_runtime.h>

#include <cstdint>

#include "brent.cuh"
#include "lane_brent.cuh"
#include "lanes.cuh"
#include "surface_brent.cuh"

namespace {

using namespace vicsurf;

// the bracket after the fusion inputs (kernels.SURFACE_BOUNDS)
enum BoundIn { kLoIn, kHiIn, kNumBoundIn };
constexpr int kBoundIn = kNumSurfaceIn + kNumFdIn;

// the terms written a lane, kernels.SURFACE_TERMS (SurfEBResult's fields),
// and with DIST_PRCP the dry column's, kernels.SURFACE_DRY_TERMS
enum Term {
  kError, kT1, kGrndFlux, kDeltaH, kFusion, kLatentHeat, kLatentHeatSub,
  kSensibleHeat, kSnowFlux, kNetLongBare, kEvap, kCanopyEvapMm, kThroughfall,
  kWdewNew, kRefreezeEnergy, kDeltaCc, kIncVaporFlux, kNumTerms
};
enum DryTerm { kCanopyEvapMmDry, kThroughfallDry, kWdewNewDry, kEvapDry,
               kNumDryTerms };

struct SurfaceParams {
  float dt;
  int grnd_flux_type;
  bool frozen;
  int n;
  float* terms;   // [kNumTerms (+ kNumDryTerms), n]
  float* layer;   // [n, nl], with DIST_PRCP then the dry column's [n, nl]
};

// evap.wet_canopy_evap's throughfall and canopy storage once the
// interception evaporation cevap is known (canopy_evap.c:158-177); on a
// bare lane the rain falls through and the storage stays
__device__ __forceinline__ void canopy_water(bool veg, float wdew, float prec,
                                             float wdmax, float cevap,
                                             float* thru, float* wdew_new) {
  if (!veg) {
    *thru = prec;
    *wdew_new = wdew;
    return;
  }
  const float throughfall = nan_max(wdew - wdmax, 0.0f);
  const float wdew_c = nan_min(wdew, wdmax);
  const float stored = nan_max(wdew_c + prec - cevap, 0.0f);
  const float over = nan_max(stored - wdmax, 0.0f);
  *thru = throughfall + over;
  *wdew_new = stored - over;
}

// K5's lane for lane_brent.cuh
template <int NL, bool DIST>
struct SurfaceLane : SurfaceResidual<NL, DIST> {
  static constexpr int kLo = kBoundIn + kLoIn, kHi = kBoundIn + kHiIn;
  static constexpr int kActive = vicsurf::kActive;
  // four blocks an SM (at most 128 registers a thread), as K14's residual
  static constexpr int kMinBlocks = 4;

  __device__ __forceinline__ void init(const LaneInputs& in, LaneRow row,
                                       const SurfaceParams& p) {
    SurfaceResidual<NL, DIST>::init(in, row, p.dt, p.grnd_flux_type);
    this->init_fusion(in, row, p.frozen);
  }

  // the terms at the accepted temperature: the root, or TFALLBACK's, the
  // carried ts_old (physics/surface.py solve_surface_temperature)
  __device__ void epilogue(const LaneInputs& in, LaneRow row, int lane,
                           const BrentOut& out,
                           const SurfaceParams& p) const {
    const float ts =
        out.converged ? out.root : lane_f(in, kTsOld, row);
    const SurfaceTerms<NL> t = this->quick_terms(ts);
    float* col = p.terms + lane;
    const int n = p.n;
    col[kError * n] = t.error;
    col[kT1 * n] = t.t1;
    col[kGrndFlux * n] = t.grnd_flux;
    col[kDeltaH * n] = t.delta_h;
    col[kFusion * n] = t.fusion;
    col[kLatentHeat * n] = t.latent;
    col[kLatentHeatSub * n] = t.latent_sub;
    col[kSensibleHeat * n] = t.sensible;
    col[kSnowFlux * n] = t.snow_flux;
    col[kNetLongBare * n] = t.net_long_bare;
    col[kEvap * n] = t.evap;
    col[kCanopyEvapMm * n] = t.wet.cevap;
    col[kRefreezeEnergy * n] = t.refreeze;
    col[kDeltaCc * n] = t.delta_cc;
    col[kIncVaporFlux * n] = t.vapor_flux;
    const float wdmax = lane_f(in, kWdmax, row);
    float thru, wdew_new;
    canopy_water(this->veg, lane_f(in, kWdew, row),
                 lane_f(in, kRainfall, row), wdmax, t.wet.cevap, &thru,
                 &wdew_new);
    col[kThroughfall * n] = thru;
    col[kWdewNew * n] = wdew_new;
    float* layer = p.layer + static_cast<int64_t>(lane) * NL;
#pragma unroll
    for (int l = 0; l < NL; ++l) layer[l] = t.wet.layer[l];
    if constexpr (DIST) {
      float* dry = col + kNumTerms * n;
      canopy_water(this->veg, lane_f(in, kDryIn + kWdewDry, row),
                   lane_f(in, kDryIn + kRainfallDry, row), wdmax,
                   t.dry.cevap, &thru, &wdew_new);
      dry[kCanopyEvapMmDry * n] = t.dry.cevap;
      dry[kThroughfallDry * n] = thru;
      dry[kWdewNewDry * n] = wdew_new;
      dry[kEvapDry * n] = t.dry.evap;
      float* layer_dry = layer + static_cast<int64_t>(n) * NL;
#pragma unroll
      for (int l = 0; l < NL; ++l) layer_dry[l] = t.dry.layer[l];
    }
  }
};

}  // namespace

extern "C" {

// nf, nm: the input counts, checked against the residual's; h: lanes per
// cell; nl: soil layers (2 or 3); dist: the dry column is read and its
// terms written (DIST_PRCP); frozen: the fusion term is added (FROZEN_SOIL).
int surface_brent(const int64_t* lanes, int nf, int nm, int h, int nl,
                  int dist, float dt, int grnd_flux_type, int frozen,
                  int max_iter, int max_tries, int n, float* root,
                  uint8_t* converged, uint8_t* bracketed, int32_t* iterations,
                  float* terms, float* layer_terms, void* stream) {
  LaneInputs in{};
  if (n <= 0 || max_iter < 0 || max_tries < 0 ||
      !fill_lane_inputs(&in, lanes, nf, kBoundIn + kNumBoundIn, nm,
                        kNumSurfaceMask + 1, h))
    return static_cast<int>(cudaErrorInvalidValue);
  const SurfaceParams p{dt, grnd_flux_type, frozen != 0, n, terms,
                        layer_terms};
  const BrentOutputs out{root, converged, bracketed, iterations};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nl == 2 && dist)
    return vicbrent::launch_lane_brent<SurfaceLane<2, true>>(
        in, p, max_iter, max_tries, n, out, s);
  if (nl == 2)
    return vicbrent::launch_lane_brent<SurfaceLane<2, false>>(
        in, p, max_iter, max_tries, n, out, s);
  if (nl == 3 && dist)
    return vicbrent::launch_lane_brent<SurfaceLane<3, true>>(
        in, p, max_iter, max_tries, n, out, s);
  if (nl == 3)
    return vicbrent::launch_lane_brent<SurfaceLane<3, false>>(
        in, p, max_iter, max_tries, n, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
