// Hand-written CUDA kernels of the light VIC step, for sm_90a (H100).
//
//   K1 glacier_brent   <- vic_tpu/physics/glacier.py:130     glacier_ablation
//   K2 snowpack_brent  <- vic_tpu/physics/snow.py:443        snow_melt
//   K3 canopy_brent    <- vic_tpu/physics/canopy_snow.py:270 snow_intercept
//   K4 runoff_hourly   <- vic_tpu/physics/runoff.py:171      runoff_step
//
// On the TPU each of these was a lax while_loop/fori_loop over the whole
// [n_cell, max_hru] batch: every trip re-launched the residual's fusions on
// every lane until the slowest lane converged. Here each lane's whole loop
// runs in registers inside a single launch, so a lane pays only its own
// trip count and nothing leaves the chip between iterations. Each lane
// reads ~20 floats and writes a few, while it runs up to ~70 residual
// evaluations (K1-K3) or 24 hourly trips (K4) of transcendental arithmetic
// with divergent trip counts: the kernels are bound by latency and
// occupancy (registers per thread), not by device-memory bytes. The Brent
// lanes (K1-K3) that are active are few and scattered (K1: glacier HRUs
// that do not melt, at most 2 of a cell's 8) and their trips uneven, so
// they are compacted and dealt to persistent threads (lane_brent.cuh). K1
// and K2 also take their balance at 0 C for the melt test and write its
// terms at the accepted temperature, and K4 computes the whole of
// runoff_step around its hourly loop, all of which their callers
// evaluated in PyTorch before. K4's lanes are all active with one trip
// count, so it runs one lane a thread.
//
// Every residual is a line-for-line copy of its PyTorch plain version, with
// the same operation order, x^4 as (x*x)*(x*x) like lax.integer_pow, and the
// library is built with -fmad=false, so a kernel and its plain version
// differ only by libm ulps.
//
// C interface for ctypes: float inputs and uint8 masks come as the
// wrapper's table of device pointers and strides (lanes.cuh), copied into
// the kernel's parameter block; each launcher returns cudaGetLastError()
// (0 = launched).

#include <cuda_runtime.h>

#include <cstdint>

#include "brent.cuh"
#include "lane_brent.cuh"
#include "lanes.cuh"
#include "pack_residuals.cuh"
#include "physics.cuh"

namespace {

using namespace vicphys;
using namespace vicres;

constexpr int kBlock = 128;

// evap.penman with rc = 0 (penman.c:96-143, coefficients from
// evap.penman_coeffs)
__device__ __forceinline__ float penman_rc0(float tair, float elevation,
                                            float rad, float vpd, float ra,
                                            float rarc) {
  const float t = 237.3f + tair;
  const float slope = kSvpBC / (t * t) * svp(tair);
  const float h =
      kGasOverG * ((tair + 273.15f) + 0.5f * elevation * (-0.006f));
  const float pz = 101300.0f * expf(-elevation / h);
  const float lv = 2501000.0f - 2361.0f * tair;
  const float gamma = 1628.6f * pz / lv;
  const float r_air = 0.003486f * pz / (275.0f + tair);
  const float ra_safe = nan_max(ra, 1e-10f);
  float evap = (slope * rad + r_air * 1013.0f * vpd / ra_safe) /
               (lv * (slope + gamma * (1.0f + (0.0f + rarc) / ra_safe))) *
               kSecPerDay;
  if (vpd >= 0.0f && evap < 0.0f) evap = 0.0f;
  return evap;
}

// evap.wet_canopy_evap's canopy evaporation, mm/step (canopy_evap.c:46-177)
__device__ __forceinline__ float wet_canopy_evap(float wdew, float prec,
                                                 float wdmax, float rarc,
                                                 float rad, float vpd,
                                                 float air_temp,
                                                 float elevation, float ra,
                                                 float dt) {
  const float wdmax_safe = nan_max(wdmax, 1e-10f);
  const float wdew_c = nan_min(wdew, wdmax);
  const float x = nan_min(nan_max(wdew_c / wdmax_safe, 0.0f), 1.0f);
  const float ce = powf(x, kTwoThirds) *
                   penman_rc0(air_temp, elevation, rad, vpd, ra, rarc) * dt /
                   kSecPerDay;
  const float storage = dt == kSecPerDay ? wdew_c + prec : wdew_c;
  const float f = ce > 0.0f ? nan_min(storage / nan_max(ce, 1e-20f), 1.0f) : 1.0f;
  return ce * f;
}

// K3 residual: canopy_snow.canopy_energy_terms(t)["rest"]
struct CanopyResidual {
  float dt, lai_ra_over, air_dens, vp_air, pressure, le, tcanopy, vpd,
      rainfall_m, net_short_over, long_over_in, long_under_out, int_rain,
      ra_plain, wdew_mm, prec_mm, wdmax_mm, rarc, elevation;
  bool has_csnow;

  __device__ float operator()(float tf) const {
    const float long_over_out = kStefanB * pow4(tf + kKelvin);
    const float net_rad =
        net_short_over + long_over_in + long_under_out - 2.0f * long_over_out;
    float latent, latent_sub, ra_over;
    if (has_csnow) {
      // intercepted-snow branch, ra x 10, no stability correction
      float vmf = air_dens * (kEpsRatio / pressure) * (vp_air - svp(tf)) /
                  lai_ra_over / kRhoW;
      if (vpd == 0.0f && vmf < 0.0f) vmf = 0.0f;
      latent = 0.0f;
      latent_sub = ls_of(tf) * vmf * kRhoW;
      ra_over = lai_ra_over;
    } else {
      // snow-free canopy: wet-canopy evaporation at this net radiation
      const float cevap =
          wet_canopy_evap(wdew_mm, prec_mm, wdmax_mm, rarc, net_rad, vpd,
                          tcanopy, elevation, ra_plain, dt);
      latent = le * (cevap / 1000.0f / dt) * kRhoW;
      latent_sub = 0.0f;
      ra_over = ra_plain;
    }
    const float sensible = air_dens * kCp * (tcanopy - tf) / ra_over;
    const float advected = 4186.8f * tcanopy * rainfall_m / dt;
    const float refreeze = int_rain * kLf * kRhoW / dt;
    const float rest = sensible + latent + latent_sub + net_rad + advected;
    if (!has_csnow) return rest;
    if (tf == 0.0f && rest > -refreeze) return 0.0f;
    return rest + refreeze;
  }
};

// K3's lane for csrc/lane_brent.cuh: the 18 float inputs in
// CanopyResidual order after dt, then lo and hi; masks [active, has_csnow]
struct CanopyParams {
  float dt;
};

struct CanopyLane : CanopyResidual {
  static constexpr int kNumIn = 18;
  static constexpr int kLo = kNumIn, kHi = kNumIn + 1, kActive = 0;
  static constexpr int kMinBlocks = 1;

  __device__ __forceinline__ void init(const LaneInputs& in, LaneRow row,
                                       const CanopyParams& p) {
    auto f = [&](int k) { return lane_f(in, k, row); };
    *static_cast<CanopyResidual*>(this) = CanopyResidual{
        p.dt,  f(0),  f(1),  f(2),  f(3),  f(4),  f(5),
        f(6),  f(7),  f(8),  f(9),  f(10), f(11), f(12),
        f(13), f(14), f(15), f(16), f(17), lane_m(in, 1, row)};
  }
};

// K2's lane for csrc/lane_brent.cuh: the 21 float inputs in
// SnowpackResidual order after dt, then lo and hi; masks [active, spatial]
// (spatial: SPATIAL_SNOW's advected sensible heat, a flag broadcast to the
// lanes). Its prologue writes the balance's terms at 0 C and the melt test
// on every lane and solves only the lanes that neither melt at 0 C nor are
// thin (snow.snow_melt's brent_active, snow.py:357-394); its epilogue
// writes the terms at the accepted temperature, the root or TFALLBACK's
// old_tsurf.
constexpr float kMinSwqEbThres = 0.0010f;   // MIN_SWQ_EB_THRES, m

// the terms written a lane, n floats each: snow.SnowEBTerms' fields
enum SnowTerm {
  kRest, kRefreezeEnergy, kVaporFlux, kLatent, kLatentSub, kSensible,
  kAdvection, kDeltaCc, kGrndFlux, kNetLong, kAdvectedSensible,
  kNumSnowTerms
};

struct SnowpackParams {
  float dt;
  int n;
  float* terms0;       // [kNumSnowTerms, n] at 0 C
  float* terms_b;      // [kNumSnowTerms, n] at the accepted temperature
  uint8_t* melt_cond;  // [n] the pack melts at 0 C
};

__device__ __forceinline__ void store_terms(float* col, int n,
                                            const SnowTerms& t) {
  col[kRest * n] = t.rest;
  col[kRefreezeEnergy * n] = t.refreeze;
  col[kVaporFlux * n] = t.vapor_flux;
  col[kLatent * n] = t.latent;
  col[kLatentSub * n] = t.latent_sub;
  col[kSensible * n] = t.sensible;
  col[kAdvection * n] = t.advection;
  col[kDeltaCc * n] = t.delta_cc;
  col[kGrndFlux * n] = t.grnd_flux;
  col[kNetLong * n] = t.net_long;
  col[kAdvectedSensible * n] = t.advected_sensible;
}

struct SnowpackLane : SnowpackResidual {
  static constexpr int kNumIn = 21;
  static constexpr int kLo = kNumIn, kHi = kNumIn + 1, kActive = 0;
  static constexpr int kMinBlocks = 1;

  __device__ __forceinline__ void init(const LaneInputs& in, LaneRow row,
                                       const SnowpackParams& p) {
    auto f = [&](int k) { return lane_f(in, k, row); };
    *static_cast<SnowpackResidual*>(this) = SnowpackResidual{
        p.dt,  f(0),  f(1),  f(2),  f(3),  f(4),  f(5),  f(6),
        f(7),  f(8),  f(9),  f(10), f(11), f(12), f(13), f(14),
        f(15), f(16), f(17), f(18), f(19), f(20), lane_m(in, 1, row)};
  }

  // the balance at 0 C and the melt test (snow.py:356-360)
  __device__ bool prologue(const LaneInputs&, LaneRow, int lane,
                           bool active, const SnowpackParams& p) {
    const SnowTerms t0 = terms(0.0f);
    store_terms(p.terms0 + lane, p.n, t0);
    const bool melt = t0.rest == 0.0f;
    p.melt_cond[lane] = melt;
    const bool thin = !melt && surface_swq <= kMinSwqEbThres;
    return active && !melt && !thin;
  }

  // the balance at the root, or at old_tsurf where the lane did not
  // converge (TFALLBACK, snow.py:396-398)
  __device__ void epilogue(const LaneInputs&, LaneRow, int lane,
                           const BrentOut& out,
                           const SnowpackParams& p) const {
    store_terms(p.terms_b + lane, p.n,
                terms(out.converged ? out.root : old_tsurf));
  }
};

// K1's lane for csrc/lane_brent.cuh: the 15 float inputs in
// GlacierResidual order after dt, then lo and hi; masks [active]. Its
// prologue takes the balance at 0 C on every lane, writes the melt test
// and the melt it gives (physics/glacier.py glacier_brent_plain) and
// solves only the lanes of `active` that do not melt; its epilogue writes
// the balance's terms at the accepted temperature (0 C where the ice
// melts, else the root, else TFALLBACK's old_tsurf) and what
// glacier_ablation forms from it, so the caller evaluates no balance.
namespace glacier_rows {
// the terms written a lane, n floats each: glacier.GlacierEBTerms' fields
enum GlacierTerm {
  kRest, kMeltEnergy, kVaporFlux, kLatent, kLatentSub, kSensible,
  kAdvection, kDeltaCc, kGrndFlux, kNetLong,
  kNumGlacierTerms
};
// the other floats written a lane, after the terms: GlacierSolve's
// melt_mm, surf_temp, cold_content and vapor_flux (the loss, -kVaporFlux)
enum GlacierOut {
  kMeltMm, kSurfTemp, kColdContent, kVaporLoss, kNumGlacierOut
};
// the flags written a lane
enum GlacierFlag { kMeltCond, kFbflag, kNumGlacierFlags };
}  // namespace glacier_rows
namespace gr = glacier_rows;

// python-constant products evaluate in double before the float32 op
constexpr float kLfRhoW = static_cast<float>(3.337e5 * 999.842594);

struct GlacierParams {
  float dt;
  int n;
  float* out;      // [gr::kNumGlacierTerms + gr::kNumGlacierOut, n]
  uint8_t* flags;  // [gr::kNumGlacierFlags, n]
};

struct GlacierLane : GlacierResidual {
  static constexpr int kNumIn = 15;
  static constexpr int kLo = kNumIn, kHi = kNumIn + 1, kActive = 0;
  static constexpr int kMinBlocks = 1;
  bool melt;   // the lane melts at 0 C (its epilogue runs at 0 C)

  __device__ __forceinline__ void init(const LaneInputs& in, LaneRow row,
                                       const GlacierParams& p) {
    auto f = [&](int k) { return lane_f(in, k, row); };
    *static_cast<GlacierResidual*>(this) = GlacierResidual{
        p.dt,  f(0),  f(1),  f(2),  f(3),  f(4),  f(5),  f(6),
        f(7),  f(8),  f(9),  f(10), f(11), f(12), f(13), f(14)};
  }

  // the balance at 0 C, the melt test and its melt in mm a step:
  // clamp(melt_energy, 0) / (LF * RHO_W) * dt * 1000 where it melts
  __device__ bool prologue(const LaneInputs&, LaneRow, int lane,
                           bool active, const GlacierParams& p) {
    const GlacierTerms t0 = terms(0.0f);
    melt = t0.rest == 0.0f;
    p.flags[gr::kMeltCond * p.n + lane] = melt;
    p.out[(gr::kNumGlacierTerms + gr::kMeltMm) * p.n + lane] =
        melt ? div_s(nan_max(t0.melt_energy, 0.0f), kLfRhoW) * dt * 1000.0f
             : 0.0f;
    return active && !melt;
  }

  // the terms at the accepted temperature, the temperature itself, the
  // fallback flag (set on lanes that neither melt nor converge, masked-out
  // ones too), the cold content and the vapour loss
  __device__ void epilogue(const LaneInputs&, LaneRow, int lane,
                           const BrentOut& out,
                           const GlacierParams& p) const {
    const float ts = melt ? 0.0f : (out.converged ? out.root : old_tsurf);
    const GlacierTerms t = terms(ts);
    float* col = p.out + lane;
    const int n = p.n;
    col[gr::kRest * n] = t.rest;
    col[gr::kMeltEnergy * n] = t.melt_energy;
    col[gr::kVaporFlux * n] = t.vapor_flux;
    col[gr::kLatent * n] = t.latent;
    col[gr::kLatentSub * n] = t.latent_sub;
    col[gr::kSensible * n] = t.sensible;
    col[gr::kAdvection * n] = t.advection;
    col[gr::kDeltaCc * n] = t.delta_cc;
    col[gr::kGrndFlux * n] = t.grnd_flux;
    col[gr::kNetLong * n] = t.net_long;
    col += gr::kNumGlacierTerms * n;
    col[gr::kSurfTemp * n] = ts;
    col[gr::kColdContent * n] =
        melt ? 0.0f : div_s(kChIce * ts * ice_depth_mm, 1000.0f);
    col[gr::kVaporLoss * n] = -t.vapor_flux;
    p.flags[gr::kFbflag * n + lane] = !melt && !out.converged;
  }
};

// K4: runoff.runoff_step_plain in one launch, one thread a lane: the
// residual moisture and ARNO's surface runoff from the top NL-1 layers
// (compute_runoff_and_asat), the hourly loop of runoff_hourly_plain
// (runoff.c:446-700) on the hourly rates, then the final moisture, its
// saturated area, the runoff and baseflow and the bottom layer's evap
// less a negative baseflow. Inputs 0-7 are layered (NL values a lane),
// 8-13 one value a lane (RunoffIn). Outputs (RunoffOut) in one allocation:
// the layered ones [n, NL] (a lane's layers side by side, as a contiguous
// [..., NL] tensor holds them).
enum RunoffIn {
  kMoist, kSoilIce, kLayerEvap, kMaxMoistL, kResidFract, kDepth, kKsat,
  kExpt, kPpt, kBInfilt, kDs, kDsmax, kWs, kCExpt, kNumRunoffIn
};
// runoff.RunoffResult's fields: moist and layer_evap NL rows each
enum RunoffOut { kMoistOut, kRunoffOut, kBaseflowOut, kAsatOut,
                 kLayerEvapOut, kNumRunoffOut };

// the first of output k's rows of n floats
template <int NL>
__host__ __device__ constexpr int runoff_row(int k) {
  return k == kMoistOut ? 0 : NL + k - 1;
}

// runoff.compute_runoff_and_asat (runoff.c:773-814): the saturated area
// and the surface runoff of `inflow` on the infiltration curve over the
// top NL-1 layers, their sums in layer order
struct Arno {
  float asat, runoff;
};

template <int NL>
__device__ __forceinline__ Arno arno_runoff(const float* moist,
                                            const float* mm, float b,
                                            float inflow) {
  float top_max = mm[0], top_moist = moist[0];
#pragma unroll
  for (int l = 1; l < NL - 1; ++l) {
    top_max = top_max + mm[l];
    top_moist = top_moist + moist[l];
  }
  top_moist = nan_min(top_moist, top_max);
  const float ex = b / (1.0f + b);
  const float rel = nan_min(
      nan_max(1.0f - top_moist / nan_max(top_max, 1e-10f), 0.0f), 1.0f);
  const float asat = 1.0f - powf(rel, ex);
  const float max_infil = (1.0f + b) * top_max;
  const float i0 =
      max_infil * (1.0f - powf(nan_min(nan_max(1.0f - asat, 0.0f), 1.0f),
                               rdiv_s(1.0f, b)));
  const float basis = nan_min(
      nan_max(1.0f - (i0 + inflow) / nan_max(max_infil, 1e-10f), 0.0f),
      1.0f);
  const float runoff_3a = inflow - top_max + top_moist;
  const float runoff_3b = runoff_3a + top_max * powf(basis, 1.0f + b);
  float runoff = (i0 + inflow) > max_infil ? runoff_3a : runoff_3b;
  runoff = max_infil == 0.0f ? inflow : runoff;
  runoff = inflow == 0.0f ? 0.0f : runoff;
  return Arno{asat, nan_max(runoff, 0.0f)};
}

template <int NL>
__global__ void runoff_hourly_kernel(const __grid_constant__ LaneInputs in,
                                     int dt_hours, int n, float* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const LaneRow row = lane_row(in, i);
  float moist[NL], liq[NL], ice[NL], evap[NL], evap_hr[NL], resid[NL],
      mm[NL], ksat[NL], expt[NL];
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    moist[l] = lane_fl(in, kMoist, row, l);
    ice[l] = lane_fl(in, kSoilIce, row, l);
    evap[l] = lane_fl(in, kLayerEvap, row, l);
    mm[l] = lane_fl(in, kMaxMoistL, row, l);
    resid[l] = lane_fl(in, kResidFract, row, l) *
               lane_fl(in, kDepth, row, l) * 1000.0f;
    ksat[l] = lane_fl(in, kKsat, row, l);
    expt[l] = lane_fl(in, kExpt, row, l);
  }
  const float ppt = lane_f(in, kPpt, row), b = lane_f(in, kBInfilt, row);
  const float ds = lane_f(in, kDs, row), ws = lane_f(in, kWs, row);
  const float c_expt = lane_f(in, kCExpt, row);
  const float runoff0 = arno_runoff<NL>(moist, mm, b, ppt).runoff;
  // the hourly rates, as PyTorch divides by a host scalar on the card
  const float hours = static_cast<float>(dt_hours);
  const float dt_runoff = div_s(runoff0, hours), dt_inflow = div_s(ppt, hours);
  const float dsmax_hr = div_s(lane_f(in, kDsmax, row), 24.0f);
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    liq[l] = moist[l] - ice[l];
    evap_hr[l] = div_s(evap[l], hours);
    ksat[l] = div_s(ksat[l], 24.0f);
  }
  constexpr int lb = NL - 1;

  // excess moves up through layers top..0; what leaves layer 0 is runoff
  auto cascade_up = [&](int top, float amount) {
    for (int up = top; up >= 0; --up) {
      liq[up] = liq[up] + amount;
      amount = nan_max(liq[up] + ice[up] - mm[up], 0.0f);
      liq[up] = nan_min(liq[up], mm[up] - ice[up]);
    }
    return amount;
  };

  float runoff_acc = 0.0f, base_acc = 0.0f;
  for (int hour = 0; hour < dt_hours; ++hour) {
    // drainage between layers from the start-of-hour moisture
    float q12[NL - 1];
#pragma unroll
    for (int l = 0; l < NL - 1; ++l) {
      const float tmp_liq = nan_max(liq[l] - evap_hr[l], resid[l]);
      const float frac = nan_min(
          nan_max((tmp_liq - resid[l]) / nan_max(mm[l] - resid[l], 1e-10f), 0.0f),
          1.0f);
      q12[l] = liq[l] > resid[l] ? ksat[l] * powf(frac, expt[l]) : 0.0f;
    }
    float runoff_h = 0.0f;
    float inflow = dt_inflow;
#pragma unroll
    for (int l = 0; l < NL - 1; ++l) {
      const float dro = l == 0 ? dt_runoff : 0.0f;
      liq[l] = liq[l] + (inflow - dro) - (q12[l] + evap_hr[l]);
      const float excess = nan_max(liq[l] + ice[l] - mm[l], 0.0f);
      liq[l] = nan_min(liq[l], mm[l] - ice[l]);
      if (l == 0) {
        q12[0] = q12[0] + excess;
      } else {
        runoff_h = runoff_h + cascade_up(l - 1, excess);
      }
      const float deficit = nan_min(liq[l] + ice[l] - resid[l], 0.0f);
      q12[l] = q12[l] + deficit;
      liq[l] = nan_max(liq[l], resid[l] - ice[l]);
      inflow = q12[l];
    }
    // ARNO baseflow from the bottom layer
    const float rel_moist =
        (liq[lb] - resid[lb]) / nan_max(mm[lb] - resid[lb], 1e-10f);
    float base = dsmax_hr * ds / ws * rel_moist;
    const float over_ws = nan_max((rel_moist - ws) / nan_max(1.0f - ws, 1e-10f),
                                0.0f);
    base = base + (rel_moist > ws ? dsmax_hr * (1.0f - ds / ws) *
                                        powf(over_ws, c_expt)
                                  : 0.0f);
    base = nan_max(base, 0.0f);
    liq[lb] = liq[lb] + q12[lb - 1] - (evap_hr[lb] + base);
    const float deficit = nan_min(liq[lb] + ice[lb] - resid[lb], 0.0f);
    base = base + deficit;
    liq[lb] = nan_max(liq[lb], resid[lb] - ice[lb]);
    const float over = nan_max(liq[lb] + ice[lb] - mm[lb], 0.0f);
    liq[lb] = nan_min(liq[lb], mm[lb] - ice[lb]);
    runoff_h = runoff_h + cascade_up(lb - 1, over);
    runoff_acc = runoff_acc + runoff_h;
    base_acc = base_acc + base;
  }

  // the final moisture and its saturated area with no inflow; a negative
  // total baseflow comes off the bottom layer's evap (runoff.c:704-707)
#pragma unroll
  for (int l = 0; l < NL; ++l) moist[l] = liq[l] + ice[l];
  evap[lb] = evap[lb] + nan_min(base_acc, 0.0f);
  const int64_t n64 = n;
  auto first = [&](int k) { return out + runoff_row<NL>(k) * n64; };
  auto layered = [&](int k, int l) -> float& {
    return first(k)[static_cast<int64_t>(i) * NL + l];
  };
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    layered(kMoistOut, l) = moist[l];
    layered(kLayerEvapOut, l) = evap[l];
  }
  first(kRunoffOut)[i] = runoff0 + runoff_acc;
  first(kBaseflowOut)[i] = nan_max(base_acc, 0.0f);
  first(kAsatOut)[i] = arno_runoff<NL>(moist, mm, b, 0.0f).asat;
}

}  // namespace

extern "C" {

// Replaces vic_tpu/physics/glacier.py:130 (glacier_ablation's
// batched_brent) and the two evaluations of glacier_energy_terms around it
// (the melt test at 0 C and the terms at the accepted temperature). Bound
// by latency: the solved lanes (the glacier HRUs that do not melt at 0 C,
// at most 2 of each cell's 8 lanes: 16% of light's lanes, 9% of
// heavy_nolakes') run 2 to max_iter + 2 dependent residual evaluations (6.3
// on average, 8 at most, on light); every lane reads ~70 B and writes 14
// floats, its flags and the Brent's outputs. One thread a lane left a
// warp's slots 14% used; here the lanes are compacted and dealt to
// persistent threads (lane_brent.cuh), each lane's balance at 0 C formed
// when its thread takes it and its terms when its warp refills, so the
// solved lanes' evaluations run in full warps beside the two every lane
// needs (H100: 0.050 ms of device time on light, the two evaluations and
// 18 MB of outputs included, against 0.033 for the Brent alone one thread
// a lane; PERF.md). 15 float inputs in GlacierResidual
// order after dt, then lo and hi;
// masks: [active]; outputs: the Brent's four, the terms at the accepted
// temperature and melt_mm, surf_temp, cold_content and the vapour loss
// ([14, n], glacier.GlacierEBTerms' order, then GlacierOut's) and
// melt_cond, fbflag ([2, n]). Returns cudaErrorInvalidValue on wrong
// counts, vicbrent::kNoResidentBlock where no block fits on an SM.
int glacier_brent(const int64_t* lanes, int nf, int nm, int h, float dt,
                  int max_iter, int max_tries, int n, float* root,
                  uint8_t* converged, uint8_t* bracketed, int32_t* iterations,
                  float* out, uint8_t* flags, void* stream) {
  LaneInputs in{};
  if (n <= 0 || max_iter < 0 || max_tries < 0 ||
      !fill_lane_inputs(&in, lanes, nf, GlacierLane::kNumIn + 2, nm, 1, h))
    return static_cast<int>(cudaErrorInvalidValue);
  return vicbrent::launch_lane_brent<GlacierLane>(
      in, GlacierParams{dt, n, out, flags}, max_iter, max_tries, n,
      BrentOutputs{root, converged, bracketed, iterations},
      static_cast<cudaStream_t>(stream));
}

// Replaces vic_tpu/physics/snow.py:443 (snow_melt's batched_brent) and the
// two evaluations of snow_energy_terms around it (:387, the melt test at
// 0 C, and :448, the terms at the accepted temperature). Bound by latency:
// the solved lanes (a quarter of the lanes on light) run 2 to ~70 dependent
// residual evaluations and lie scattered among the lanes the melt test,
// thin packs or the mask leave out; every lane reads ~100 B and writes 22
// terms, its melt test and the Brent's outputs. The lanes are compacted and
// dealt to persistent threads (lane_brent.cuh), each lane's balance at 0 C
// formed when its thread takes it. 21 float inputs in SnowpackResidual
// order after dt, then lo and hi; masks: [active, spatial]; outputs: the
// Brent's four, the terms at 0 C and at the accepted temperature
// ([11, n] each, snow.SnowEBTerms' order) and melt_cond. Returns
// cudaErrorInvalidValue on wrong counts, vicbrent::kNoResidentBlock where
// no block fits on an SM.
int snowpack_brent(const int64_t* lanes, int nf, int nm, int h, float dt,
                   int max_iter, int max_tries, int n, float* root,
                   uint8_t* converged, uint8_t* bracketed,
                   int32_t* iterations, float* terms0, float* terms_b,
                   uint8_t* melt_cond, void* stream) {
  LaneInputs in{};
  if (n <= 0 || max_iter < 0 || max_tries < 0 ||
      !fill_lane_inputs(&in, lanes, nf, SnowpackLane::kNumIn + 2, nm, 2, h))
    return static_cast<int>(cudaErrorInvalidValue);
  return vicbrent::launch_lane_brent<SnowpackLane>(
      in, SnowpackParams{dt, n, terms0, terms_b, melt_cond}, max_iter,
      max_tries, n, BrentOutputs{root, converged, bracketed, iterations},
      static_cast<cudaStream_t>(stream));
}

// Replaces vic_tpu/physics/canopy_snow.py:270 (snow_intercept's
// batched_brent). Bound by latency: 2 to ~70 dependent residual
// evaluations a lane, most lanes inactive (no overstory) and the two
// branches of has_csnow; the lanes are compacted and dealt to persistent
// threads (lane_brent.cuh), ~85 B read per active lane. 18 float inputs in
// CanopyResidual order after dt, then lo and hi; masks: [active,
// has_csnow]. Returns cudaErrorInvalidValue on wrong counts,
// vicbrent::kNoResidentBlock where no block fits on an SM.
int canopy_brent(const int64_t* lanes, int nf, int nm, int h, float dt,
                 int max_iter, int max_tries, int n, float* root,
                 uint8_t* converged, uint8_t* bracketed, int32_t* iterations,
                 void* stream) {
  LaneInputs in{};
  if (n <= 0 || max_iter < 0 || max_tries < 0 ||
      !fill_lane_inputs(&in, lanes, nf, CanopyLane::kNumIn + 2, nm, 2, h))
    return static_cast<int>(cudaErrorInvalidValue);
  return vicbrent::launch_lane_brent<CanopyLane>(
      in, CanopyParams{dt}, max_iter, max_tries, n,
      BrentOutputs{root, converged, bracketed, iterations},
      static_cast<cudaStream_t>(stream));
}

// Replaces vic_tpu/physics/runoff.py:171 (runoff_step's hourly fori_loop)
// and the PyTorch around it in runoff_step: the residual moisture, the two
// evaluations of the infiltration curve, the hourly scalings, the final
// moisture, the clamps and the bottom layer's evap (96 launches a call
// before, 1 now). Bound by latency: dt_hours dependent trips of ~20 flops
// and NL-1 + 1 powf a lane, every lane active with the same trip count, so
// one thread a lane and no compaction; ~120 B read and (2 NL + 3) floats
// written a lane. The layered outputs' strided writes do not bound it:
// written layer-major they took the same device time (H100, PERF.md). 14
// float inputs in RunoffIn order, each with its strides; `out` holds
// RunoffResult's fields (RunoffOut), the layered ones [n, NL]. Returns
// cudaErrorInvalidValue on wrong counts or a layer count other than 2 or 3.
int runoff_hourly(const int64_t* lanes, int nf, int h, int nl, int dt_hours,
                  int n, float* out, void* stream) {
  LaneInputs in{};
  if (n <= 0 || dt_hours < 0 ||
      !fill_lane_inputs(&in, lanes, nf, kNumRunoffIn, 0, 0, h))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kBlock - 1) / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nl == 2) {
    runoff_hourly_kernel<2><<<grid, kBlock, 0, s>>>(in, dt_hours, n, out);
  } else if (nl == 3) {
    runoff_hourly_kernel<3><<<grid, kBlock, 0, s>>>(in, dt_hours, n, out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
