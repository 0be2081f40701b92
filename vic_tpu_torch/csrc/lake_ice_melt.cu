// K12 lake_ice_melt: the snow over lake ice of every lake in one launch,
// its subfreezing surface temperature an expand-then-Brent on the lane
// driver (csrc/lane_brent.cuh), for sm_90a.
//
// Replaces vic_tpu/physics/lake.py:805 (lake_ice_melt) with its Brent
// (:960, the batched_brent over the whole [n_cell] batch, max_iter 30 after
// up to MAXTRIES bracket expansions, the residual ice_energy_terms(t).rest
// of lake.py:752).
//
// What bounds it on this card. The Brent's bytes (~90 B read and ~10 B
// written a lake) and its ~40 residual evaluations on the few lakes that
// solve are microseconds; before this kernel the call was one
// Brent launch, one thread a lake (a one-thread Brent, now retired), inside
// ~250 lines of elementwise PyTorch (lake.py's lake_ice_melt: the fresh
// snow's distribution, icerad, two whole ice_energy_terms evaluations with
// their stability corrections, the two melt branches and the re-layering),
// hundreds of tiny launches whose host dispatch set the call's time.
//
// What this design does about it: the whole of lake_ice_melt is one launch
// on the lane driver, the lake's IceLane:
// - its prologue (lake.py lake_ice_melt_plain up to the solve) forms the
//   fresh snowfall's distribution and cold contents, icerad, the balance
//   at 0 C, the melt test and the thin test, writes sw_under_ice, and takes
//   melting, thin and masked-out lakes out of the solve;
// - bracket() starts the Brent at old_tsurf -/+ SNOW_DT;
// - its epilogue (after the solve) takes the accepted temperature (0 C
//   where the surface melts, else the root where it converged on a pack
//   that is not thin, else old_tsurf: TFALLBACK), the balance there, the
//   melt branch (A) or the refreeze branch (B), the liquid capacity and the
//   pack refreeze, the re-layering around MAX_SURFACE_SWE, and writes every
//   field of physics.lake.IceMeltResult.
// The residual is IceResidual, the ice balance's rest at t (the code that
// was K12's one-thread residual, its terms() now also the balance's other
// fields); a lane's root, flags and iterations are the one-thread Brent's
// bit for bit, BrentLane being that Brent cut at its evaluations.
//
// The prologue and epilogue repeat the plain version's elementwise PyTorch
// as it runs on the card: a tensor divided by a Python float as the product
// with the reciprocal PyTorch forms (div_py below; div_s where the two
// forms agree), maximum/minimum/clamp as nan_max/nan_min, products of
// Python constants folded in double; the residual keeps its true
// divisions, as it had them.
//
// C interface for ctypes: returns cudaGetLastError(), cudaErrorInvalidValue
// on wrong counts, vicbrent::kNoResidentBlock where no block fits on an SM.

#include <cuda_runtime.h>

#include <cstdint>

#include "brent.cuh"
#include "lane_brent.cuh"
#include "lanes.cuh"
#include "physics.cuh"

namespace {

using namespace vicphys;

constexpr float kSmall = 1.0e-12f;
constexpr float kMsw = 0.125f;              // MAX_SURFACE_SWE (m)
constexpr float kSnowDt = 5.0f;             // SNOW_DT, the bracket (C)
constexpr float kMinSwqEbThres = 0.0010f;   // MIN_SWQ_EB_THRES (m)
constexpr float kLiquidCap = 0.035f;        // SNOW_LIQUID_WATER_CAPACITY
constexpr float kRhoSnow = 250.0f;          // RHOSNOW over lake ice
constexpr float kA1 = 0.7f;                 // SW fraction, visible
constexpr float kA2 = 0.3f;                 // SW fraction, NIR
// icerad's extinctions and conductivities (W/m/K), and the Python products
// the plain version divides by, in double as Python forms them
constexpr float kLamSSw = 6.0f, kLamSLw = 20.0f;   // snow, 1/m
constexpr float kLamISw = 1.5f, kLamILw = 20.0f;   // ice, 1/m
constexpr float kCondI = 2.3f, kCondS = 0.7f;
constexpr double kCondIS = 2.3 * 0.7;
constexpr double kCondSLamSSw = 0.7 * 6.0;
constexpr double kCondILamISw = 2.3 * 1.5;
constexpr double kCondSLamSLw = 0.7 * 20.0;
constexpr double kCondILamILw = 2.3 * 20.0;
constexpr double kLfRhoW = 3.337e5 * 999.842594;

// A tensor divided by a Python float on the card: PyTorch multiplies by the
// double scalar's reciprocal rounded to float. That is not always the
// reciprocal of the scalar's float rounding, which physics.cuh's div_s
// takes: for 0.7 * 6.0 and LF * RHO_W the two differ by an ulp (H100,
// tools/probe_ice_prologue.py), so the prologue and epilogue divide so.
__device__ __forceinline__ float div_py(float x, double s) {
  return x * static_cast<float>(1.0 / s);
}

// physics.lake.IceEBTerms
struct IceTerms {
  float rest, refreeze_energy, vapor_flux, latent, latent_sub, sensible,
      advection, qf, lwnet;
};

// physics.lake.ice_energy_terms at t; the residual is terms(t).rest
struct IceResidual {
  float dt, ra, z_ref, roughness, wind, net_short, longwave_in, air_dens,
      lv, tair, pressure, vpd, vp_air, rain_m, surf_water, tcutoff, avgcond,
      sw_conducted, blowing_flux;

  __device__ __forceinline__ IceTerms terms(float t) const {
    const float ra_corr =
        wind > 0.0f
            ? ra / stability_correction(z_ref, 0.0f, t, tair, wind, roughness)
            : kHugeResist;
    const float lwnet = longwave_in - kStefanB * pow4(t + kKelvin);
    const float net_rad = net_short + lwnet;
    const float sensible = air_dens * kCp * (tair - t) / ra_corr;
    const SnowLatent lh = latent_heat_from_snow(air_dens, vp_air, lv,
                                                pressure, ra, t, vpd,
                                                blowing_flux);
    const float advection = div_s(kChWater * tair * rain_m, dt);
    const float qnull = (tcutoff - t + sw_conducted) / nan_max(avgcond, kSmall);
    const float rest = net_rad + sensible + lh.latent + lh.latent_sub +
                       advection + qnull;
    const float refreeze = div_s(surf_water * kLf * kRhoW, dt);
    const bool melt = t == 0.0f && rest > -refreeze;
    return IceTerms{melt ? 0.0f : rest + refreeze,
                    melt ? -rest : refreeze,
                    div_s(lh.vapor_flux * dt, kRhoW),
                    lh.latent,
                    lh.latent_sub,
                    sensible,
                    advection,
                    qnull,
                    lwnet};
  }

  __device__ float operator()(float t) const { return terms(t).rest; }
};

// the float inputs, in the order of kernels.ICE_MELT_INPUTS; mask: active
enum In {
  kSwq, kSurfTemp, kPackTemp, kSurfWater, kPackWater, kLakeIce, kHice,
  kRainMm, kSnowMm, kTair, kWind, kVpAir, kVpd, kPressure, kAirDens,
  kLongwave, kNetShort, kTcutoff, kRa, kZRef, kRough, kBlowing, kNumIn
};

namespace ice_rows {
// the terms written a lake, n floats each: physics.lake.IceEBTerms' fields
enum IceTerm {
  kRest, kRefreezeEnergy, kVaporFlux, kLatent, kLatentSub, kSensible,
  kAdvection, kQf, kLwnet, kNumTerms
};
// the other floats written a lake, after the terms (kernels.ICE_MELT_OUTPUTS)
enum IceOut {
  kSwqOut, kSurfTempOut, kPackTempOut, kSurfWaterOut, kPackWaterOut, kMeltM,
  kIceMeltM, kLakeIceOut, kVaporOut, kColdContent, kSwUnderIce, kNumOut
};
}  // namespace ice_rows
namespace ir = ice_rows;

struct IceMeltParams {
  float dt;
  int n;
  float* out;      // [ir::kNumTerms + ir::kNumOut, n]
  uint8_t* flags;  // [1, n]: surf_temp_fbflag
};

struct IceLane : IceResidual {
  static constexpr int kActive = 0;
  static constexpr int kMinBlocks = 1;
  // what the epilogue reads of the prologue's state (the pack after the
  // fresh snow, surf_water after the rain is IceResidual's)
  float old_tsurf, surface_swq, pack_swq, pack_ice, pack_temp, snow_ice, ice,
      pack_water, lake_ice_m;
  bool melt, thin;

  __device__ __forceinline__ void init(const LaneInputs&, LaneRow,
                                       const IceMeltParams& p) {
    dt = p.dt;
  }

  // lake_ice_melt_plain up to the solve (lake.py: the fresh snowfall's
  // distribution, icerad, the balance at 0 C, the melt and thin tests)
  __device__ bool prologue(const LaneInputs& in, LaneRow row, int lane,
                           bool active, const IceMeltParams& p) {
    auto f = [&](int k) { return lane_f(in, k, row); };
    const float snowfall = div_s(f(kSnowMm), 1000.0f);
    const float rainfall = div_s(f(kRainMm), 1000.0f);
    const float surf_temp = f(kSurfTemp);
    old_tsurf = surf_temp;
    pack_water = f(kPackWater);
    lake_ice_m = f(kLakeIce);
    tair = f(kTair);
    float sw = f(kSurfWater);
    snow_ice = f(kSwq) - pack_water - sw;
    ice = snow_ice + lake_ice_m;
    surface_swq = nan_min(ice, kMsw);
    const bool surf_covers = surface_swq <= snow_ice;
    pack_swq = surf_covers ? snow_ice - surface_swq : 0.0f;
    pack_ice = surf_covers ? lake_ice_m : ice - surface_swq;

    const float surface_cc = kChIce * surface_swq * surf_temp;
    float pack_cc = kChIce * (pack_swq + pack_ice) * f(kPackTemp);
    const float snowfall_cc = tair > 0.0f ? 0.0f : kChIce * snowfall * tair;

    // distribute fresh snowfall (ice_melt.c:232-258)
    const bool spill = snowfall > (kMsw - surface_swq);
    const float delta_pack_swq =
        spill ? surface_swq + snowfall - kMsw : 0.0f;
    const float delta_pack_cc =
        spill ? (delta_pack_swq > surface_swq
                     ? surface_cc + (snowfall - kMsw) /
                                        nan_max(snowfall, kSmall) *
                                        snowfall_cc
                     : delta_pack_swq / nan_max(surface_swq, kSmall) *
                           surface_cc)
              : 0.0f;
    surface_swq = spill ? kMsw : surface_swq + snowfall;
    pack_swq = pack_swq + delta_pack_swq;
    pack_cc = pack_cc + delta_pack_cc;
    pack_temp = pack_swq + pack_ice > 0.0f
                    ? pack_cc / (kChIce * nan_max(pack_swq + pack_ice, kSmall))
                    : 0.0f;
    snow_ice = snow_ice + snowfall;
    ice = ice + snowfall;
    sw = sw + rainfall;

    // icerad (lakes.eb.c:1092) under snow hs = snow_ice * RHO_W / RHOSNOW
    const float net_short_ = f(kNetShort);
    const float hi = f(kHice);
    const float hs = div_s(snow_ice * kRhoW, kRhoSnow);
    const float e_ssw = expf(-kLamSSw * hs);
    const float e_slw = expf(-kLamSLw * hs);
    const float a = div_py(-1.0f * (1.0f - e_ssw), kCondSLamSSw);
    const float b =
        div_py(-1.0f * e_ssw * (1.0f - expf(-kLamISw * hi)), kCondILamISw);
    const float cc = div_py(-1.0f * (1.0f - e_slw), kCondSLamSLw);
    const float d =
        div_py(-1.0f * e_slw * (1.0f - expf(-kLamILw * hi)), kCondILamILw);
    p.out[(ir::kNumTerms + ir::kSwUnderIce) * p.n + lane] =
        kA1 * net_short_ *
            (1.0f - expf(-(kLamSSw * hs + kLamISw * hi))) +
        kA2 * net_short_ * (1.0f - expf(-(kLamSLw * hs + kLamILw * hi)));

    // the balance's inputs (lake_ice_melt_plain's term_kwargs)
    ra = f(kRa);
    z_ref = f(kZRef);
    roughness = f(kRough);
    wind = f(kWind);
    net_short = net_short_;
    longwave_in = f(kLongwave);
    air_dens = f(kAirDens);
    lv = ls_of(tair);
    pressure = f(kPressure);
    vpd = f(kVpd);
    vp_air = f(kVpAir);
    rain_m = rainfall;
    surf_water = sw;
    tcutoff = f(kTcutoff);
    avgcond = div_py(hs * kCondI + hi * kCondS, kCondIS);
    sw_conducted = net_short_ * kA1 * (a + b) + net_short_ * kA2 * (cc + d);
    blowing_flux = f(kBlowing);

    melt = terms(0.0f).rest == 0.0f;
    thin = surface_swq <= kMinSwqEbThres;
    return active && !melt && !thin;
  }

  __device__ __forceinline__ void bracket(float* lo, float* hi) const {
    *lo = old_tsurf - kSnowDt;
    *hi = old_tsurf + kSnowDt;
  }

  // lake_ice_melt_plain after the solve: the accepted temperature, the
  // branch it selects, the liquid capacity and pack refreeze, the
  // re-layering; every output of the lake
  __device__ void epilogue(const LaneInputs&, LaneRow, int lane,
                           const BrentOut& out,
                           const IceMeltParams& p) const {
    const bool ok = out.converged && !thin;
    const float t_acc = melt ? 0.0f : (ok ? out.root : old_tsurf);
    const IceTerms t = terms(t_acc);
    float s_surface_swq, s_pack_swq, s_surf_water, s_pack_water, s_snow_ice,
        s_lake_ice, s_pack_ice, s_ice, s_surf_temp, s_pack_temp, s_vapor,
        s_ice_melt;
    if (melt) {
      // branch A: surface at 0 C, melt/refreeze (ice_melt.c:309-410)
      const float refreeze = t.refreeze_energy;
      const float refrozen = nan_min(
          nan_max(div_py(refreeze * dt, kLfRhoW), 0.0f), surf_water);
      const bool freezing = refreeze >= 0.0f;
      const float refz = freezing ? refrozen : 0.0f;
      const float a_surface_swq = surface_swq + refz;
      const float a_snow_ice = snow_ice + refz;
      const float a_ice = ice + refz;
      float a_surf_water = nan_max(surf_water - refz, 0.0f);
      const float snowmelt =
          freezing ? 0.0f : div_py(fabsf(refreeze) * dt, kLfRhoW);
      const float vflux = t.vapor_flux;
      const float vflux_a = a_surf_water < -vflux ? -a_surf_water : vflux;
      a_surf_water = nan_max(a_surf_water + vflux_a, 0.0f);
      const bool case1 = snowmelt <= pack_swq;
      const bool case2 = !case1 && snowmelt <= a_snow_ice;
      const bool case3 = !case1 && !case2 && snowmelt < a_ice;
      const bool complete = !case1 && !case2 && !case3;
      const float icemelt3 = snowmelt - a_snow_ice;
      const bool above = a_surface_swq > snowmelt;
      s_surface_swq =
          case1 ? a_surface_swq
                : (case2 ? a_surface_swq - (snowmelt - pack_swq)
                         : (case3 ? (above ? a_surface_swq - snowmelt : 0.0f)
                                  : 0.0f));
      s_pack_swq = case1 ? pack_swq - snowmelt : 0.0f;
      s_surf_water =
          case1 ? a_surf_water + snowmelt
                : (case2 ? a_surf_water + snowmelt + pack_water
                         : a_surf_water + a_snow_ice + pack_water);
      s_pack_water = case1 ? pack_water : 0.0f;
      s_snow_ice = case1 || case2 ? a_snow_ice - snowmelt : 0.0f;
      s_lake_ice = case3 ? lake_ice_m - icemelt3
                         : (complete ? 0.0f : lake_ice_m);
      s_pack_ice = case3 ? (above ? pack_ice
                                  : pack_ice - (snowmelt - a_surface_swq))
                         : (complete ? 0.0f : pack_ice);
      s_ice = complete ? 0.0f : a_ice - snowmelt;
      s_surf_temp = 0.0f;
      s_pack_temp = complete ? 0.0f : pack_temp;
      s_vapor = vflux_a;
      s_ice_melt = case3 ? icemelt3 : (complete ? lake_ice_m : 0.0f);
    } else {
      // branch B: subfreezing surface, all surface liquid refreezes
      // (ice_melt.c:425-520)
      const float b_surface_swq = surface_swq + surf_water;
      const float b_snow_ice = snow_ice + surf_water;
      const float b_ice = ice + surf_water;
      const float bv = t.vapor_flux;
      const bool exceeds = b_surface_swq < -bv;
      const bool surf_over_snow = b_surface_swq > b_snow_ice;
      const bool snow_has = b_snow_ice > -bv;
      s_surface_swq = nan_max(
          exceeds ? (surf_over_snow ? b_surface_swq : 0.0f)
                  : b_surface_swq + bv,
          0.0f);
      s_pack_swq = pack_swq;
      s_surf_water = 0.0f;
      s_pack_water = pack_water;
      s_snow_ice = exceeds ? (surf_over_snow ? 0.0f : b_snow_ice)
                           : (snow_has ? b_snow_ice + bv : 0.0f);
      s_lake_ice = nan_max(
          exceeds ? (surf_over_snow
                         ? lake_ice_m - (b_surface_swq - b_snow_ice)
                         : lake_ice_m)
                  : (snow_has ? lake_ice_m : lake_ice_m + (bv + b_snow_ice)),
          0.0f);
      s_pack_ice = pack_ice;
      s_ice = nan_max(exceeds ? (surf_over_snow ? pack_ice
                                                : pack_swq + pack_ice)
                              : b_ice + bv,
                      0.0f);
      s_surf_temp = t_acc;
      s_pack_temp = pack_temp;
      s_vapor = exceeds ? -b_surface_swq : bv;
      s_ice_melt = 0.0f;
    }

    // liquid capacity and pack refreeze (ice_melt.c:528-590)
    const float max_liquid = kLiquidCap * nan_min(s_snow_ice, s_surface_swq);
    float melt_out = nan_max(s_surf_water - max_liquid, 0.0f);
    const float surf_water_f = nan_min(s_surf_water, max_liquid);
    float pw = s_pack_water + melt_out;
    float pack_cc = kChIce * (s_pack_swq + s_pack_ice) * s_pack_temp;
    const float pack_refreeze_e = pw * kLf * kRhoW;
    const bool cold_enough = pack_cc < -pack_refreeze_e;
    const float pack_swq_f = s_pack_swq + pw;
    const float pack_cc_f = pack_cc + pack_refreeze_e;
    const float pack_temp_f =
        pack_swq_f + s_pack_ice > 0.0f
            ? nan_min(pack_cc_f / (kChIce * nan_max(pack_swq_f + s_pack_ice,
                                                    kSmall)),
                      0.0f)
            : 0.0f;
    const float delta_pack = div_py(-pack_cc, kLfRhoW);
    float ps = cold_enough ? pack_swq_f : s_pack_swq + delta_pack;
    const float snow_ice_f =
        cold_enough ? s_snow_ice + pw : s_snow_ice + delta_pack;
    pw = cold_enough ? 0.0f : nan_max(pw - delta_pack, 0.0f);
    float pt = cold_enough ? pack_temp_f : 0.0f;
    const float max_liquid_pack = kLiquidCap * ps;
    melt_out = nan_max(pw - max_liquid_pack, 0.0f);
    pw = nan_min(pw, max_liquid_pack);

    // re-layer around MAX_SURFACE_SWE (ice_melt.c:593-625)
    float ss = s_surface_swq, pi = s_pack_ice, st = s_surf_temp;
    const bool deep = pi + ps + ss > kMsw;
    const float surface_cc = kChIce * st * ss;
    pack_cc = kChIce * pt * (ps + pi);
    const float excess = ss - kMsw;
    const float frac_s = excess / nan_max(ss, kSmall);
    const float deficit = kMsw - ss;
    const float frac_p = deficit / nan_max(ps + pi, kSmall);
    const bool too_thick = ss > kMsw;
    const bool exact = ss == kMsw;
    const float surface_swq_d = exact ? ss : kMsw;
    const float pack_swq_d =
        exact ? ps : (too_thick ? ps + excess : ps - deficit);
    const float surface_cc_d =
        exact ? surface_cc
              : (too_thick ? surface_cc * (1.0f - frac_s)
                           : surface_cc + pack_cc * frac_p);
    const float pack_cc_d =
        exact ? pack_cc
              : (too_thick ? pack_cc + surface_cc * frac_s
                           : pack_cc * (1.0f - frac_p));
    ss = deep ? surface_swq_d : ss;
    ps = deep ? nan_max(pack_swq_d, 0.0f) : 0.0f;
    pi = deep ? pi : 0.0f;
    st = deep ? surface_cc_d / (kChIce * nan_max(surface_swq_d, kSmall)) : st;
    pt = deep ? pack_cc_d / (kChIce * nan_max(pack_swq_d + pi, kSmall))
              : 0.0f;

    float* col = p.out + lane;
    const int n = p.n;
    col[ir::kRest * n] = t.rest;
    col[ir::kRefreezeEnergy * n] = t.refreeze_energy;
    col[ir::kVaporFlux * n] = t.vapor_flux;
    col[ir::kLatent * n] = t.latent;
    col[ir::kLatentSub * n] = t.latent_sub;
    col[ir::kSensible * n] = t.sensible;
    col[ir::kAdvection * n] = t.advection;
    col[ir::kQf * n] = t.qf;
    col[ir::kLwnet * n] = t.lwnet;
    col += ir::kNumTerms * n;
    col[ir::kSwqOut * n] = nan_max(snow_ice_f + surf_water_f + pw, 0.0f);
    col[ir::kSurfTempOut * n] = st;
    col[ir::kPackTempOut * n] = pt;
    col[ir::kSurfWaterOut * n] = surf_water_f;
    col[ir::kPackWaterOut * n] = pw;
    col[ir::kMeltM * n] = melt_out;
    col[ir::kIceMeltM * n] = s_ice_melt;
    col[ir::kLakeIceOut * n] = nan_max(s_lake_ice, 0.0f);
    col[ir::kVaporOut * n] = -s_vapor;
    col[ir::kColdContent * n] = kChIce * st * ss;
    p.flags[lane] = !ok && !melt;
  }
};

}  // namespace

extern "C" {

// Replaces vic_tpu/physics/lake.py:805 (lake_ice_melt, its Brent :960). 22
// float inputs in In order (kernels.ICE_MELT_INPUTS); masks: [active];
// dt_sec; the Brent's counts; outputs: the Brent's four, the terms at the
// accepted temperature and the other fields of IceMeltResult
// ([ir::kNumTerms + ir::kNumOut, n], IceEBTerms' order, then IceOut's) and
// surf_temp_fbflag ([1, n]).
int lake_ice_melt(const int64_t* lanes, int nf, int nm, int h, float dt,
                  int max_iter, int max_tries, int n, float* root,
                  uint8_t* converged, uint8_t* bracketed, int32_t* iterations,
                  float* out, uint8_t* flags, void* stream) {
  LaneInputs in{};
  if (n <= 0 || max_iter < 0 || max_tries < 0 ||
      !fill_lane_inputs(&in, lanes, nf, kNumIn, nm, 1, h))
    return static_cast<int>(cudaErrorInvalidValue);
  return vicbrent::launch_lane_brent<IceLane>(
      in, IceMeltParams{dt, n, out, flags}, max_iter, max_tries, n,
      BrentOutputs{root, converged, bracketed, iterations},
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
