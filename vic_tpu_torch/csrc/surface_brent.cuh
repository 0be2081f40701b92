// The soil-surface energy-balance residual of one lane.
//
// A line-for-line copy of vic_tpu_torch/physics/surface.surf_energy_terms(ts)
// .error with the hoisted ET terms of evap.build_evap_pre (penman
// coefficients, ARNO beta, the transpiration split) and the INCLUDE_SNOW
// fold with its blowing-snow flux: func_surf_energy_bal.c:7-397. Ground heat
// comes either from estimate_T1 (QUICK_FLUX, operator(); K5) or from the
// finite-difference node profile at Ts, nodes 1 and 2 (fd(); the profile
// solved at Ts in K7, interpolated between two probes in K14); with
// FROZEN_SOIL either adds the fusion of the top node pair (init_fusion).
// With DIST (DIST_PRCP) the ET is evaluated on the wet and the dry column,
// and the latent term sees mu*evap_wet + (1-mu)*evap_dry
// (canopy_evap.c:124-206). The terms that do not depend on Ts are formed
// once per lane by init(), init_fusion() and init_fd(), in the
// plain version's operation order (divisions by a host scalar as PyTorch
// does them on the card, physics.cuh), so every evaluation repeats the plain
// version's arithmetic on this lane.
#pragma once

#include <cstdint>

#include "lanes.cuh"
#include "physics.cuh"

namespace vicsurf {

using namespace vicphys;

// float inputs, in the order of the wrapper's kernels.SURFACE_INPUTS; the
// layered ones follow them (LaneInputs f[kNumIn + LayerIn])
enum In {
  kTsOld, kT1Old, kT2, kD1, kD2, kKappa1, kKappa2, kCs1, kCs2, kDp,
  kTair, kVpd, kVpAir, kSwNetBare, kLwBareIn, kAirDens, kPressure, kLe,
  kRaUnder, kZRef, kDispl, kRough, kWind, kLai, kWdew, kWdmax, kRarc,
  kRaCanopy, kRainfall, kResid0, kMoist0, kIce0, kMaxMoist0,
  kDepth0, kSnowCov, kSurfAtten, kKappaSnow, kTsnowSurf, kMeltEnergy,
  kIncSwq, kIncSurfWater, kIncDensity, kIncOldTsurf, kIncAdvection0,
  kIncLwSnowIn, kIncNetShortSnowCov, kIncCov, kIncBlowing, kPenSlope,
  kPenLv, kPenGamma, kPenRAir, kArnoBeta, kRc1, kNumIn
};
// layered inputs, NL values a lane (kernels.SURFACE_LAYER_INPUTS)
enum LayerIn { kRoot, kGsm, kRc2, kW1, kCap, kNumLayerIn };
// uint8 masks (kernels.SURFACE_MASKS)
enum Mask { kActive, kInc, kOverSnow, kIsVeg, kCase1, kNumMask };
// DIST_PRCP's dry column follows the layered inputs (kernels.DRY_INPUTS,
// then kernels.DRY_LAYER_INPUTS), its case1 mask the others; without
// DIST_PRCP they are never read
enum DryIn { kWdewDry, kRainfallDry, kMoist0Dry, kIce0Dry, kArnoBetaDry,
             kRc1Dry, kMuWet, kNumDryIn };
enum DryLayerIn { kGsmDry, kRc2Dry, kW1Dry, kCapDry, kNumDryLayerIn };
constexpr int kDryIn = kNumIn + kNumLayerIn;
constexpr int kDryLayerIn = kDryIn + kNumDryIn;
constexpr int kCase1Dry = kNumMask;
// K5's float inputs and masks
constexpr int kNumSurfaceIn = kDryLayerIn + kNumDryLayerIn;
constexpr int kNumSurfaceMask = kNumMask + 1;
// the fusion inputs follow K5's (kernels.FD_SURFACE_INPUTS), and their
// frozen-soil mask K5's masks: K5, K7 and K14 all take them
enum FdIn { kMoist0Vol, kMaxMoist0Vol, kIce0Vol, kBubble0, kExpt0,
            kNumFdIn };
constexpr int kFsActive = kNumSurfaceMask;

// evap.penman with the hoisted coefficients (penman.c:96-143)
__device__ __forceinline__ float penman(float slope, float lv, float gamma,
                                        float r_air, float rad, float vpd,
                                        float ra, float rc, float rarc) {
  const float ra_safe = nan_max(ra, 1e-10f);
  float evap = (slope * rad + r_air * 1013.0f * vpd / ra_safe) /
               (lv * (slope + gamma * (1.0f + (rc + rarc) / ra_safe))) *
               kSecPerDay;
  if (vpd >= 0.0f && evap < 0.0f) evap = 0.0f;
  return evap;
}

// the Ts-independent ET terms of one soil column (evap.build_evap_pre and
// the parts of evap.canopy_evap and evap.arno_evap that do not see Ts)
template <int NL>
struct EtColumn {
  bool case1;
  float beta, rc1;
  float cev_pow, wdew_c, storage, wdew_frac_pow, arno_cap;
  float gsm[NL], rc2[NL], w1[NL], cap[NL];

  // k_gsm: the index of this column's first layered input, in the order
  // gsm, rc2, w1, cap
  __device__ void init(const LaneInputs& inputs, LaneRow row, float dt,
                       float wdew, float wdmax, float rainfall, float moist0,
                       float ice0, float max_moist0, float resid0,
                       float depth0, float beta_, float rc1_, bool case1_,
                       int k_gsm) {
    case1 = case1_;
    beta = beta_;
    rc1 = rc1_;
    // evap.wet_canopy_evap's Ts-independent part
    const float wdmax_safe = nan_max(wdmax, 1e-10f);
    wdew_c = nan_min(wdew, wdmax);
    cev_pow = powf(nan_min(nan_max(wdew_c / wdmax_safe, 0.0f), 1.0f), kTwoThirds);
    storage = dt == kSecPerDay ? wdew_c + rainfall : wdew_c;
    wdew_frac_pow =
        powf(nan_max(wdew, 0.0f) / nan_max(wdmax, 1e-10f), kTwoThirds);
    // evap.arno_evap's Ts-independent part
    const float moist = nan_min(nan_max(moist0 - ice0, 0.0f), max_moist0);
    arno_cap = nan_max(moist - resid0 * depth0 * 1000.0f, 0.0f);
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      gsm[l] = lane_fl(inputs, k_gsm, row, l);
      rc2[l] = lane_fl(inputs, k_gsm + 1, row, l);
      w1[l] = lane_fl(inputs, k_gsm + 2, row, l);
      cap[l] = lane_fl(inputs, k_gsm + 3, row, l);
    }
  }
};

template <int NL, bool DIST>
struct SurfaceResidual {
  float dt;
  int grnd_flux_type;
  bool inc, veg;
  float tair, vpd, vp_air, sw_net_bare, lw_bare_in, air_dens, pressure, le;
  float ra_under, z_ref, d_eff, rough, wind, ra_canopy, rarc;
  // estimate_T1 and ground-flux terms
  float p1, q1, q2, den, ga, gb, t2, cover_atten, cs1, d1, tsum_old;
  float snow_cov, kappa_snow, tsnow_surf, melt_energy;
  // INCLUDE_SNOW pack
  float i_dry, old_tsurf, cov_i, refreeze, advection0, lw_snow_in, nssc;
  float blowing;   // blowing-snow mass flux of the folded pack, kg/m^2/s
  // finite-difference lower flux kappa2/d2 and the top node pair's fusion
  float k2d2;
  bool frozen, fs_active;
  float moist0_vol, max_moist0_vol, ice0_vol, bubble0, expt0;
  // ET: the Penman terms and root fractions the columns share, the wet
  // column, and with DIST the dry one and the wet fraction mu
  float slope, lv, gamma, r_air;
  float root[NL];
  EtColumn<NL> wet;
  EtColumn<NL> dry;
  float mu;

  __device__ void init(const LaneInputs& inputs, LaneRow row, float dt_,
                       int gft) {
    auto in = [&](int k) { return lane_f(inputs, k, row); };
    auto mask = [&](int k) { return lane_m(inputs, k, row); };
    dt = dt_;
    grnd_flux_type = gft;
    inc = mask(kInc);
    const float lai = in(kLai);
    veg = mask(kIsVeg) && lai > 0.0f;
    tair = in(kTair);
    vpd = in(kVpd);
    vp_air = in(kVpAir);
    sw_net_bare = in(kSwNetBare);
    lw_bare_in = in(kLwBareIn);
    air_dens = in(kAirDens);
    pressure = in(kPressure);
    le = in(kLe);
    ra_under = in(kRaUnder);
    z_ref = in(kZRef);
    d_eff = mask(kOverSnow) ? 0.0f : in(kDispl);
    rough = in(kRough);
    wind = in(kWind);
    ra_canopy = in(kRaCanopy);
    rarc = in(kRarc);

    // soil_thermal.estimate_t1's Ts-independent terms (estimate_T1.c)
    const float t1_old = in(kT1Old), d2 = in(kD2), dp = in(kDp);
    const float kappa1 = in(kKappa1), kappa2 = in(kKappa2), cs2 = in(kCs2);
    d1 = in(kD1);
    cs1 = in(kCs1);
    t2 = in(kT2);
    const float c1 = cs2 * dp / d2 * (1.0f - expf(-d2 / dp));
    const float c2 = -(1.0f - expf(d1 / dp)) * expf(-d2 / dp);
    const float c3 = kappa1 / d1 - kappa2 / d1 + kappa2 / d1 * expf(-d1 / dp);
    p1 = kappa1 / 2.0f / d1 / d2;
    q1 = div_s(c1, dt) * t1_old;
    q2 = (2.0f * c2 - 1.0f + expf(-d1 / dp)) * kappa2 / 2.0f / d1 / d2 * t2;
    den = div_s(c1, dt) + kappa2 / d1 / d2 * c2 + c3 / 2.0f / d2;
    ga = kappa1 / d1;
    gb = kappa2 / d2 * (1.0f - expf(-d1 / dp));
    tsum_old = in(kTsOld) + t1_old;

    snow_cov = in(kSnowCov);
    cover_atten = snow_cov + (1.0f - snow_cov) * in(kSurfAtten);
    kappa_snow = in(kKappaSnow);
    tsnow_surf = in(kTsnowSurf);
    melt_energy = in(kMeltEnergy);

    const float i_sw = in(kIncSurfWater);
    i_dry = in(kIncSwq) - i_sw;
    old_tsurf = in(kIncOldTsurf);
    cov_i = in(kIncCov);
    const float rfz_i = div_s(i_sw * kLf * in(kIncDensity), dt);
    refreeze = inc ? rfz_i * cov_i : 0.0f;
    advection0 = in(kIncAdvection0);
    lw_snow_in = in(kIncLwSnowIn);
    nssc = in(kIncNetShortSnowCov);
    blowing = in(kIncBlowing);
    frozen = false;

    slope = in(kPenSlope);
    lv = in(kPenLv);
    gamma = in(kPenGamma);
    r_air = in(kPenRAir);
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      root[l] = lane_fl(inputs, kNumIn + kRoot, row, l);
    }
    const float wdmax = in(kWdmax), max_moist0 = in(kMaxMoist0);
    const float resid0 = in(kResid0), depth0 = in(kDepth0);
    wet.init(inputs, row, dt, in(kWdew), wdmax, in(kRainfall), in(kMoist0),
             in(kIce0), max_moist0, resid0, depth0, in(kArnoBeta), in(kRc1),
             mask(kCase1), kNumIn + kGsm);
    if constexpr (DIST) {
      auto dry_in = [&](int k) { return in(kDryIn + k); };
      dry.init(inputs, row, dt, dry_in(kWdewDry), wdmax,
               dry_in(kRainfallDry), dry_in(kMoist0Dry), dry_in(kIce0Dry),
               max_moist0, resid0, depth0, dry_in(kArnoBetaDry),
               dry_in(kRc1Dry), mask(kCase1Dry), kDryLayerIn + kGsmDry);
      mu = dry_in(kMuWet);
    }
  }

  // FROZEN_SOIL's fusion terms, read when frz (K5, K7, K14)
  __device__ void init_fusion(const LaneInputs& inputs, LaneRow row,
                              bool frz) {
    auto fd_in = [&](int k) {
      return lane_f(inputs, kNumSurfaceIn + k, row);
    };
    frozen = frz;
    fs_active = lane_m(inputs, kFsActive, row);
    moist0_vol = fd_in(kMoist0Vol);
    max_moist0_vol = fd_in(kMaxMoist0Vol);
    ice0_vol = fd_in(kIce0Vol);
    bubble0 = fd_in(kBubble0);
    expt0 = fd_in(kExpt0);
  }

  // the finite-difference terms (K7, K14): the lower flux's kappa2/d2 and
  // the fusion terms
  __device__ void init_fd(const LaneInputs& inputs, LaneRow row, bool frz) {
    k2d2 = lane_f(inputs, kKappa2, row) / lane_f(inputs, kD2, row);
    init_fusion(inputs, row, frz);
  }

  // evap.canopy_evap's total on column `col`, mm/step (canopy_evap.c:46-445)
  __device__ float canopy_evap(float rad, const EtColumn<NL>& col) const {
    const float cev_pow = col.cev_pow, storage = col.storage;
    const float wdew_frac_pow = col.wdew_frac_pow, rc1 = col.rc1;
    const bool case1 = col.case1;
    const float* w1 = col.w1;
    const float* gsm = col.gsm;
    const float* rc2 = col.rc2;
    const float* cap = col.cap;
    float cevap = div_s(cev_pow *
                            penman(slope, lv, gamma, r_air, rad, vpd,
                                   ra_canopy, 0.0f, rarc) *
                            dt,
                        kSecPerDay);
    const float f =
        cevap > 0.0f ? nan_min(storage / nan_max(cevap, 1e-20f), 1.0f) : 1.0f;
    cevap = cevap * f;
    const float trans_factor = 1.0f - f * wdew_frac_pow;
    const float evap1 =
        div_s(penman(slope, lv, gamma, r_air, rad, vpd, ra_canopy, rc1,
                     rarc) *
                  dt,
              kSecPerDay) *
        trans_factor;
    float layer_sum = 0.0f;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      float le_l;
      if (case1) {
        le_l = evap1 * w1[l];
      } else {
        le_l = gsm[l] > 0.0f
                   ? div_s(penman(slope, lv, gamma, r_air, rad, vpd,
                                  ra_canopy, rc2[l], rarc) *
                               dt,
                           kSecPerDay) *
                         root[l] * trans_factor
                   : 0.0f;
      }
      le_l = nan_min(nan_max(le_l, 0.0f), cap[l]);
      layer_sum = l == 0 ? le_l : layer_sum + le_l;
    }
    return cevap + layer_sum;
  }

  // evap.arno_evap from the top layer of column `col`, mm/step
  // (arno_evap.c:61-228)
  __device__ float arno_evap(float rad, float ra_used,
                             const EtColumn<NL>& col) const {
    const float epot = div_s(
        penman(slope, lv, gamma, r_air, rad, vpd, ra_used, 0.0f, 0.0f) * dt,
        kSecPerDay);
    const float evap = epot * col.beta;
    return evap > 0.0f ? nan_min(evap, col.arno_cap) : evap;
  }

  // QUICK_FLUX: estimate_T1 ground heat (func_surf_energy_bal.c:171-181)
  __device__ float operator()(float ts) const {
    const float t1 = (p1 * ts + q1 + q2) / den;
    return balance(ts, t1, gb * (t2 - t1));
  }

  // finite differences: t1, t2n are nodes 1 and 2 of the profile solved at
  // ts; no exp(-D1/dp) damping (:185-240)
  __device__ float fd(float ts, float t1, float t2n) const {
    return balance(ts, t1, k2d2 * (t2n - t1));
  }

  // fusion of the top node pair's ice (:260-275)
  __device__ float fusion(float tmean, float t1) const {
    const float tavg01 = (tmean + t1) / 2.0f;
    const float unfrozen =
        max_unfrozen(tavg01, max_moist0_vol, bubble0, expt0);
    const float ice_new =
        tavg01 < 0.0f ? nan_max(moist0_vol - unfrozen, 0.0f) : 0.0f;
    float fus = div_s(kNegRhoIceLf * (ice0_vol - ice_new) * d1, dt);
    if (grnd_flux_type == 2) fus = cover_atten * fus;
    return fs_active ? fus : 0.0f;
  }

  __device__ float balance(float ts, float t1, float lower_flux) const {
    const float tmean = ts;
    const float tkelv = tmean + kKelvin;
    const float tk2 = tkelv * tkelv;
    const float tk4 = tk2 * tk2;
    // pack -> soil conduction; none on INCLUDE_SNOW lanes (:148-161)
    const float snow_flux = inc ? 0.0f : kappa_snow * (tsnow_surf - tmean);
    const float grnd_flux =
        grnd_flux_type == 0
            ? cover_atten * (ga * (t1 - tmean))
            : cover_atten * (ga * (t1 - tmean) + lower_flux) / 2.0f;
    // heat storage between nodes 0 and 1 (:249-254)
    float delta_h = div_s(cs1 * (tsum_old - (tmean + t1)) * d1, dt) / 2.0f;
    if (grnd_flux_type == 2) delta_h = cover_atten * delta_h;
    // INCLUDE_SNOW pack cold content (:279-286)
    const float dcc_i = tmean > 0.0f
                            ? div_s(kChIce * i_dry * (0.0f - old_tsurf), dt)
                            : div_s(kChIce * i_dry * (tmean - old_tsurf), dt);
    const float delta_cc = inc ? dcc_i * cov_i : 0.0f;
    // net radiation on the snow-free area (:291-295)
    const float net_long_bare =
        lw_bare_in - (1.0f - snow_cov) * (kStefanB * tk4);
    float net_bare_rad = sw_net_bare + net_long_bare + grnd_flux + delta_h;
    if (frozen) net_bare_rad = net_bare_rad + fusion(tmean, t1);
    // stability-corrected resistance (:298-310)
    const float ra_used =
        wind > 0.0f ? ra_under / stability_correction(z_ref, d_eff, tmean,
                                                      tair, wind, rough)
                    : kHugeResist;
    // evapotranspiration inside the residual (:320-336)
    float evap = veg ? canopy_evap(net_bare_rad, wet)
                     : arno_evap(net_bare_rad, ra_used, wet);
    if constexpr (DIST) {
      const float evap_d = veg ? canopy_evap(net_bare_rad, dry)
                               : arno_evap(net_bare_rad, ra_used, dry);
      evap = mu * evap + (1.0f - mu) * evap_d;
    }
    // latent heat (:339-363)
    float latent =
        -kRhoW * le * div_s(div_s(evap, 1000.0f), dt) * (1.0f - snow_cov);
    float latent_sub = 0.0f;
    if (inc) {
      // snow.latent_heat_from_snow at the surface resistance, plus the
      // blowing-snow flux
      float vf = air_dens * rdiv_s(kEpsRatio, pressure) *
                 (vp_air - svp(tmean)) / ra_used;
      if (vpd == 0.0f && vf < 0.0f) vf = 0.0f;
      vf = vf + blowing;
      latent = (tmean >= 0.0f ? le * vf : 0.0f) * cov_i;
      latent_sub = (tmean >= 0.0f ? 0.0f : ls_of(tmean) * vf) * cov_i;
    }
    // sensible heat (:366-372); unscaled on INCLUDE_SNOW lanes
    const float sensible_raw = air_dens * kCp * (tair - tmean) / ra_used;
    float sensible =
        snow_cov >= 1.0f ? 0.0f : sensible_raw * (1.0f - snow_cov);
    if (inc) sensible = sensible_raw;

    float error = net_bare_rad + sensible + latent + latent_sub +
                  snow_flux * snow_cov - delta_cc;
    error = error + melt_energy;
    if (!inc) return error;
    // pack terms of the joint balance (:378-387), refreeze two-pass at
    // TMean == 0 (:388-397)
    const float nls_i = lw_snow_in - cov_i * kStefanB * tk4;
    error = error + (advection0 + nssc + nls_i - melt_energy);
    if (tmean == 0.0f && error > -refreeze) return 0.0f;
    return error + refreeze;
  }
};

}  // namespace vicsurf
