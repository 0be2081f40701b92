// K10 lake_open_water: the open-water column's skin-temperature fixed point
// and the convective mix of its result, one warp per lake, for sm_90a.
//
// Replaces vic_tpu/physics/lake.py:584 (water_energy_balance, a
// lax.while_loop of up to 50 iterations over the whole [n_cell, 20] batch,
// each iteration latsens + lkdrag, the eddy diffusivity, temp_area with its
// Thomas solve, iceform and energycalc) and the tracer_mixer solve_lake
// applies to its column on every cell (lake.py:1336-1337). The TPU loop ran
// every lane until the slowest converged; here each warp stops its own
// lake at |tmean - ts| <= 1e-4 or 50 iterations, which gives the batched
// loop's result exactly, since a done lane keeps its outputs and its ts
// there. What changes between iterations is only the surface force, so the
// eddy diffusivity, the matrix and its elimination are formed once per
// lake (lake.cuh TempArea) and each iteration is a forward and a back
// substitution over the 20 layers.
//
// The design (lake.cuh): layer k of a lake on lane k, in registers; the
// per-layer set-up (density, heat capacity, the eddy diffusivity with the
// lake's ks and ws formed on every lane, the shortwave extinction, the
// matrix) in parallel across the lanes; each iteration the fluxes (their
// ts-independent part formed once, Met), the two Thomas recurrences on
// lane 0 over the rows the lanes left in the warp's shared memory and the
// column's energy as an ordered chain of broadcasts; the final mix pass by pass across the lanes, stopped after
// its first sweep that mixes no pair. Persistent blocks deal the lakes to
// their warps; a lake without open water is mixed and written at once
// (its column, zeros, converged, 0 iterations, the mixed column as t_open).
// A lake reads ~0.4 KB and writes ~0.2 KB; the device time is the warps'
// serial chains.
//
// C interface for ctypes (lanes.cuh): float inputs temp, z, zhalf (20
// layers), surface (21), surfdz, dz, lat, tcutoff, tair, wind, pressure,
// vp, air_density, longwave, shortwave_net, wind_h, fracprv, lvolume; masks
// active, mask (20), last (20). Outputs: temp and t_open [n, 20]; sc rows
// qh, qle, lwnet, delta_h, energy_ice_formation, new_ice_area,
// new_ice_height, new_ice_water_eq, evap_mm_s, energy_out_bottom [10, n];
// converged [n]; the iterations each lake ran [n]. Returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "lake.cuh"
#include "lanes.cuh"
#include "physics.cuh"

namespace {

using namespace vicphys;
using namespace vlake;

constexpr int kNumIn = 18;
constexpr int kNumMask = 3;
constexpr int kNumOut = 10;
enum In { kTemp, kZ, kZhalf, kSurface, kSurfdz, kDz, kLat, kTcutoff, kTair,
          kWind, kPressure, kVp, kAirDensity, kLongwave, kShortwaveNet,
          kWindH, kFracprv, kLvolume };
constexpr float kZWater = 0.0045f;
constexpr float kEmSb = static_cast<float>(0.98 * 5.6696e-8);
constexpr float kPi = static_cast<float>(3.141592653589793);

struct Fluxes {
  float evap, qh, qle, lwnet;
};

// fluxes(ts) of water_energy_balance: latsens and lkdrag (lakes.eb.c:543,
// 1263) over open water (hice = 0), what does not depend on ts formed once
// a lake, by the same operations
struct Met {
  float tair, wind, pressure, vp, air_density, longwave, wind_h, tcutk;
  float tair_k, cdrn, cdrmin, ribd_stable, ribd_unstable, qair, le;

  __device__ Met(float tair_, float wind_, float pressure_, float vp_,
                 float air_density_, float longwave_, float wind_h_,
                 float tcutk_)
      : tair(tair_), wind(wind_), pressure(pressure_), vp(vp_),
        air_density(air_density_), longwave(longwave_), wind_h(wind_h_),
        tcutk(tcutk_) {
    tair_k = tair + kKelvin;
    const float logzr = logf(wind_h / kZWater);
    cdrn = rdiv_s(kVonK, logzr);
    cdrn = cdrn * cdrn;
    cdrmin = nan_max(0.25f * cdrn, 6.0e-4f);
    ribd_stable = wind * wind + 0.01f;
    ribd_unstable = wind * wind + 1.0f;
    qair = 0.622f * vp / nan_max(pressure - 0.378f * vp, 1.0f);
    le = (2.501f - 0.002361f * tair) * 1.0e6f;
  }

  // lkdrag at the surface temperature tsurf_k (K)
  __device__ float drag(float tsurf_k) const {
    const float ribn = wind_h * kG * (1.0f - tsurf_k / tair_k);
    const float ribd = tsurf_k / tair_k <= 1.0f ? ribd_stable
                                                : ribd_unstable;
    const float rib = ribn / nan_max(ribd, kSmall);
    const float cdr =
        rib < 0.0f
            ? cdrn * (1.0f + 24.5f * sqrtf(nan_max(-cdrn * rib, 0.0f)))
            : cdrn / (1.0f + 11.5f * rib);
    return nan_max(cdr, cdrmin);
  }

  __device__ Fluxes at(float ts) const {
    const float tskin = ts + kKelvin;
    const float d = drag(tskin);
    const float ts_c = tskin - kKelvin;
    const float eog =
        tskin > tcutk ? 611.0f * expf(17.269f * ts_c / (ts_c + 237.3f))
                      : 611.0f * expf(21.874f * ts_c / (tskin - 7.66f));
    const float qlake = 0.622f * eog / nan_max(pressure - 0.378f * eog, 1.0f);
    const float delq = qair - qlake;
    const float evap = -1.0f * d * wind * air_density * delq;
    const float qsen = d * wind * air_density * kCp * (tair_k - tskin);
    return Fluxes{evap, qsen, -1.0f * evap * le,
                  longwave - kEmSb * pow4(tskin)};
  }
};

// eddy_diffusivity with freezeflag true (lakes.eb.c:837-935): the lane's
// layer's diffusivity, layer 19 taking layer 18's (the lake's ks and ws
// formed on every lane)
__device__ __forceinline__ float eddy(float rho, float wind_in, float lat,
                                      const Layer& l) {
  const float wind = nan_max(wind_in, 1.0f);
  const float ks = 6.6f * sqrtf(sinf(div_s(fabsf(lat) * kPi, 180.0f))) *
                   powf(wind, -1.84f);
  const float ws = 0.0012f * wind;
  const float rho_below = __shfl_down_sync(kAll, rho, 1);
  const float dpdz = (rho_below - rho) / l.zhalf;
  const float n2 = dpdz / (1.0e3f + rho) * 9.8f;
  const float z = l.surfdz + static_cast<float>(l.k) * l.dz;
  const float ksz = nan_min(ks * z, 30.0f);
  const bool deep = z * expf(ksz) / ws > 1.0e8f;
  const float vkz = kVonK * z;
  float rad =
      1.0f + 40.0f * n2 * (vkz * vkz) / (ws * ws * expf(-2.0f * ksz));
  rad = deep ? 4.0e4f : rad;
  rad = nan_min(nan_max(rad, 1.0f), 4.0e4f);
  const float ri = div_s(-1.0f + sqrtf(rad), 20.0f);
  const float de = kDM + div_s(kVonK * ws * z, 1.0f) * expf(-ks * z) /
                             (1.0f + 37.0f * ri * ri);
  const float de_above_last = bcast(de, kNN - 2);
  return l.k < kNN - 1 ? de : (l.k == kNN - 1 ? de_above_last : kDM);
}

__global__ void __launch_bounds__(kLakeBlock)
    lake_open_water_kernel(const __grid_constant__ LaneInputs in, float dt,
                           int n, int chunk, float* temp_out, float* t_open,
                           float* sc, uint8_t* converged,
                           int32_t* iterations) {
  for_each_lake(n, chunk, [&](int i, int k, Rows* rows) {
    const LaneRow row = lane_row(in, i);
    auto f = [&](int j) { return lane_f(in, j, row); };
    const bool layer = k < kNN;
    const int64_t at = static_cast<int64_t>(i) * kNN + k;
    // every input read at once (the lake's values on every lane)
    const Layer l = load_layer(in, row, kZ, 1, k);
    const float temp = layer ? lane_fl(in, kTemp, row, k) : 0.0f;
    bool done = !lane_m(in, 0, row);
    const float tcutoff = f(kTcutoff), fracprv = f(kFracprv);
    const float lvolume = f(kLvolume), sw = f(kShortwaveNet), lat = f(kLat);
    const float tair = f(kTair), wind = f(kWind), pressure = f(kPressure);
    const float vp = f(kVp), air_density = f(kAirDensity);
    const float longwave = f(kLongwave), wind_h = f(kWindH);
    const float temp0 = bcast(temp, 0);
    const float rho = water_density(temp);
    const float cp = specheat(temp);
    float t_new = temp;
    float out[kNumOut] = {};
    int trips = 0;
    if (!done) {
      const Met met(tair, wind, pressure, vp, air_density, longwave, wind_h,
                    tcutoff + kKelvin);
      const float jouleold = energycalc(temp, l, cp, rho);
      const float dh_den = nan_max(l.surface0 * dt, kSmall);
      TempArea ta;
      ta.init(temp, rho, cp, eddy(rho, wind, lat, l), sw * kA1, sw * kA2, dt,
              l, rows);
      float ts = temp0;
      for (int it = 0; it < kEbMaxIter; ++it) {
        const Fluxes fl = met.at(ts);
        float t_it = ta.solve(fl.qle + fl.qh + fl.lwnet, k);
        float joulenew = energycalc(t_it, l, cp, rho);
        Iceform icf{0.0f, 0.0f, 0.0f, 0.0f};
        if (bcast(t_it, 0) < tcutoff) {
          icf = iceform(t_it, tcutoff, fracprv, dt, l, cp, lvolume);
          joulenew = energycalc(t_it, l, cp, rho);
        }
        const float tmean = (bcast(t_it, 0) + temp0) / 2.0f;
        const float o[kNumOut] = {fl.qh,
                                  fl.qle,
                                  fl.lwnet,
                                  (joulenew - jouleold) / dh_den,
                                  icf.qfusion,
                                  icf.areaadd,
                                  icf.new_ice_height,
                                  icf.new_ice_water_eq,
                                  fl.evap,
                                  ta.e_bot};
        for (int j = 0; j < kNumOut; ++j) out[j] = o[j];
        t_new = t_it;
        const bool newly = fabsf(tmean - ts) <= kEbEps;
        ts = tmean;
        trips = it + 1;
        if (newly) {
          done = true;
          break;
        }
      }
      if (!done) {
        // non-convergence workaround (water_energy_balance.c:185-218):
        // fluxes at the old surface layer, no storage change, iceform on the
        // old column, which stays
        const Fluxes fl = met.at(temp0);
        float t_fb = temp;
        const bool froze = temp0 < tcutoff;
        const Iceform icf =
            iceform(t_fb, tcutoff, fracprv, dt, l, cp, lvolume);
        const float o[kNumOut] = {fl.qh,
                                  fl.qle,
                                  fl.lwnet,
                                  0.0f,
                                  froze ? icf.qfusion : 0.0f,
                                  froze ? icf.areaadd : 0.0f,
                                  froze ? icf.new_ice_height : 0.0f,
                                  froze ? icf.new_ice_water_eq : 0.0f,
                                  fl.evap,
                                  0.0f};
        for (int j = 0; j < kNumOut; ++j) out[j] = o[j];
        t_new = temp;
      }
    }
    if (layer) temp_out[at] = t_new;
    // lane j < kNumOut writes output j
#pragma unroll
    for (int j = 0; j < kNumOut; ++j)
      if (k == j) sc[static_cast<int64_t>(j) * n + i] = out[j];
    if (k == 0) {
      converged[i] = done;
      iterations[i] = trips;
    }
    // the mix solve_lake applies to the open-water column, on every lake
    tracer_mix(t_new, l, cp);
    if (layer) t_open[at] = t_new;
  });
}

int resident[kMaxDevices];   // blocks of the kernel resident on a device

}  // namespace

extern "C" {

// Replaces vic_tpu/physics/lake.py:584 (water_energy_balance's while_loop)
// and the tracer_mixer fori_loop (lake.py:472) of solve_lake's open-water
// mix. h: lanes (lakes) per cell row of the inputs' views; n lakes.
int lake_open_water(const int64_t* lanes, int nf, int nm,
                    int h, float dt, int n, float* temp_out, float* t_open,
                    float* sc, uint8_t* converged, int32_t* iterations,
                    void* stream) {
  LaneInputs in{};
  if (n <= 0 ||
      !fill_lane_inputs(&in, lanes, nf, kNumIn, nm, kNumMask, h))
    return static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0, chunk = 0;
  const int err = lake_grid(
      reinterpret_cast<const void*>(lake_open_water_kernel), n, resident,
      &blocks, &chunk);
  if (err != 0) return err;
  lake_open_water_kernel<<<blocks, kLakeBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      in, dt, n, chunk, temp_out, t_open, sc, converged, iterations);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
