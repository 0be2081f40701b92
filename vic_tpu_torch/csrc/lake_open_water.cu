// K10 lake_open_water: the open-water column's skin-temperature fixed point
// and the convective mix of its result, one thread per lake, for sm_90a.
//
// Replaces vic_tpu/physics/lake.py:584 (water_energy_balance, a
// lax.while_loop of up to 50 iterations over the whole [n_cell, 20] batch,
// each iteration latsens + lkdrag, the eddy diffusivity, temp_area with its
// Thomas solve, iceform and energycalc) and the tracer_mixer solve_lake
// applies to its column on every cell (lake.py:1336-1337). The TPU loop ran
// every lane until the slowest converged; here each thread stops its own
// lake at |tmean - ts| <= 1e-4 or 50 iterations, which gives the batched
// loop's result exactly, since a done lane keeps its outputs and its ts
// there. What changes between iterations is only the surface force, so the
// eddy diffusivity, the matrix and its elimination are formed once per
// lake (lake.cuh TempArea) and each iteration is a forward and a back
// substitution over the 20 layers.
//
// Bound by latency: one lake's 20 layers live in the thread's arrays
// (spilled to local memory), each iteration a dependent chain of ~40
// divisions and the 20-layer recurrences; a lake reads ~0.4 KB and writes
// ~0.2 KB. Simple and right first: no shared memory, one lake per thread.
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

constexpr int kBlock = 64;
constexpr int kNumIn = 18;
constexpr int kNumMask = 3;
constexpr int kNumOut = 10;
enum In { kTemp, kZ, kZhalf, kSurface, kSurfdz, kDz, kLat, kTcutoff, kTair,
          kWind, kPressure, kVp, kAirDensity, kLongwave, kShortwaveNet,
          kWindH, kFracprv, kLvolume };
constexpr float kZWater = 0.0045f;
constexpr float kEmSb = static_cast<float>(0.98 * 5.6696e-8);
constexpr float kPi = static_cast<float>(3.141592653589793);

// lkdrag (lakes.eb.c:1263)
__device__ __forceinline__ float lkdrag(float tsurf_k, float tair_k,
                                        float wind, float roughness,
                                        float z1) {
  const float logzr = logf(z1 / roughness);
  float cdrn = rdiv_s(kVonK, logzr);
  cdrn = cdrn * cdrn;
  const float ribn = z1 * kG * (1.0f - tsurf_k / tair_k);
  const float ribd = tsurf_k / tair_k <= 1.0f ? wind * wind + 0.01f
                                              : wind * wind + 1.0f;
  const float rib = ribn / nan_max(ribd, kSmall);
  const float cdr =
      rib < 0.0f ? cdrn * (1.0f + 24.5f * sqrtf(nan_max(-cdrn * rib, 0.0f)))
                 : cdrn / (1.0f + 11.5f * rib);
  const float cdrmin = nan_max(0.25f * cdrn, 6.0e-4f);
  return nan_max(cdr, cdrmin);
}

struct Fluxes {
  float evap, qh, qle, lwnet;
};

struct Met {
  float tair, wind, pressure, vp, air_density, longwave, wind_h, tcutk;

  // fluxes(ts) of water_energy_balance: latsens over open water (hice = 0)
  __device__ Fluxes at(float ts) const {
    const float tskin = ts + kKelvin;
    const float drag = lkdrag(tskin, tair + kKelvin, wind, kZWater, wind_h);
    const float ts_c = tskin - kKelvin;
    const float eog =
        tskin > tcutk ? 611.0f * expf(17.269f * ts_c / (ts_c + 237.3f))
                      : 611.0f * expf(21.874f * ts_c / (tskin - 7.66f));
    const float qlake = 0.622f * eog / nan_max(pressure - 0.378f * eog, 1.0f);
    const float qair = 0.622f * vp / nan_max(pressure - 0.378f * vp, 1.0f);
    const float delq = qair - qlake;
    const float evap = -1.0f * drag * wind * air_density * delq;
    const float qsen =
        drag * wind * air_density * kCp * (tair + kKelvin - tskin);
    const float le = (2.501f - 0.002361f * tair) * 1.0e6f;
    return Fluxes{evap, qsen, -1.0f * evap * le,
                  longwave - kEmSb * pow4(tskin)};
  }
};

// eddy_diffusivity with freezeflag true (lakes.eb.c:837-935)
__device__ __forceinline__ void eddy(const float* rho, float wind_in,
                                     float lat, const Column& c, float* de) {
  const float wind = nan_max(wind_in, 1.0f);
  const float ks = 6.6f * sqrtf(sinf(div_s(fabsf(lat) * kPi, 180.0f))) *
                   powf(wind, -1.84f);
  const float ws = 0.0012f * wind;
  for (int k = 0; k < kNN - 1; ++k) {
    const float dpdz = (rho[k + 1] - rho[k]) / c.zhalf[k];
    const float n2 = dpdz / (1.0e3f + rho[k]) * 9.8f;
    const float z = c.surfdz + static_cast<float>(k) * c.dz;
    const float ksz = nan_min(ks * z, 30.0f);
    const bool deep = z * expf(ksz) / ws > 1.0e8f;
    const float vkz = kVonK * z;
    float rad =
        1.0f + 40.0f * n2 * (vkz * vkz) / (ws * ws * expf(-2.0f * ksz));
    rad = deep ? 4.0e4f : rad;
    rad = nan_min(nan_max(rad, 1.0f), 4.0e4f);
    const float ri = div_s(-1.0f + sqrtf(rad), 20.0f);
    de[k] = kDM + div_s(kVonK * ws * z, 1.0f) * expf(-ks * z) /
                      (1.0f + 37.0f * ri * ri);
  }
  de[kNN - 1] = de[kNN - 2];
}

__global__ void __launch_bounds__(kBlock)
    lake_open_water_kernel(const __grid_constant__ LaneInputs in, float dt,
                           int n, float* temp_out, float* t_open, float* sc,
                           uint8_t* converged, int32_t* iterations) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const LaneRow row = lane_row(in, i);
  auto f = [&](int k) { return lane_f(in, k, row); };
  Column col;
  load_column(in, row, kZ, 1, &col);
  float temp[kNN], rho[kNN], cp[kNN];
  for (int k = 0; k < kNN; ++k) {
    temp[k] = lane_fl(in, kTemp, row, k);
    rho[k] = water_density(temp[k]);
    cp[k] = specheat(temp[k]);
  }
  const float tcutoff = f(kTcutoff), fracprv = f(kFracprv);
  const float lvolume = f(kLvolume), sw = f(kShortwaveNet);
  const Met met{f(kTair), f(kWind), f(kPressure), f(kVp), f(kAirDensity),
                f(kLongwave), f(kWindH), tcutoff + kKelvin};
  const float jouleold = energycalc(temp, col, cp, rho);
  const float dh_den = nan_max(col.surface[0] * dt, kSmall);

  float t_new[kNN];
  for (int k = 0; k < kNN; ++k) t_new[k] = temp[k];
  float out[kNumOut] = {};
  bool done = !lane_m(in, 0, row);
  int trips = 0;
  if (!done) {
    float de[kNN];
    eddy(rho, met.wind, f(kLat), col, de);
    TempArea ta;
    ta.init(temp, rho, cp, de, sw * kA1, sw * kA2, dt, col);
    float ts = temp[0];
    float t_it[kNN];
    for (int it = 0; it < kEbMaxIter; ++it) {
      const Fluxes fl = met.at(ts);
      ta.solve(fl.qle + fl.qh + fl.lwnet, t_it);
      float joulenew = energycalc(t_it, col, cp, rho);
      const bool froze = t_it[0] < tcutoff;
      Iceform icf{0.0f, 0.0f, 0.0f, 0.0f};
      if (froze) {
        icf = iceform(t_it, tcutoff, fracprv, dt, col, cp, lvolume);
        joulenew = energycalc(t_it, col, cp, rho);
      }
      const float tmean = (t_it[0] + temp[0]) / 2.0f;
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
      for (int k = 0; k < kNumOut; ++k) out[k] = o[k];
      for (int k = 0; k < kNN; ++k) t_new[k] = t_it[k];
      const bool newly = fabsf(tmean - ts) <= kEbEps;
      ts = tmean;
      trips = it + 1;
      if (newly) {
        done = true;
        break;
      }
    }
    if (!done) {
      // non-convergence workaround (water_energy_balance.c:185-218): fluxes
      // at the old surface layer, no storage change, iceform on the old
      // column, which stays
      const Fluxes fl = met.at(temp[0]);
      float t_fb[kNN];
      for (int k = 0; k < kNN; ++k) t_fb[k] = temp[k];
      const bool froze = temp[0] < tcutoff;
      const Iceform icf =
          iceform(t_fb, tcutoff, fracprv, dt, col, cp, lvolume);
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
      for (int k = 0; k < kNumOut; ++k) out[k] = o[k];
      for (int k = 0; k < kNN; ++k) t_new[k] = temp[k];
    }
  }
  for (int k = 0; k < kNN; ++k) temp_out[static_cast<int64_t>(i) * kNN + k] =
      t_new[k];
  for (int k = 0; k < kNumOut; ++k)
    sc[static_cast<int64_t>(k) * n + i] = out[k];
  converged[i] = done;
  iterations[i] = trips;
  // the mix solve_lake applies to the open-water column, on every lake
  tracer_mix(t_new, col, cp);
  for (int k = 0; k < kNN; ++k) t_open[static_cast<int64_t>(i) * kNN + k] =
      t_new[k];
}

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
  lake_open_water_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      in, dt, n, temp_out, t_open, sc, converged, iterations);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
