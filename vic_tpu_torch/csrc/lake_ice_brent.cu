// K12 lake_ice_brent: the snow/ice surface temperature over lake ice, an
// expand-then-Brent solve per lake, one thread per lake, for sm_90a.
//
// Replaces vic_tpu/physics/lake.py:960 (lake_ice_melt's batched_brent over
// the whole [n_cell] batch, max_iter 30 after up to MAXTRIES bracket
// expansions, the residual ice_energy_terms(t).rest of lake.py:752). As K1-K3
// it runs csrc/brent.cuh in each thread, so a lake pays only its own trips.
// The residual is a line-for-line copy of physics.lake.ice_energy_terms:
// the stability-corrected sensible term, latent_heat_from_snow at the
// UNcorrected resistance (the IceEnergyBalance.c:132 quirk vic_tpu keeps)
// with the lake's blowing-snow flux added to the vapor flux (zero without
// BLOWING), the conduction through snow and ice to the freezing point, and
// the exact tsurf == 0 melt branch.
//
// Bound by latency: up to ~40 residual evaluations of ~60 operations in a
// dependent chain per lake, 76 B read and 10 B written per lake.
//
// C interface for ctypes: as glacier_brent (vic_kernels.cu); 18 float
// inputs in IceResidual's order after dt; masks: [active].

#include <cuda_runtime.h>

#include <cstdint>

#include "brent.cuh"
#include "lanes.cuh"
#include "physics.cuh"

namespace {

using namespace vicphys;

constexpr float kSmall = 1.0e-12f;

// physics.lake.ice_energy_terms(t).rest
struct IceResidual {
  float dt, ra, z_ref, roughness, wind, net_short, longwave_in, air_dens,
      lv, tair, pressure, vpd, vp_air, rain_m, surf_water, tcutoff, avgcond,
      sw_conducted, blowing_flux;

  __device__ float operator()(float t) const {
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
    if (t == 0.0f && rest > -refreeze) return 0.0f;
    return rest + refreeze;
  }
};

__global__ void lake_ice_brent_kernel(const __grid_constant__ LaneInputs in,
                                      const float* lo, const float* hi,
                                      float dt, int max_iter, int max_tries,
                                      int n, BrentOutputs out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const LaneRow row = lane_row(in, i);
  auto f = [&](int k) { return lane_f(in, k, row); };
  const IceResidual r{dt,    f(0),  f(1),  f(2),  f(3),  f(4),  f(5),
                      f(6),  f(7),  f(8),  f(9),  f(10), f(11), f(12),
                      f(13), f(14), f(15), f(16), f(17)};
  store(out, i, brent_solve(r, lo[i], hi[i], lane_m(in, 0, row), max_iter,
                            max_tries));
}

}  // namespace

extern "C" {

// Replaces vic_tpu/physics/lake.py:960 (lake_ice_melt's batched_brent).
int lake_ice_brent(const int64_t* lanes, int nf, int nm,
                   int h, const float* lo, const float* hi, float dt,
                   int max_iter, int max_tries, int n, float* root,
                   uint8_t* converged, uint8_t* bracketed,
                   int32_t* iterations, void* stream) {
  return launch_brent(lake_ice_brent_kernel, lanes, nf, 18,
                      nm, 1, h, lo, hi, dt, max_iter, max_tries, n,
                      root, converged, bracketed, iterations, stream);
}

}  // extern "C"
