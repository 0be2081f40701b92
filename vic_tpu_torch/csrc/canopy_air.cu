// K9 canopy_air_step: one pass of the CLOSE_ENERGY canopy-air fixed point,
// for sm_90a (H100).
//
// Replaces the body of vic_tpu/model.py:841's while_loop (the CLOSE_ENERGY
// canopy-air iteration, :796-851) but for its column() pass: the loop's
// body is a whole pass of the overstory -> understory chain, whose solves
// are K1-K3 and K5, so the loop itself stays a host loop over passes. Its
// own per-pass work is this launch: tc_update (the closed-form
// calc_atmos_energy_bal on the pass's canopy and understory sensible heat,
// masked to snow-covered overstory lanes), g = F(tc) - tc, the per-lane
// safeguarded secant or the damped half-step, and the batch's stopping
// test: the largest |tc_next - tc| over the lanes of the mask. That max is
// reduced on the device (warp and block max, then atomicMax on the float's
// bits: the values are >= 0, so the int order is the float order, and a
// NaN -- |x| clears its sign bit -- orders above +inf, so a NaN anywhere
// comes out as NaN and keeps the loop going, as jnp.max does). The host
// reads that one scalar per pass. One thread per lane, ~12 floats in and 2
// out, ~40 flops: bound by bytes.
//
// C interface for ctypes: returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "lanes.cuh"
#include "physics.cuh"

namespace {

using namespace vicphys;

constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;
constexpr float kCanopyDt = 1.0f;   // CANOPY_DT, the canopy-air T bracket

// float inputs, in the order of kernels.CANOPY_AIR_INPUTS; masks: the
// iterated lanes (snow-covered overstory), the model's lanes
enum In {
  kCanopySens, kSoilSens, kPackSens, kCovW, kTair, kAirDens, kRaOver, kTc,
  kTcPrev, kGPrev, kNumIn
};
enum Mask { kIterMask, kLaneMask, kNumMask };

__global__ void __launch_bounds__(kBlock)
    canopy_air_kernel(const __grid_constant__ LaneInputs in, int it, int n,
                      float* tc_out, float* g_out, int32_t* live_max) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float live = 0.0f;
  if (i < n) {
    const LaneRow row = lane_row(in, i);
    auto f = [&](int k) { return lane_f(in, k, row); };
    const float tair = f(kTair), tc = f(kTc);
    // tc_update: calc_atmos_energy_bal on the pass's sensible heat
    const float under_sens = f(kSoilSens) + f(kPackSens) * f(kCovW);
    const float in_sens = f(kCanopySens) + under_sens;
    const float ra = nan_max(f(kRaOver), 1e-6f);
    const float coef = f(kAirDens) * kCp / ra;
    const float tc_root = tair - in_sens / nan_max(coef, 1e-12f);
    const float tcanopy =
        fabsf(tc_root - tair) <= kCanopyDt ? tc_root : tair;  // TFALLBACK
    const float F = lane_m(in, kIterMask, row) ? tcanopy : tair;
    // safeguarded secant on g(tc) = F(tc) - tc, else the damped half-step
    const float g = F - tc;
    const float denom = g - f(kGPrev);
    const bool flat = fabsf(denom) < 1e-12f;
    const float sec = g * (tc - f(kTcPrev)) / (flat ? 1.0f : denom);
    const bool damped = it == 0 || flat || fabsf(sec) > 10.0f;
    const float tc_next = tc - (damped ? -0.5f * g : sec);
    tc_out[i] = tc_next;
    g_out[i] = g;
    if (lane_m(in, kLaneMask, row)) live = fabsf(tc_next - tc);
  }
  // block max of the live changes on their bits, then one atomicMax
  int bits = __float_as_int(live);
  for (int off = 16; off > 0; off >>= 1)
    bits = max(bits, __shfl_down_sync(0xffffffffu, bits, off));
  __shared__ int warp_max[kWarps];
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = bits;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = warp_max[0];
    for (int w = 1; w < kWarps; ++w) m = max(m, warp_max[w]);
    atomicMax(live_max, m);
  }
}

}  // namespace

extern "C" {

// f/m: the 10 float inputs and 2 masks of canopy_air_kernel, as lanes.cuh
// reads them; it: the pass index (0 takes the damped step); tc_next, g:
// [n] float; live_max: one int32, zeroed by the caller, the bits of the
// largest masked |tc_next - tc|.
int canopy_air_step(const int64_t* lanes, int nf, int nm,
                    int h, int it, int n, float* tc_next, float* g,
                    int32_t* live_max, void* stream) {
  LaneInputs in{};
  if (n <= 0 ||
      !fill_lane_inputs(&in, lanes, nf, kNumIn, nm, kNumMask, h))
    return static_cast<int>(cudaErrorInvalidValue);
  canopy_air_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(in, it, n, tc_next,
                                                           g, live_max);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
