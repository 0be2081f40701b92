// K9 canopy_air_step: one pass of the CLOSE_ENERGY canopy-air fixed point,
// and the loop's final update, for sm_90a (H100).
//
// Replaces the body of vic_tpu/model.py:841's while_loop (the CLOSE_ENERGY
// canopy-air iteration, :796-851) but for its column() pass: the loop's
// body is a whole pass of the overstory -> understory chain, whose solves
// are K1-K3 and K5/K14, so the loop itself stays a host loop over passes.
// Its own per-pass work is one launch of canopy_air_kernel: tc_update (the
// closed-form calc_atmos_energy_bal on the pass's canopy and understory
// sensible heat, masked to snow-covered overstory lanes), g = F(tc) - tc,
// the per-lane safeguarded secant or the damped half-step, and the batch's
// stopping test: the largest |tc_next - tc| over the lanes of the mask.
// That max is reduced on the device (warp and block max, then atomicMax on
// the float's bits into an accumulator: the values are >= 0, so the int
// order is the float order, and a NaN -- |x| clears its sign bit -- orders
// above +inf, so a NaN anywhere comes out as NaN and keeps the loop going,
// as jnp.max does). The last block to finish (a ticket counter beside the
// accumulator) publishes the max and returns the accumulator and the
// ticket to 0, so the next pass needs no fill: it writes the bits to the
// caller's device word and to a pinned host word the host reads after an
// event, with no copy launched. One thread per lane, ~12 floats in and 2
// out, ~40 flops: bound by bytes.
//
// canopy_air_final_kernel replaces the loop's last tc_update
// (vic_tpu/model.py:849-850): on the settled pass, calc_atmos_energy_bal's
// Tcanopy, its fallback flag and the atmospheric sensible heat (the
// understory's off the iterated lanes), in one launch.
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

// float inputs, in the order of kernels.CANOPY_AIR_INPUTS (the final
// update reads the first seven); masks: the iterated lanes (snow-covered
// overstory), the model's lanes
enum In {
  kCanopySens, kSoilSens, kPackSens, kCovW, kTair, kAirDens, kRaOver, kTc,
  kTcPrev, kGPrev, kNumIn
};
constexpr int kNumFinalIn = kTc;
enum Mask { kIterMask, kLaneMask, kNumMask };

struct Balance {
  float under_sens, tcanopy, sensible;
  bool fbflag;
};

// calc_atmos_energy_bal on the pass's sensible heat
__device__ __forceinline__ Balance tc_update(const LaneInputs& in,
                                             LaneRow row) {
  auto f = [&](int k) { return lane_f(in, k, row); };
  const float tair = f(kTair);
  const float under_sens = f(kSoilSens) + f(kPackSens) * f(kCovW);
  const float in_sens = f(kCanopySens) + under_sens;
  const float ra = nan_max(f(kRaOver), 1e-6f);
  const float coef = f(kAirDens) * kCp / ra;
  const float tc_root = tair - in_sens / nan_max(coef, 1e-12f);
  const bool inside = fabsf(tc_root - tair) <= kCanopyDt;
  const float tcanopy = inside ? tc_root : tair;   // TFALLBACK
  return Balance{under_sens, tcanopy, coef * (tair - tcanopy), !inside};
}

__global__ void __launch_bounds__(kBlock)
    canopy_air_kernel(const __grid_constant__ LaneInputs in, int it, int n,
                      float* tc_out, float* g_out, int32_t* scratch,
                      int32_t* max_out, int32_t* host_max) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float live = 0.0f;
  if (i < n) {
    const LaneRow row = lane_row(in, i);
    auto f = [&](int k) { return lane_f(in, k, row); };
    const float tair = f(kTair), tc = f(kTc);
    const float F =
        lane_m(in, kIterMask, row) ? tc_update(in, row).tcanopy : tair;
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
    atomicMax(&scratch[0], m);
    __threadfence();
    // the last block publishes the max and leaves the scratch at 0
    if (atomicAdd(&scratch[1], 1) == static_cast<int>(gridDim.x) - 1) {
      const int all = atomicExch(&scratch[0], 0);
      atomicExch(&scratch[1], 0);
      if (max_out) *max_out = all;
      if (host_max) {
        *reinterpret_cast<volatile int32_t*>(host_max) = all;
        __threadfence_system();
      }
    }
  }
}

__global__ void __launch_bounds__(kBlock)
    canopy_air_final_kernel(const __grid_constant__ LaneInputs in, int n,
                            float* tcanopy, bool* fbflag, float* sensible) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const LaneRow row = lane_row(in, i);
  const Balance ca = tc_update(in, row);
  const bool iter = lane_m(in, kIterMask, row);
  tcanopy[i] = iter ? ca.tcanopy : lane_f(in, kTair, row);
  fbflag[i] = iter && ca.fbflag;
  sensible[i] = iter ? ca.sensible : ca.under_sens;
}

}  // namespace

extern "C" {

// f/m: the 10 float inputs and 2 masks of canopy_air_kernel, as lanes.cuh
// reads them; it: the pass index (0 takes the damped step); tc_next, g:
// [n] float; scratch: two int32 on the device, 0 before the first call
// (the accumulator and the ticket; every call leaves them 0); max_out (a
// device word) and host_max (a pinned host word's device address), each
// null or given the bits of the largest masked |tc_next - tc|.
int canopy_air_step(const int64_t* lanes, int nf, int nm,
                    int h, int it, int n, float* tc_next, float* g,
                    int32_t* scratch, int32_t* max_out, int32_t* host_max,
                    void* stream) {
  LaneInputs in{};
  if (n <= 0 || scratch == nullptr ||
      !fill_lane_inputs(&in, lanes, nf, kNumIn, nm, kNumMask, h))
    return static_cast<int>(cudaErrorInvalidValue);
  canopy_air_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      in, it, n, tc_next, g, scratch, max_out, host_max);
  return static_cast<int>(cudaGetLastError());
}

// The final update: the first 7 float inputs of canopy_air_step and its
// iterated-lane mask; Tcanopy, the fallback flag and the atmospheric
// sensible heat, [n] each.
int canopy_air_final(const int64_t* lanes, int nf, int nm, int h, int n,
                     float* tcanopy, bool* fbflag, float* sensible,
                     void* stream) {
  LaneInputs in{};
  if (n <= 0 || !fill_lane_inputs(&in, lanes, nf, kNumFinalIn, nm, 1, h))
    return static_cast<int>(cudaErrorInvalidValue);
  canopy_air_final_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      in, n, tcanopy, fbflag, sensible);
  return static_cast<int>(cudaGetLastError());
}

// The device address of a pinned host allocation (for host_max above);
// returns the CUDA error of cudaHostGetDevicePointer.
int canopy_air_host_word(void* host, void** device) {
  return static_cast<int>(cudaHostGetDevicePointer(device, host, 0));
}

}  // extern "C"
