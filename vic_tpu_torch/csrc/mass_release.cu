// K15 mass_release <- vic_tpu/physics/canopy_snow.py:126 mass_release
//
// On the TPU this was a lax.fori_loop of 8 rounds over the whole batch of
// [n_cell, max_hru] lanes (massrelease.c re-expressed as fixed rounds):
// while the melt storage reaches 10% of the intercepted snow above
// MIN_INTERCEPTION_STORAGE, up to 17% of it falls as snow; otherwise the
// storage drips off as liquid. Every min/max propagates NaN as
// jnp.minimum/maximum do.
//
// What bounds it: bytes, 8 B read and 16 B written a lane against ~15 FP32
// operations a round. What the design does about it:
// - The vector path: where both inputs are lane-contiguous (lane i at
//   element i) and 16-byte aligned, as snow_intercept's outputs are, a
//   thread takes 4 consecutive lanes with one float4 load an input, runs
//   their rounds in registers and writes each output with one float4
//   store; no division by the lanes per cell, no stride arithmetic. A
//   scalar tail takes the last n % 4 lanes.
// - The table path: broadcast or strided inputs, or inputs that are not
//   aligned, are read one lane a thread through the lane table (lanes.cuh).
// - Both write the four outputs as the rows of one allocation whose row
//   stride `ld` is a multiple of 4 floats, so every row is as aligned as
//   the allocation.
// - A lane leaves the round loop once a round changed no bit of its state
//   (after the drip branch empties the storage every later round adds 0 to
//   its sums): every later round would compute the same bits, so it stores
//   what the n_iter rounds give. A state holding a NaN never stops early.
// A lane's rounds are the same operations in the same order on both paths.
//
// C interface for ctypes: the two inputs as lanes.cuh passes them; returns
// cudaGetLastError(), or cudaErrorInvalidValue for bad counts.

#include <cuda_runtime.h>

#include <cstdint>

#include "lanes.cuh"
#include "physics.cuh"

namespace {

using namespace vicphys;

constexpr int kBlock = 256;
constexpr float kMinInterceptionStorage = 0.005f;   // m

// one lane's canopy snow, melt storage, released snow and drip (m)
struct Release {
  float isnow, tstore, rel, drp;

  // one round; returns whether it left the state as it was, bit for bit,
  // with no NaN in it
  __device__ __forceinline__ bool round() {
    const bool big = isnow > kMinInterceptionStorage;
    const float threshold = 0.10f * isnow;
    const float max_release = 0.17f * isnow;
    const bool do_release = big && tstore >= threshold;
    const float amount =
        nan_min(nan_max(isnow - kMinInterceptionStorage, 0.0f), max_release);
    const float isnow2 = do_release ? isnow - amount : isnow;
    const float rel2 = rel + (do_release ? amount : 0.0f);
    // drip branch: the storage drains as liquid
    const float tempdrip = nan_min(tstore, isnow2);
    const float drp2 = drp + (do_release ? 0.0f : tempdrip);
    const float isnow3 = do_release ? isnow2 : isnow2 - tempdrip;
    const float tstore2 = do_release ? tstore : tstore - tempdrip;
    const bool same =
        __float_as_uint(isnow3) == __float_as_uint(isnow) &&
        __float_as_uint(tstore2) == __float_as_uint(tstore) &&
        __float_as_uint(rel2) == __float_as_uint(rel) &&
        __float_as_uint(drp2) == __float_as_uint(drp) &&
        isnow == isnow && tstore == tstore && rel == rel && drp == drp;
    isnow = isnow3;
    tstore = tstore2;
    rel = rel2;
    drp = drp2;
    return same;
  }
};

__device__ __forceinline__ Release release(float isnow, float tstore,
                                           int n_iter) {
  Release s{isnow, tstore, 0.0f, 0.0f};
  for (int it = 0; it < n_iter; ++it)
    if (s.round()) break;
  return s;
}

__device__ __forceinline__ void store(float* out, int64_t ld, int64_t i,
                                      const Release& s) {
  out[i] = s.isnow;
  out[ld + i] = s.tstore;
  out[2 * ld + i] = s.rel;
  out[3 * ld + i] = s.drp;
}

// vector path: thread t < n / 4 takes lanes 4t .. 4t + 3; the next n % 4
// threads one lane each of the tail
__global__ void mass_release_vector(const float* __restrict__ int_snow,
                                    const float* __restrict__ storage,
                                    int n_iter, int n,
                                    float* __restrict__ out, int64_t ld) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int n4 = n / 4;
  if (t < n4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(int_snow) + t);
    const float4 b = __ldg(reinterpret_cast<const float4*>(storage) + t);
    Release s[4] = {{a.x, b.x, 0.0f, 0.0f}, {a.y, b.y, 0.0f, 0.0f},
                    {a.z, b.z, 0.0f, 0.0f}, {a.w, b.w, 0.0f, 0.0f}};
    for (int it = 0; it < n_iter; ++it) {
      // & and not &&: every lane runs the round
      const bool same = s[0].round() & s[1].round() & s[2].round() &
                        s[3].round();
      if (same) break;
    }
    float4* o = reinterpret_cast<float4*>(out) + t;
    const int64_t ld4 = ld / 4;
    o[0] = make_float4(s[0].isnow, s[1].isnow, s[2].isnow, s[3].isnow);
    o[ld4] = make_float4(s[0].tstore, s[1].tstore, s[2].tstore, s[3].tstore);
    o[2 * ld4] = make_float4(s[0].rel, s[1].rel, s[2].rel, s[3].rel);
    o[3 * ld4] = make_float4(s[0].drp, s[1].drp, s[2].drp, s[3].drp);
  } else if (t < n4 + n % 4) {
    const int i = 4 * n4 + (t - n4);
    store(out, ld, i, release(int_snow[i], storage[i], n_iter));
  }
}

// table path: one lane a thread through the lane table
__global__ void mass_release_table(const __grid_constant__ LaneInputs in,
                                   int n_iter, int n, float* out,
                                   int64_t ld) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const LaneRow row = lane_row(in, i);
  store(out, ld, i, release(lane_f(in, 0, row), lane_f(in, 1, row), n_iter));
}

// input k of `in` puts lane i at element i of a 16-byte aligned pointer
bool lane_contiguous(const LaneInputs& in, int k, int n) {
  const int32_t* s = in.f_stride[k];
  return s[1] == 1 && (s[0] == in.h || n <= in.h) &&
         reinterpret_cast<uintptr_t>(in.f[k]) % 16 == 0;
}

// 1: the vector path, 0: the table path, -1: counts the kernel refuses
int route(LaneInputs* in, const int64_t* lanes, int nf, int h, int n) {
  if (n <= 0 || !fill_lane_inputs(in, lanes, nf, 2, 0, 0, h)) return -1;
  return lane_contiguous(*in, 0, n) && lane_contiguous(*in, 1, n) ? 1 : 0;
}

}  // namespace

extern "C" {

// 2 float inputs: int_snow, temp_int_storage (m), each with its strides.
// out: int_snow, temp_int_storage, released and drip, row r of n floats at
// out + r * ld; ld >= n a multiple of 4 and out 16-byte aligned.
int mass_release(const int64_t* lanes, int nf, int h, int n_iter, int n,
                 float* out, int64_t ld, void* stream) {
  LaneInputs in{};
  const int path = route(&in, lanes, nf, h, n);
  if (path < 0 || n_iter < 0 || ld < n || ld % 4 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    const int threads = n / 4 + n % 4;
    mass_release_vector<<<(threads + kBlock - 1) / kBlock, kBlock, 0, s>>>(
        in.f[0], in.f[1], n_iter, n, out, ld);
  } else {
    mass_release_table<<<(n + kBlock - 1) / kBlock, kBlock, 0, s>>>(
        in, n_iter, n, out, ld);
  }
  return static_cast<int>(cudaGetLastError());
}

// The path mass_release takes for this lane table: 1 the vector path, 0
// the table path, -1 counts it refuses.
int mass_release_route(const int64_t* lanes, int nf, int h, int n) {
  LaneInputs in{};
  return route(&in, lanes, nf, h, n);
}

}  // extern "C"
