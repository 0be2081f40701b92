// Inputs of the one-thread-per-lane kernels (K1-K5, K7-K14).
//
// The lanes are [n_cell, h] (h HRUs per cell), flattened: lane i is HRU
// i % h of cell i / h. Each input comes as the wrapper's view of it
// broadcast to the lanes (kernels._lane_inputs): its data pointer and its
// element strides along the cell, HRU and layer axes, 0 along an axis it is
// broadcast over. A value shared by the HRUs of a cell, a slice of a
// layered array or a scalar is read where it lies, and no input is copied.
// Pointers and strides travel in the kernel's parameter block.
#pragma once

#include <cstdint>

constexpr int kMaxFloatInputs = 96;
constexpr int kMaxMaskInputs = 8;

struct LaneInputs {
  const float* f[kMaxFloatInputs];
  const uint8_t* m[kMaxMaskInputs];
  int32_t f_stride[kMaxFloatInputs][3];  // cell, HRU, layer
  int32_t m_stride[kMaxMaskInputs][3];
  int h;                                 // lanes per cell
};

struct LaneRow {
  int cell, hru;
};

__device__ __forceinline__ LaneRow lane_row(const LaneInputs& in, int i) {
  const int cell = i / in.h;
  return LaneRow{cell, i - cell * in.h};
}

__device__ __forceinline__ int64_t lane_offset(const int32_t* s, LaneRow r) {
  return static_cast<int64_t>(r.cell) * s[0] +
         static_cast<int64_t>(r.hru) * s[1];
}

// float input k of a lane
__device__ __forceinline__ float lane_f(const LaneInputs& in, int k,
                                        LaneRow r) {
  return in.f[k][lane_offset(in.f_stride[k], r)];
}

// value l of layered float input k
__device__ __forceinline__ float lane_fl(const LaneInputs& in, int k,
                                         LaneRow r, int l) {
  return in.f[k][lane_offset(in.f_stride[k], r) +
                 static_cast<int64_t>(l) * in.f_stride[k][2]];
}

// mask input k of a lane
__device__ __forceinline__ bool lane_m(const LaneInputs& in, int k,
                                       LaneRow r) {
  return in.m[k][lane_offset(in.m_stride[k], r)] != 0;
}

// value l of layered mask input k
__device__ __forceinline__ bool lane_ml(const LaneInputs& in, int k,
                                        LaneRow r, int l) {
  return in.m[k][lane_offset(in.m_stride[k], r) +
                 static_cast<int64_t>(l) * in.m_stride[k][2]] != 0;
}

// Fills `in` from the host's arrays of device pointers and of strides
// (3 per input); false unless the counts are the kernel's and h >= 1.
inline bool fill_lane_inputs(LaneInputs* in, const void* const* f,
                             const int32_t* f_stride, int nf, int nf_expected,
                             const void* const* m, const int32_t* m_stride,
                             int nm, int nm_expected, int h) {
  if (nf != nf_expected || nm != nm_expected || nf > kMaxFloatInputs ||
      nm > kMaxMaskInputs || h < 1)
    return false;
  for (int k = 0; k < nf; ++k) {
    in->f[k] = static_cast<const float*>(f[k]);
    for (int a = 0; a < 3; ++a) in->f_stride[k][a] = f_stride[3 * k + a];
  }
  for (int k = 0; k < nm; ++k) {
    in->m[k] = static_cast<const uint8_t*>(m[k]);
    for (int a = 0; a < 3; ++a) in->m_stride[k][a] = m_stride[3 * k + a];
  }
  in->h = h;
  return true;
}
