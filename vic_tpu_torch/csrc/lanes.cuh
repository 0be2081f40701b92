// Inputs of the lane kernels (K1-K5, K7-K15, K17).
//
// The lanes are [n_cell, h] (h HRUs per cell), flattened: lane i is HRU
// i % h of cell i / h. Each input comes as its data pointer and the element
// strides of its broadcast to the lanes along the cell, HRU and layer axes
// (kernels._lane_inputs), 0 along an axis it is broadcast over. A value
// shared by the HRUs of a cell, a slice of a layered array or a scalar is
// read where it lies, and no input is copied.
// The wrapper writes pointers and strides into one int64 table a call;
// they travel in the kernel's parameter block.
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

// Fills `in` from the wrapper's lane table (kernels._lane_inputs): four
// int64 per input, its device pointer and its element strides along the
// cell, HRU and layer axes, for the nf float inputs and then the nm masks;
// false unless the counts are the kernel's, h >= 1 and every stride fits in
// 32 bits.
inline bool fill_lane_inputs(LaneInputs* in, const int64_t* table, int nf,
                             int nf_expected, int nm, int nm_expected,
                             int h) {
  if (nf != nf_expected || nm != nm_expected || nf > kMaxFloatInputs ||
      nm > kMaxMaskInputs || h < 1)
    return false;
  for (int k = 0; k < nf + nm; ++k) {
    const int64_t* row = table + 4 * k;
    int32_t* stride = k < nf ? in->f_stride[k] : in->m_stride[k - nf];
    for (int a = 0; a < 3; ++a) {
      if (row[1 + a] != static_cast<int32_t>(row[1 + a])) return false;
      stride[a] = static_cast<int32_t>(row[1 + a]);
    }
    if (k < nf)
      in->f[k] = reinterpret_cast<const float*>(row[0]);
    else
      in->m[k - nf] = reinterpret_cast<const uint8_t*>(row[0]);
  }
  in->h = h;
  return true;
}
