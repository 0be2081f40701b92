// K14 affine_surface_brent: the soil-surface temperature of the CLOSE_ENERGY
// passes on finite-difference nodes, for sm_90a (H100).
//
// Replaces vic_tpu/physics/surface.py:438 (solve_surface_temperature's
// batched_brent) in its fd_affine form (:421-433): the node profile is
// solved twice, from the carried temperatures, with the two bracket ends
// t_lower and t_upper as the node-0 boundary (K6, before this launch), and
// the residual :71-378 takes nodes 1 and 2 interpolated affinely between
// those two probes at each candidate Ts (:155-158), then the
// finite-difference ground heat and the top node pair's fusion
// (surface_brent.cuh fd()). A candidate outside the original bracket, once
// the expansion widened it (vic_tpu/ops/rootfind.py:115), extrapolates from
// the same two probes, as the reference does.
//
// Unlike K7's residual, this one is elementwise: the probes are fixed
// before the solve, so no lane's residual depends on another's candidate,
// and a per-lane Brent gives the batch loop's result, as K5 does. The
// interpolation's weight is a true float32 division, lane by lane, as the
// plain version's tensor division is.
//
// What bounds it on this card: a lane reads K5's ~64 inputs (~300 B; the
// dry column's ~80 B more with DIST_PRCP), the 5 fusion inputs, 4 probe
// temperatures and its bracket, and writes 10 B, while it runs ~10-70
// dependent residual evaluations of ~170 flops: latency, not device-memory
// bytes. One thread a lane left a warp waiting on its slowest lane with
// its glacier, lake and finished lanes idle, and the wrapper's host work
// for ~100 inputs set the call's time.
//
// What the design does: the lanes run on csrc/lane_brent.cuh's driver
// (compacted and dealt to persistent threads, a finished lane's thread
// taking the next), each lane's Ts-independent terms formed once when its
// thread takes it, and every input, the bracket too, read where it lies
// through the wrapper's one lane table.
//
// C interface for ctypes: K5's float inputs (with the dry column's), the 5
// fusion inputs, the bracket ends ts_a and ts_b of the probes, the two
// probe profiles (layered, nn nodes) and lo and hi, then K5's masks and
// fs_active, as the wrapper's lane table (lanes.cuh); returns
// cudaGetLastError(), cudaErrorInvalidValue on wrong counts or
// vicbrent::kNoResidentBlock where no block fits on an SM.

#include <cuda_runtime.h>

#include <cstdint>

#include "brent.cuh"
#include "lane_brent.cuh"
#include "lanes.cuh"
#include "surface_brent.cuh"

namespace {

// the probes' inputs and the bracket after the fusion inputs
// (kernels.AFFINE_INPUTS)
enum AffIn { kTsA, kTsB, kProbeLo, kProbeHi, kLoIn, kHiIn, kNumAffIn };
constexpr int kAffIn = vicsurf::kNumSurfaceIn + vicsurf::kNumFdIn;

template <int NL, bool DIST>
struct AffineResidual {
  vicsurf::SurfaceResidual<NL, DIST> r;
  float ts_a, ts_b, lo1, lo2, hi1, hi2;

  // nodes 1-2 of the profile interpolated between the probes
  // (vic_tpu/physics/surface.py:157-158)
  __device__ float operator()(float ts) const {
    const float wq = (ts - ts_a) / (ts_b - ts_a);
    return r.fd(ts, lo1 + wq * (hi1 - lo1), lo2 + wq * (hi2 - lo2));
  }
};

struct AffineParams {
  float dt;
  int grnd_flux_type;
  bool frozen;
};

// K14's lane for lane_brent.cuh
template <int NL, bool DIST>
struct AffineLane : AffineResidual<NL, DIST> {
  static constexpr int kLo = kAffIn + kLoIn, kHi = kAffIn + kHiIn;
  static constexpr int kActive = vicsurf::kActive;
  // four blocks an SM (at most 128 registers a thread): the lanes'
  // latency needs the warps (timed on the card against two and three)
  static constexpr int kMinBlocks = 4;

  __device__ __forceinline__ void init(const LaneInputs& in, LaneRow row,
                                       const AffineParams& p) {
    this->r.init(in, row, p.dt, p.grnd_flux_type);
    this->r.init_fd(in, row, p.frozen);
    this->ts_a = lane_f(in, kAffIn + kTsA, row);
    this->ts_b = lane_f(in, kAffIn + kTsB, row);
    this->lo1 = lane_fl(in, kAffIn + kProbeLo, row, 1);
    this->lo2 = lane_fl(in, kAffIn + kProbeLo, row, 2);
    this->hi1 = lane_fl(in, kAffIn + kProbeHi, row, 1);
    this->hi2 = lane_fl(in, kAffIn + kProbeHi, row, 2);
  }
};

}  // namespace

extern "C" {

// nf, nm: the input counts, checked against the residual's; h: lanes per
// cell; nl: soil layers (2 or 3); dist: the dry column is read (DIST_PRCP);
// nn: nodes of the probe profiles (at least 3); frozen: the fusion term.
int affine_surface_brent(const int64_t* lanes, int nf, int nm, int h, int nl,
                         int dist, int nn, float dt, int grnd_flux_type,
                         int frozen, int max_iter, int max_tries, int n,
                         float* root, uint8_t* converged, uint8_t* bracketed,
                         int32_t* iterations, void* stream) {
  LaneInputs in{};
  if (n <= 0 || nn < 3 || max_iter < 0 || max_tries < 0 ||
      !fill_lane_inputs(&in, lanes, nf, kAffIn + kNumAffIn, nm,
                        vicsurf::kNumSurfaceMask + 1, h))
    return static_cast<int>(cudaErrorInvalidValue);
  const AffineParams p{dt, grnd_flux_type, frozen != 0};
  const BrentOutputs out{root, converged, bracketed, iterations};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nl == 2 && dist)
    return vicbrent::launch_lane_brent<AffineLane<2, true>>(
        in, p, max_iter, max_tries, n, out, s);
  if (nl == 2)
    return vicbrent::launch_lane_brent<AffineLane<2, false>>(
        in, p, max_iter, max_tries, n, out, s);
  if (nl == 3 && dist)
    return vicbrent::launch_lane_brent<AffineLane<3, true>>(
        in, p, max_iter, max_tries, n, out, s);
  if (nl == 3)
    return vicbrent::launch_lane_brent<AffineLane<3, false>>(
        in, p, max_iter, max_tries, n, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
