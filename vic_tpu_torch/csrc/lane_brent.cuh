// The lane driver of K1 (glacier_brent), K2 (snowpack_brent), K3
// (canopy_brent), K5 (surface_brent), K12 (lake_ice_melt) and K14
// (affine_surface_brent): an expand-then-Brent per lane, with the lanes
// compacted and dealt to the threads of persistent blocks. BrentLane below
// is the port's only Brent (K7 keeps its own inside its cooperative
// launch); the one-thread-a-lane Brent it was cut from is gone,
// K12 having been its last user. The solve a lane runs is the driver's
// Stepper, BrentLane unless named: K17 (bisection) runs BisectionLane, the
// fixed-count bisection, whose lanes lane_queue_kernel deals from one
// queue for the whole grid (below).
//
// Each lane runs the expand-then-Brent of vic_tpu/ops/rootfind.py:43-207
// (expand_brackets + batched_brent) step for step on the same floats, so a
// lane's root, flags and iterations do not depend on which thread runs it
// or when. Where the batched versions keep iterating a converged lane until
// every lane is done, a lane stops at once: the batch loop's rearrangement
// (same-side reset, then best-iterate swap) runs on frozen lanes too, and
// it is idempotent after one pass, so rearranging first and then testing
// for convergence leaves (b, c) exactly where the batch loop leaves them.
// Unbracketed or inactive lanes return the midpoint of the ORIGINAL [lo,
// hi] with converged = bracketed = false (rootfind.py:205).
//
// What bounds one thread a lane on this card: a lane reads a few hundred
// bytes and then runs 2 to ~70 dependent residual evaluations, so the
// kernel is bound by latency, not by bytes or operations. A warp runs until
// its slowest lane is done while its inactive and finished lanes hold their
// slots; these batches are mostly such lanes (the canopy residual runs on
// overstory lanes only, the surface residual on the lanes that are not
// glacier or lake, the snowpack residual on the packs that neither melt at
// 0 C nor are thin, the glacier residual on the bare-ice HRUs that do not
// melt at 0 C, at most 2 of a cell's 8, the lake ice residual on the iced
// lakes whose snow neither melts nor is thin).
//
// What this driver does about it:
// - Persistent blocks: the grid is as many blocks as the device keeps
//   resident (cudaOccupancyMaxActiveBlocksPerMultiprocessor), at most one
//   per kLaneBlock lanes; each block owns one contiguous chunk of the lanes.
// - Compaction: a thread that needs work takes the next lane of its block's
//   chunk from a counter in shared memory; an inactive lane gets its outputs
//   at once (the midpoint of [lo, hi], not converged, not bracketed, 0
//   iterations) and the thread takes the next, so only active lanes hold a
//   thread, and warps stay full while their chunk lasts.
// - Refill: a thread whose lane is done stores its outputs and takes the
//   next lane of the chunk, so a warp does not wait on one slow lane. Every
//   trip of the loop evaluates the residual once on each busy thread (at its
//   own lane's candidate), so the warp's threads run the residual together
//   whatever step of the solve each of them is in.
// - Hooks (K1, K2, K5, K12): a lane type may also declare a prologue, run
//   on every lane when it is taken, which writes what the caller needs
//   before the solve and may take the lane out of it (K1's, K2's and K12's
//   balance at 0 C and melt test), a bracket, which forms the lane's
//   starting bracket after its prologue (K12: old_tsurf -/+ SNOW_DT), and an
//   epilogue, run on every lane, inactive ones too, once its root is
//   known, which writes the balance's terms at the accepted temperature
//   (K1, K12: 0 C on a lane that melts, which its lane object remembers
//   from its prologue) and what its caller forms from them (K12: the whole
//   state update of lake_ice_melt). Their callers then evaluate no residual
//   of their own. A
//   solved lane's epilogue waits until its warp refills, so the warp's
//   finished lanes run theirs together rather than each beside the others'
//   residuals (K5 on light's first record, H100: 0.27 ms of device time
//   this way, 0.34 with each epilogue run as its lane finished; PERF.md).
//   A lane type without hooks (K3, K14) compiles to the loop without them.
//   The lane object a thread holds is init()ed anew only when the thread
//   takes its next lane, after the epilogue of the one it finished, so an
//   epilogue may read what the lane's own prologue stored in it.
#pragma once

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>
#include <mutex>
#include <type_traits>

#include "brent.cuh"
#include "lanes.cuh"

namespace vicbrent {

constexpr int kLaneBlock = 128;
// the C interface's refusal where no block of the kernel fits on an SM
// (kernels._check_lane_brent names it)
constexpr int kNoResidentBlock = -3;

// The Brent of one lane, cut at each residual evaluation: start() and
// then, while !done, the caller evaluates the residual at x and hands the
// value to next(). The floats are formed by the same expressions in the
// same order as the retired one-thread Brent formed them (its K12 roots,
// flags and iterations are this driver's, bit for bit).
struct BrentLane {
  float x;                          // where the residual is wanted next
  float lo, hi, a, b, c, fa, fb, fc, d, e, d_new, e_new;
  int tries, it, max_iter, max_tries;
  enum Phase { kAtA, kAtB, kBrent, kDone } phase;
  BrentOut out;

  __device__ __forceinline__ void start(float lo_, float hi_, bool active,
                                        int max_iter_, int max_tries_) {
    lo = lo_;
    hi = hi_;
    max_iter = max_iter_;
    max_tries = max_tries_;
    out = BrentOut{0.5f * (lo + hi), false, false, 0};
    if (!active) {
      phase = kDone;
      return;
    }
    // bracket expansion (root_brent.c:183-244)
    a = lo;
    b = hi;
    tries = 0;
    phase = kAtA;
    x = a;
  }

  __device__ __forceinline__ void next(float v) {
    const float kTstep = 10.0f;
    if (phase == kAtA) {
      fa = v;
      phase = kAtB;
      x = b;
      return;
    }
    if (phase == kAtB) {
      fb = v;
      if (tries < max_tries && fa * fb >= 0.0f) {
        a = a - kTstep;
        b = b + kTstep;
        ++tries;
        phase = kAtA;
        x = a;
        return;
      }
      if (!(fa * fb < 0.0f)) {
        phase = kDone;
        return;
      }
      out.bracketed = true;
      c = a;
      fc = fa;
      d = b - a;
      e = b - a;
      it = 0;
      iterate();
      return;
    }
    // kBrent: the value at the step taken
    fb = v;
    d = d_new;
    e = e_new;
    ++it;
    iterate();
  }

  // the top of the Brent loop at iteration `it`: the stop, or the next
  // step and its candidate
  __device__ __forceinline__ void iterate() {
    const float kTol = 1e-4f;
    const float kEps2 = 2.0f * FLT_EPSILON;
    if (it < max_iter) {
      // rearrange so b is the best iterate and [b, c] brackets the root
      if (fb * fc > 0.0f) {
        c = a;
        fc = fa;
        d = b - a;
        e = d;
      }
      if (fabsf(fc) < fabsf(fb)) {
        const float ob = b, ofb = fb;
        a = ob;
        b = c;
        c = ob;
        fa = ofb;
        fb = fc;
        fc = ofb;
      }
      const float tol_i = kEps2 * fabsf(b) + kTol;
      const float m = 0.5f * (c - b);
      if (!(fabsf(m) <= tol_i || fb == 0.0f)) {
        // secant (a == c) or inverse quadratic interpolation, else bisection
        const bool use_bisect = fabsf(e) < tol_i || fabsf(fa) <= fabsf(fb);
        const float s = fb / (fa == 0.0f ? 1.0f : fa);
        float p, q;
        if (a == c) {
          p = 2.0f * m * s;
          q = 1.0f - s;
        } else {
          const float fcs = fc == 0.0f ? 1.0f : fc;
          const float qq = fa / fcs;
          const float r = fb / fcs;
          p = s * (2.0f * m * qq * (qq - r) - (b - a) * (r - 1.0f));
          q = (qq - 1.0f) * (r - 1.0f) * (s - 1.0f);
        }
        if (p > 0.0f) q = -q;
        p = fabsf(p);
        const bool interp_ok =
            (2.0f * p < 3.0f * m * q - fabsf(tol_i * q)) &&
            (p < fabsf(0.5f * e * q));
        if (!use_bisect && interp_ok) {
          e_new = d;
          d_new = p / (q == 0.0f ? 1.0f : q);
        } else {
          e_new = m;
          d_new = m;
        }
        const float step =
            fabsf(d_new) > tol_i ? d_new : (m > 0.0f ? tol_i : -tol_i);
        a = b;
        fa = fb;
        b = b + step;
        phase = kBrent;
        x = b;
        return;
      }
    }
    out.iterations = it;
    const float tol_f = kEps2 * fabsf(b) + kTol;
    out.converged = fabsf(0.5f * (c - b)) <= tol_f || fb == 0.0f;
    out.root = b;
    phase = kDone;
  }
};

// The fixed-count bisection of one lane (K17), cut at each residual
// evaluation like BrentLane, with its interface (start, x, next, phase ==
// kDone, out): vic_tpu/ops/rootfind.py:210-234 (batched_bisection) and its
// plain copy in vic_tpu_torch/ops/rootfind.py for ONE lane. f(lo), then
// f(hi), bracketed = f(lo) * f(hi) < 0; then max_iter halvings that keep
// the left half where f(lo) * f(mid) <= 0 (f(mid) == 0 shrinks hi onto the
// root); the root is the midpoint of the final bracket, converged =
// bracketed, iterations = max_iter, and a lane runs every halving whether
// it brackets or not. An inactive lane gets the midpoint of [lo, hi], not
// converged, not bracketed, 0 iterations. The floats are formed by the same
// expressions in the same order as the retired one-thread loop formed
// them. max_tries is not read. Every active lane takes max_iter + 2
// evaluations, so it runs on lane_queue_kernel below.
struct BisectionLane {
  static constexpr bool kFixedCount = true;   // lane_queue_kernel's stepper
  float x;                          // where the residual is wanted next
  float lo, hi, f_lo;
  int it, n_iter;
  enum Phase { kAtLo, kAtHi, kHalve, kDone } phase;
  BrentOut out;

  __device__ __forceinline__ void start(float lo_, float hi_, bool active,
                                        int max_iter, int) {
    lo = lo_;
    hi = hi_;
    n_iter = max_iter;
    out = BrentOut{0.5f * (lo + hi), false, false, 0};
    if (!active) {
      phase = kDone;
      return;
    }
    phase = kAtLo;
    x = lo;
  }

  __device__ __forceinline__ void next(float v) {
    if (phase == kAtLo) {
      f_lo = v;
      phase = kAtHi;
      x = hi;
      return;
    }
    if (phase == kAtHi) {
      out.bracketed = f_lo * v < 0.0f;
      it = 0;
      halve();
      return;
    }
    // kHalve: v is the residual at the midpoint x
    if (f_lo * v <= 0.0f) {
      hi = x;
    } else {
      lo = x;
      f_lo = v;
    }
    ++it;
    halve();
  }

  // the next midpoint, or the root once the n_iter halvings are done
  __device__ __forceinline__ void halve() {
    if (it < n_iter) {
      x = 0.5f * (lo + hi);
      phase = kHalve;
      return;
    }
    out.root = 0.5f * (lo + hi);
    out.converged = out.bracketed;
    out.iterations = n_iter;
    phase = kDone;
  }
};

// A warp takes new lanes only when kRefillAt of its threads are idle (or
// all are): a thread that takes a lane first forms its Ts-independent terms,
// and the warp's other threads wait through that, so lanes are taken
// together.
constexpr int kRefillAt = 8;

// A lane type's hooks, found by their names:
//   __device__ bool prologue(const LaneInputs&, LaneRow, int lane,
//                            bool active, const Params&);
//     after init(), on every lane: writes what it must and returns whether
//     the lane is solved (at most `active`);
//   __device__ void epilogue(const LaneInputs&, LaneRow, int lane,
//                            const BrentOut&, const Params&) const;
//     on every lane once its root, flags and iterations are known.
// Both may read the lane's inputs again where they lie.
// A lane type with either hook is init()ed on every lane, inactive ones
// too; one without them only on the lanes it solves.
template <class Lane, class = void>
struct HasPrologue : std::false_type {};
template <class Lane>
struct HasPrologue<Lane, std::void_t<decltype(&Lane::prologue)>>
    : std::true_type {};
template <class Lane, class = void>
struct HasEpilogue : std::false_type {};
template <class Lane>
struct HasEpilogue<Lane, std::void_t<decltype(&Lane::epilogue)>>
    : std::true_type {};
//   __device__ void bracket(float* lo, float* hi) const;
//     after the prologue: the lane's starting bracket, where the lane
//     forms it (K12: old_tsurf -/+ SNOW_DT) rather than reading lo and hi
//     from its inputs kLo and kHi.
template <class Lane, class = void>
struct HasBracket : std::false_type {};
template <class Lane>
struct HasBracket<Lane, std::void_t<decltype(&Lane::bracket)>>
    : std::true_type {};

// The kernel: Lane is a residual functor with
//   static constexpr int kLo, kHi, kActive;  // lane inputs: bracket, mask
//                                            // (no kLo, kHi with bracket())
//   static constexpr int kMinBlocks;         // __launch_bounds__' minimum
//   __device__ void init(const LaneInputs&, LaneRow, const Params&);
//   __device__ float operator()(float) const;
// and, optionally, the hooks above; Params are its launch-wide arguments
// (dt, switches, the hooks' outputs); Stepper is the solve (BrentLane or
// BisectionLane; max_iter and max_tries go to its start()). Each block
// walks its chunk [blockIdx.x * chunk, ...) of the n lanes as the header
// says; every thread stays in the loop until its warp is done, for the
// warp votes.
template <class Lane, class Params, class Stepper = BrentLane>
__global__ void __launch_bounds__(kLaneBlock, Lane::kMinBlocks)
    lane_brent_kernel(const __grid_constant__ LaneInputs in,
                      const Params params, int max_iter, int max_tries,
                      int n, int chunk, BrentOutputs out) {
  constexpr unsigned kAll = 0xffffffffu;
  constexpr bool kPrologue = HasPrologue<Lane>::value;
  constexpr bool kEpilogue = HasEpilogue<Lane>::value;
  __shared__ int next_lane;
  const int first = blockIdx.x * chunk;
  const int end = min(first + chunk, n);
  if (threadIdx.x == 0) next_lane = first;
  __syncthreads();
  Lane f;
  Stepper s;
  int i = -1;                       // the lane this thread solves
  int done = -1;                    // a solved lane whose epilogue waits
  bool more = true;                 // the chunk may hold lanes not taken
  while (true) {
    const unsigned busy = __ballot_sync(kAll, i >= 0);
    if (more && __popc(busy) <= 32 - kRefillAt) {
      // the warp's solved lanes run their epilogues together, before
      // their threads take new lanes
      if constexpr (kEpilogue) {
        if (done >= 0) {
          f.epilogue(in, lane_row(in, done), done, s.out, params);
          store(out, done, s.out);
          done = -1;
        }
      }
      // take lanes until one needs the residual or the chunk is done; an
      // inactive lane gets its outputs here
      bool drained = false;
      while (i < 0) {
        const int k = atomicAdd(&next_lane, 1);
        if (k >= end) {
          drained = true;
          break;
        }
        const LaneRow row = lane_row(in, k);
        bool active = lane_m(in, Lane::kActive, row);
        if constexpr (kPrologue || kEpilogue) f.init(in, row, params);
        if constexpr (kPrologue)
          active = f.prologue(in, row, k, active, params);
        float lo, hi;
        if constexpr (HasBracket<Lane>::value) {
          f.bracket(&lo, &hi);
        } else {
          lo = lane_f(in, Lane::kLo, row);
          hi = lane_f(in, Lane::kHi, row);
        }
        s.start(lo, hi, active, max_iter, max_tries);
        if (s.phase == Stepper::kDone) {
          if constexpr (kEpilogue) f.epilogue(in, row, k, s.out, params);
          store(out, k, s.out);
          continue;
        }
        if constexpr (!(kPrologue || kEpilogue)) f.init(in, row, params);
        i = k;
      }
      more = !__any_sync(kAll, drained);
    }
    if (!more && !__any_sync(kAll, i >= 0)) {
      if constexpr (kEpilogue) {
        if (done >= 0) {
          f.epilogue(in, lane_row(in, done), done, s.out, params);
          store(out, done, s.out);
        }
      }
      break;
    }
    if (i >= 0) {
      s.next(f(s.x));
      if (s.phase == Stepper::kDone) {
        if constexpr (kEpilogue) {
          done = i;
        } else {
          store(out, i, s.out);
        }
        i = -1;
      }
    }
  }
}

// A stepper whose every active lane takes the same evaluations, at least
// two, declares kFixedCount (BisectionLane); launch_lane_brent runs it on
// lane_queue_kernel.
template <class Stepper, class = void>
struct FixedCount : std::false_type {};
template <class Stepper>
struct FixedCount<Stepper, std::enable_if_t<Stepper::kFixedCount>>
    : std::true_type {};

// The i-th (from 0) set bit of mask, which holds more than i.
__device__ __forceinline__ int nth_set_bit(unsigned mask, int i) {
  for (; i > 0; --i) mask &= mask - 1u;
  return __ffs(mask) - 1;
}

// The driver of a fixed-count stepper. Its lanes all take the same
// evaluations, so nothing is gained by refilling a warp lane by lane, and
// what costs is a block whose chunk holds more active lanes than its
// threads: lane_brent_kernel's contiguous chunks put 216 of K17's 91,928
// snowpack lanes in the densest of light's 660 chunks, and its block ran
// a second round (PERF.md). Here every warp takes 32-lane tiles
// from one queue for the whole grid (queue[0], the first lane of the next
// tile, one atomicAdd a tile), writes the outputs of the tile's inactive
// lanes at once, deals its active lanes to the warp's idle threads in
// order, and takes the next tile while threads are idle and tiles are
// left; then its threads solve their lanes together, from start to kDone
// with no vote between evaluations, and the warp deals again. So active
// lanes fill whole warps and the grid runs ceil(active lanes / resident
// threads) rounds. What bounds a round is each lane's chain of dependent
// evaluations: spreading the lanes thinner over more warps, or claiming
// four tiles at a time, was slower (PERF.md). The last block to
// finish sets queue[0] and its ticket queue[1] back to 0 for the next
// launch. A lane type here has no hooks.
template <class Lane, class Params, class Stepper>
__global__ void __launch_bounds__(kLaneBlock, Lane::kMinBlocks)
    lane_queue_kernel(const __grid_constant__ LaneInputs in,
                      const Params params, int max_iter, int max_tries,
                      int n, int* queue, BrentOutputs out) {
  static_assert(!HasPrologue<Lane>::value && !HasEpilogue<Lane>::value &&
                    !HasBracket<Lane>::value,
                "lane_queue_kernel runs lane types without hooks");
  constexpr unsigned kAll = 0xffffffffu;
  const unsigned me = threadIdx.x % 32u;
  const unsigned below = (1u << me) - 1u;   // the warp's lanes below mine
  int base = 0;          // the warp's tile [base, base + 32)
  unsigned pending = 0;  // its active lanes not dealt yet
  bool more = true;      // tiles may be left
  while (true) {
    int k = -1;                     // the lane this thread solves
    unsigned idle = kAll;
    while (idle && more) {
      if (!pending) {
        int first = 0;
        if (me == 0) first = atomicAdd(queue, 32);
        base = __shfl_sync(kAll, first, 0);
        if (base >= n) {
          more = false;
          break;
        }
        const int j = base + static_cast<int>(me);
        bool active = false;
        if (j < n) {
          const LaneRow row = lane_row(in, j);
          active = lane_m(in, Lane::kActive, row);
          if (!active) {
            Stepper s;
            s.start(lane_f(in, Lane::kLo, row), lane_f(in, Lane::kHi, row),
                    false, max_iter, max_tries);
            store(out, j, s.out);
          }
        }
        pending = __ballot_sync(kAll, active);
      }
      // the r-th idle thread takes the r-th pending lane
      const int rank = __popc(idle & below);
      const bool takes = (idle >> me & 1u) && rank < __popc(pending);
      if (takes) k = base + nth_set_bit(pending, rank);
      const unsigned took = __ballot_sync(kAll, takes);
      for (int d = __popc(took); d > 0; --d) pending &= pending - 1u;
      idle &= ~took;
    }
    if (!__any_sync(kAll, k >= 0)) break;
    if (k >= 0) {
      const LaneRow row = lane_row(in, k);
      Lane f;
      f.init(in, row, params);
      Stepper s;
      s.start(lane_f(in, Lane::kLo, row), lane_f(in, Lane::kHi, row), true,
              max_iter, max_tries);
      // an active lane's first two evaluations (f(lo), f(hi)) peeled, so
      // the loop is the halving step alone (faster: PERF.md)
      s.next(f(s.x));
      s.next(f(s.x));
      while (s.phase != Stepper::kDone) s.next(f(s.x));
      store(out, k, s.out);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(queue + 1, 1) == static_cast<int>(gridDim.x) - 1) {
      queue[0] = 0;
      queue[1] = 0;
    }
  }
}

// Launches lane_queue_kernel<Lane, Params, Stepper> on stream: grid of the
// blocks the device keeps resident, at most one per kLaneBlock lanes, and
// the queue's two counters, made once a (device, stream) (zeroed on the
// stream then, and by each launch's last block after): launches on one
// stream run one after another, and the shares of a split block, each on a
// stream of its own, never share a queue. Returns kNoResidentBlock where
// no block fits, else the first CUDA error.
template <class Lane, class Params, class Stepper>
int launch_lane_queue(const LaneInputs& in, const Params& params,
                      int max_iter, int max_tries, int n,
                      const BrentOutputs& out, cudaStream_t stream) {
  constexpr int kMaxDevices = 64, kMaxQueues = 256;
  struct Queue {
    int dev;
    cudaStream_t stream;
    int* counters;
  };
  static int resident[kMaxDevices];   // blocks resident a device, 0: unknown
  static Queue queues[kMaxQueues];
  static int n_queues = 0;
  static std::mutex lock;   // the shares launch from threads of their own
  const std::lock_guard<std::mutex> held(lock);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, lane_queue_kernel<Lane, Params, Stepper>, kLaneBlock, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return kNoResidentBlock;
    resident[dev] = per_sm * sms;
  }
  int* counters = nullptr;
  for (int q = 0; q < n_queues; ++q)
    if (queues[q].dev == dev && queues[q].stream == stream)
      counters = queues[q].counters;
  if (counters == nullptr) {
    if (n_queues == kMaxQueues) return static_cast<int>(cudaErrorNotSupported);
    err = cudaMalloc(&counters, 2 * sizeof(int));
    if (err == cudaSuccess)
      err = cudaMemsetAsync(counters, 0, 2 * sizeof(int), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    queues[n_queues++] = Queue{dev, stream, counters};
  }
  const int needed = (n + kLaneBlock - 1) / kLaneBlock;
  const int blocks = resident[dev] < needed ? resident[dev] : needed;
  lane_queue_kernel<Lane, Params, Stepper><<<blocks, kLaneBlock, 0, stream>>>(
      in, params, max_iter, max_tries, n, counters, out);
  return static_cast<int>(cudaGetLastError());
}

// Launches lane_brent_kernel<Lane, Params, Stepper> on stream: grid of the
// blocks the device keeps resident, at most one per kLaneBlock lanes (the
// occupancy query made once a device). Returns kNoResidentBlock where none
// fits, else the launch's error.
template <class Lane, class Params, class Stepper>
int launch_lane_chunks(const LaneInputs& in, const Params& params,
                       int max_iter, int max_tries, int n,
                       const BrentOutputs& out, cudaStream_t stream) {
  constexpr int kMaxDevices = 64;
  static int resident[kMaxDevices];   // blocks resident on a device, 0: unknown
  static std::mutex lock;   // the shares launch from threads of their own
  const std::lock_guard<std::mutex> held(lock);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, lane_brent_kernel<Lane, Params, Stepper>, kLaneBlock, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return kNoResidentBlock;
    resident[dev] = per_sm * sms;
  }
  const int needed = (n + kLaneBlock - 1) / kLaneBlock;
  const int blocks = resident[dev] < needed ? resident[dev] : needed;
  const int chunk = (n + blocks - 1) / blocks;
  lane_brent_kernel<Lane, Params, Stepper><<<blocks, kLaneBlock, 0, stream>>>(
      in, params, max_iter, max_tries, n, chunk, out);
  return static_cast<int>(cudaGetLastError());
}

// Launches the lanes of Lane on stream with Stepper's solve: on
// lane_queue_kernel for a fixed-count Stepper, else on lane_brent_kernel.
template <class Lane, class Params, class Stepper = BrentLane>
int launch_lane_brent(const LaneInputs& in, const Params& params,
                      int max_iter, int max_tries, int n,
                      const BrentOutputs& out, cudaStream_t stream) {
  if constexpr (FixedCount<Stepper>::value)
    return launch_lane_queue<Lane, Params, Stepper>(
        in, params, max_iter, max_tries, n, out, stream);
  else
    return launch_lane_chunks<Lane, Params, Stepper>(
        in, params, max_iter, max_tries, n, out, stream);
}

}  // namespace vicbrent
