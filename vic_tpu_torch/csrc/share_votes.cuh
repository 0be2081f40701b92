// The batch-wide decisions of K6 and K7 taken over every share of a batch
// split across launches (parallel/votes.py).
//
// A cell block split over devices runs one cooperative launch a share, each
// on its own device (or its own stream of one device), in step: the shares
// make the same votes in the same order, since each decision is the same on
// every share. After a vote's grid sync, thread 0 of block 0 of each share
// calls exchange(): it publishes the share's own decision to its slot, a
// word of mapped pinned host memory that every device reads at its host
// address, polls the other shares' slots with volatile loads until each
// carries this vote's sequence number, and returns the decisions combined;
// the caller writes that into the grid's control slot and syncs the grid
// again. No decision is taken on one share's batch alone.
//
// The group's words (uint64, parallel/votes.py ShareGroup._device_words),
// for n shares:
//   [0, 2n)       the slots, two rows used by turns (the vote's parity), a
//                 word a share: sequence number << 32 | payload; so a share
//                 that has passed vote k can publish vote k + 1 before a
//                 slow share has read vote k, and cannot reach k + 2 before
//                 every share has published k + 1, i.e. read k
//   2n            the abort word: nonzero once the group was aborted
//   2n + 1 + s    share s's vote count (its last sequence number)
//   3n + 1 + s    share s's error: sequence << 32 | code << 16 | the share
//                 it waited for
// A vote that waits longer than the time limit (read from %globaltimer), or
// finds the abort word set, records its error, sets the abort word (so the
// other shares' launches end too) and returns the decision that stops the
// loop; the wrapper raises it (Member.settle). Nothing falls back to a
// local decision.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace vicvote {

struct ShareVotes {
  unsigned long long* words;   // null: the launch holds the whole batch
  int share, n;
  int divisor;                 // shares on this device (the grid's divisor)
  unsigned long long timeout_ns;
};

// the payload of a NaN largest change, above every non-NaN one's bits
constexpr uint32_t kNanPayload = 0x7fc00000u;
enum VoteError { kTimedOut = 1, kAborted = 2 };

// the kernel's ShareVotes from the wrapper's group table ([words, share, n,
// divisor, timeout_ns] as int64; null: no group); false if it is not one
inline bool fill_share_votes(ShareVotes* v, const int64_t* group) {
  *v = ShareVotes{};
  v->divisor = 1;
  if (group == nullptr) return true;
  v->words = reinterpret_cast<unsigned long long*>(group[0]);
  v->share = static_cast<int>(group[1]);
  v->n = static_cast<int>(group[2]);
  v->divisor = static_cast<int>(group[3]);
  v->timeout_ns = static_cast<unsigned long long>(group[4]);
  return v->words != nullptr && v->n >= 2 && v->share >= 0 &&
         v->share < v->n && v->divisor >= 1;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// the largest of two payloads of largest changes (non-negative floats'
// bits, so the int order is the float order), NaN if either is
__device__ __forceinline__ uint32_t max_nan(uint32_t a, uint32_t b) {
  if (a == kNanPayload || b == kNanPayload) return kNanPayload;
  return a > b ? a : b;
}

__device__ __forceinline__ uint32_t any_of(uint32_t a, uint32_t b) {
  return a | b;
}

// By ONE thread of the grid: this share's next vote with payload `mine`,
// combined with every other share's by `combine`; `stop` where the vote
// failed (its error recorded).
template <class Combine>
__device__ uint32_t exchange(const ShareVotes& v, uint32_t mine,
                             Combine combine, uint32_t stop) {
  volatile unsigned long long* w = v.words;
  const int n = v.n;
  volatile unsigned long long* abort_word = w + 2 * n;
  volatile unsigned long long* count = w + 2 * n + 1 + v.share;
  volatile unsigned long long* error = w + 3 * n + 1 + v.share;
  const unsigned long long seq = (*count + 1) & 0xffffffffull;
  *count = seq;
  volatile unsigned long long* row = w + (seq & 1) * n;
  auto fail = [&](int code, int other) {
    if (*error == 0)
      *error = seq << 32 | static_cast<unsigned long long>(code) << 16 |
               static_cast<unsigned long long>(other);
    *abort_word = 1;
    __threadfence_system();
    return stop;
  };
  if (*abort_word != 0) return fail(kAborted, v.share);
  __threadfence_system();
  row[v.share] = seq << 32 | mine;
  __threadfence_system();
  const unsigned long long start = global_ns();
  uint32_t out = mine;
  for (int s = 0; s < n; ++s) {
    if (s == v.share) continue;
    unsigned long long x = row[s];
    while ((x >> 32) != seq) {
      if (*abort_word != 0) return fail(kAborted, s);
      if (global_ns() - start > v.timeout_ns) return fail(kTimedOut, s);
      __nanosleep(100);
      x = row[s];
    }
    out = combine(out, static_cast<uint32_t>(x));
  }
  return out;
}

}  // namespace vicvote
