// The mapped pinned words of a share group (share_votes.cuh,
// parallel/votes.py): no kernel of its own; K6 and K7 read and write the
// words while they vote.
//
// C interface for ctypes: each returns 0 or a CUDA error.

#include <cuda_runtime.h>

#include <cstdint>

extern "C" {

// n_words uint64 of pinned host memory, mapped into every device's address
// space and pinned for every context, zeroed; *words is its address, the
// same on the host and on every device (unified addressing).
int share_votes_alloc(int64_t n_words, void** words) {
  void* host = nullptr;
  cudaError_t err = cudaHostAlloc(&host, n_words * sizeof(uint64_t),
                                  cudaHostAllocMapped | cudaHostAllocPortable);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* dev = nullptr;
  err = cudaHostGetDevicePointer(&dev, host, 0);
  if (err == cudaSuccess && dev != host) err = cudaErrorInvalidValue;
  if (err != cudaSuccess) {
    cudaFreeHost(host);
    return static_cast<int>(err);
  }
  for (int64_t i = 0; i < n_words; ++i) static_cast<uint64_t*>(host)[i] = 0;
  *words = host;
  return 0;
}

int share_votes_free(void* words) {
  return static_cast<int>(cudaFreeHost(words));
}

}  // extern "C"
