// A Brent solve's outputs: a lane's root, flags and iterations, and where a
// kernel writes them.
//
// The port's only Brent is csrc/lane_brent.cuh's BrentLane: the
// expand-then-Brent of vic_tpu/ops/rootfind.py:43-207 (expand_brackets +
// batched_brent) and of its plain PyTorch copy in
// vic_tpu_torch/ops/rootfind.py, for ONE lane, cut at each residual
// evaluation (K1, K2, K3, K5, K12, K14; K7 keeps its own copy inside its
// cooperative launch). K17's bisection (BisectionLane, on the same lane
// driver) writes the same outputs.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

struct BrentOut {
  float root;
  bool converged;
  bool bracketed;
  int iterations;
};

// Outputs of a root-finding kernel, one element a lane.
struct BrentOutputs {
  float* root;
  uint8_t* converged;
  uint8_t* bracketed;
  int32_t* iterations;
};

__device__ __forceinline__ void store(const BrentOutputs& out, int i,
                                      const BrentOut& r) {
  out.root[i] = r.root;
  out.converged[i] = r.converged;
  out.bracketed[i] = r.bracketed;
  out.iterations[i] = r.iterations;
}
