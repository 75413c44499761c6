// Shared helpers of the asgart_tpu_torch kernels (plain C interface,
// loaded with ctypes; see asgart_tpu_torch/kernels/_build.py).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define ASGART_API extern "C" __attribute__((visibility("default")))

namespace asgart {

constexpr int kThreads = 256;

// Blocks for a grid-stride loop over n items: enough to fill the card
// (132 SMs x 8 resident blocks of 256 threads) without a giant grid.
inline unsigned grid_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  if (b > 132LL * 32) b = 132LL * 32;
  return (unsigned)(b < 1 ? 1 : b);
}

// Index of the chunk whose lane range [off[c], off[c+1]) holds `lane`
// (off has n_chunks + 1 ascending entries; off[0] == 0).
__device__ __forceinline__ int chunk_of(const long long* off, int n_chunks,
                                        long long lane) {
  int lo = 0, hi = n_chunks - 1;
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if (__ldg(off + mid) <= lane) lo = mid; else hi = mid - 1;
  }
  return lo;
}

}  // namespace asgart
