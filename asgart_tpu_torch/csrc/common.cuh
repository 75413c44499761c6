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

// First index j <= i of the run that holds row i, in an array whose equal
// rows are adjacent (sorted); `same(j)` says whether row j equals row i.
// Gallops backwards (1, 2, 4, ... rows), then bisects: O(log run length)
// reads per row and no cross-block dependency, in place of the cummax
// scan the JAX package uses.
template <class Same>
__device__ __forceinline__ long long run_start(long long i, Same same) {
  if (i == 0 || !same(i - 1)) return i;
  long long good = i - 1;  // known equal
  long long bad = -1;      // known different (or before the array)
  for (long long d = 1;; d *= 2) {
    const long long probe = i - 2 * d;
    if (probe < 0) break;
    if (!same(probe)) { bad = probe; break; }
    good = probe;
  }
  while (good - bad > 1) {
    const long long mid = bad + (good - bad) / 2;
    if (same(mid)) good = mid; else bad = mid;
  }
  return good;
}

// One past the last index of the run that holds row i in an array of n
// rows whose equal rows are adjacent: the forward mirror of run_start.
template <class Same>
__device__ __forceinline__ long long run_end(long long i, long long n,
                                             Same same) {
  if (i + 1 >= n || !same(i + 1)) return i + 1;
  long long good = i + 1;  // known equal
  long long bad = n;       // known different (or past the array)
  for (long long d = 1;; d *= 2) {
    const long long probe = i + 2 * d;
    if (probe >= n) break;
    if (!same(probe)) { bad = probe; break; }
    good = probe;
  }
  while (bad - good > 1) {
    const long long mid = good + (bad - good) / 2;
    if (same(mid)) good = mid; else bad = mid;
  }
  return bad;
}

}  // namespace asgart
