// KB group_bounds: equal-key run boundaries over the sorted fused keys.
//
// Replaces (JAX reference): asgart_tpu/device_index.py:352
// _group_bounds_impl in flagged mode (jitted as _group_bounds, :421).
//
//   run_lo[i]  start of row i's true-key run (key >> 1, flag dropped)
//   run_hi[i]  run_lo[i] for direct rows (sa < W); for probe rows the
//              start of the full-key run, i.e. the end of the group's
//              direct entries
//   tied[i]    direct row whose full-key run has length > 1
//
// The JAX package finds run starts with a cummax scan, which on a GPU
// needs a cross-block pass. Here every row finds its own run start by a
// galloping search backwards over the sorted keys (1, 2, 4, ... rows,
// then bisection): no cross-block dependency, and O(log run length) reads
// per row. Bound on the H100: memory — each row reads its own key and
// its neighbours' (shared through L1 by adjacent threads) and writes 9 B;
// only rows inside long runs (repeat k-mers) pay extra, cached, reads.
#include "common.cuh"

namespace {

// First index j <= i with (skey[j] >> shift) == (skey[i] >> shift);
// skey is sorted ascending, so the equal rows form one run ending at i.
__device__ __forceinline__ long long run_start(const long long* skey,
                                               long long i, int shift) {
  const long long v = skey[i] >> shift;
  if (i == 0 || (__ldg(skey + i - 1) >> shift) != v) return i;
  long long good = i - 1;  // known equal
  long long d = 1;
  long long bad = -1;      // known smaller (or before the array)
  while (true) {
    long long probe = i - 2 * d;
    if (probe < 0) { bad = -1; break; }
    if ((__ldg(skey + probe) >> shift) != v) { bad = probe; break; }
    good = probe;
    d *= 2;
  }
  while (good - bad > 1) {
    long long mid = bad + (good - bad) / 2;
    if ((__ldg(skey + mid) >> shift) == v) good = mid; else bad = mid;
  }
  return good;
}

__global__ void group_bounds_kernel(const long long* __restrict__ skey,
                                    const int* __restrict__ sa, long long M,
                                    long long W, int* __restrict__ run_lo,
                                    int* __restrict__ run_hi,
                                    uint8_t* __restrict__ tied) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < M; i += (long long)gridDim.x * blockDim.x) {
    const long long key = skey[i];
    const bool direct = sa[i] < W;
    const long long lo = run_start(skey, i, 1);
    run_lo[i] = (int)lo;
    run_hi[i] = (int)(direct ? lo : run_start(skey, i, 0));
    const bool starts = i == 0 || __ldg(skey + i - 1) != key;
    const bool ends = i == M - 1 || __ldg(skey + i + 1) != key;
    tied[i] = direct && !(starts && ends);
  }
}

}  // namespace

ASGART_API int asgart_group_bounds(const void* skey, const void* sa,
                                   long long M, long long W, void* run_lo,
                                   void* run_hi, void* tied, void* stream) {
  group_bounds_kernel<<<asgart::grid_for(M), asgart::kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const long long*)skey, (const int*)sa, M, W, (int*)run_lo,
      (int*)run_hi, (uint8_t*)tied);
  return (int)cudaGetLastError();
}
