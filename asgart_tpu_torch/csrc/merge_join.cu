// KH mj_ranges: the merge join of the window engine. For every probe lane,
// the equal range [lo, hi) of its key in the sorted window keys, plus exact
// per-chunk totals of (hi - lo) over the masked lanes.
//
// Replaces (JAX reference): asgart_tpu/device_engine.py:788 _mj_tail, as
// reached through _merge_join_core (:845), _window_ranges (:685),
// _window_ranges_batch (:865) and _mj_ranges_from_keys (:946; the donated
// variant :954 and _slice_lanes :964 have no counterpart).
//
// The JAX package co-sorts the W window keys with the tagged probe keys and
// reads hi (window entries at or before the probe: a cumsum) and lo (window
// entries before the probe's run: a cummax) off the co-sorted stream, then
// sorts both back into lane order: that is exactly the lower and upper
// bound of each probe key in the sorted window keys. Here every lane finds
// them itself: one binary search for the lower bound, then a gallop forward
// to the end of its run (most runs are short, and a long repeat run costs
// O(log run length) reads). No co-sort, so no (W + B)-row transient and no
// back-sorts. Keys compare without their flag bit (bit 0: 0 on window
// keys, 1 on probe keys), as KB compares them.
//
// Bound on the H100: the bytes are 8 B per probe key, 1 B per mask and
// 8 B of (lo, hi) per lane, plus the window keys once; but each search
// reads about log2(W) keys at data-dependent addresses, so the kernel is
// bound by the latency of those reads rather than the stream. The top
// levels of every search hit the same few keys and stay in L1/L2. One
// thread per lane, grid-stride, consecutive lanes on consecutive threads so
// the lane reads and writes coalesce; the totals reduce a warp's lanes with
// shuffles when the warp lies inside one chunk, with atomics only at chunk
// edges (as KC does).
#include "common.cuh"

namespace {

// First index in [0, W) whose flag-free key is >= v (W if none).
__device__ __forceinline__ long long lower_bound(const long long* skey,
                                                 long long W, long long v) {
  long long lo = 0, n = W;
  while (n > 0) {
    const long long half = n >> 1;
    if ((__ldg(skey + lo + half) >> 1) < v) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// First index after `lo` whose flag-free key differs from v, given that
// skey[lo] holds v: gallop forward (1, 2, 4, ... rows), then bisect.
__device__ __forceinline__ long long run_end(const long long* skey,
                                             long long W, long long lo,
                                             long long v) {
  long long good = lo;  // known equal
  long long bad = W;    // known different (or past the end)
  for (long long d = 1;; d *= 2) {
    const long long p = lo + d;
    if (p >= W) break;
    if ((__ldg(skey + p) >> 1) != v) { bad = p; break; }
    good = p;
  }
  while (bad - good > 1) {
    const long long mid = good + (bad - good) / 2;
    if ((__ldg(skey + mid) >> 1) == v) good = mid; else bad = mid;
  }
  return bad;
}

__global__ void mj_ranges_kernel(const long long* __restrict__ skey,
                                 long long W,
                                 const long long* __restrict__ pkey,
                                 const uint8_t* __restrict__ lane_mask,
                                 long long total,
                                 const long long* __restrict__ lane_off,
                                 int n_chunks, int* __restrict__ lane_lo,
                                 int* __restrict__ lane_hi,
                                 unsigned long long* __restrict__ totals) {
  const unsigned kFull = 0xFFFFFFFFu;
  const long long n_live = n_chunks > 0 ? lane_off[n_chunks] : 0;
  // the loop bound is uniform over the block, so every warp stays
  // converged for the shuffles
  for (long long base = (long long)blockIdx.x * blockDim.x; base < total;
       base += (long long)gridDim.x * blockDim.x) {
    const long long lane = base + threadIdx.x;
    int c = -1;
    unsigned long long v = 0;
    if (lane < total) {
      long long lo = 0, hi = 0;
      if (lane_mask[lane]) {
        const long long key = __ldg(pkey + lane) >> 1;
        lo = lower_bound(skey, W, key);
        hi = (lo < W && (__ldg(skey + lo) >> 1) == key)
                 ? run_end(skey, W, lo, key)
                 : lo;
      }
      lane_lo[lane] = (int)lo;
      lane_hi[lane] = (int)hi;
      if (lane < n_live) {
        c = asgart::chunk_of(lane_off, n_chunks, lane);
        v = (unsigned long long)(hi - lo);
      }
    }
    const int c0 = __shfl_sync(kFull, c, 0);
    if (__all_sync(kFull, c == c0)) {
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
      if ((threadIdx.x & 31) == 0 && c0 >= 0 && v) atomicAdd(totals + c0, v);
    } else if (c >= 0 && v) {
      atomicAdd(totals + c, v);
    }
  }
}

}  // namespace

ASGART_API int asgart_mj_ranges(const void* skey, long long W,
                                const void* pkey, const void* lane_mask,
                                long long total, const void* lane_off,
                                int n_chunks, void* lane_lo, void* lane_hi,
                                void* totals, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_chunks > 0) {
    cudaError_t rc = cudaMemsetAsync(
        totals, 0, sizeof(unsigned long long) * n_chunks, s);
    if (rc != cudaSuccess) return (int)rc;
  }
  mj_ranges_kernel<<<asgart::grid_for(total), asgart::kThreads, 0, s>>>(
      (const long long*)skey, W, (const long long*)pkey,
      (const uint8_t*)lane_mask, total, (const long long*)lane_off, n_chunks,
      (int*)lane_lo, (int*)lane_hi, (unsigned long long*)totals);
  return (int)cudaGetLastError();
}
