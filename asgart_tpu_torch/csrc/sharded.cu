// KT gather_owned: one rank's share of the match gather of the
// rank-sharded window engine.
//
// Replaces (JAX reference): the sa_gather of _sharded_window_core_fn,
// asgart_tpu/device_engine.py:3180-3188, inside _core_from_ranges (:249).
// There every device of the mesh gathers sa[idx] from its own rows of the
// window's suffix order (rows [d * Wl, (d + 1) * Wl)), writes 0 where the
// row is another device's, and a psum over the mesh combines the devices'
// buffers; the flat CSR expansion around it is _core_from_ranges' own.
//
// Here the expansion is explicit: for every masked lane l of a chunk (or of
// one of its slices), with [lane_lo, lane_hi) its window after stage 1's
// all_reduce and off[l] its exclusive offset in the chunk's CSR buffer,
//   flat[off[l] + t] = sa_local[lane_lo[l] + t - row0]   (row owned)
//                    = 0                                  (otherwise)
// for t < lane_hi[l] - lane_lo[l], where this rank owns the rows
// [row0, row0 + n_local) and sa_local holds their window positions. The
// engine sums the ranks' buffers with an all_reduce and hands the sum to KD
// as the suffix order of lanes [off, off + count).
//
// Bound on the H100: memory. 9 B read per lane (lo, hi, mask), 8 B (off)
// per lane that has entries, 4 B per flat entry written, and 4 B per owned
// entry read from sa_local; the owned rows of one lane are one contiguous
// span. A chunk has millions of lanes, and most have no entry (rank_trim4's
// largest chunk: 24,127 of 6.4 M), so the lane stream sets the time.
//
// Design: one thread a lane reads the lane stream, so lo, hi and mask are
// read once, coalesced, with every load of a warp in flight together. A
// warp ballot finds the lanes with entries; the warp then serves them one
// after another, their bounds and offsets passed by shuffles, its 32
// threads writing a lane's entries (zeros and owned rows alike) at
// consecutive addresses and reading the owned rows at consecutive
// addresses, so a lane of any length stays coalesced. The loop's bound is
// uniform over the warp, so every warp stays converged for the ballot and
// the shuffles. Each entry is written once: a memset of the buffer first
// would write the owned entries twice and add a launch.
#include "common.cuh"

namespace {

__global__ void gather_owned_kernel(const int* __restrict__ lane_lo,
                                    const int* __restrict__ lane_hi,
                                    const uint8_t* __restrict__ lane_mask,
                                    const long long* __restrict__ off,
                                    long long n,
                                    const int* __restrict__ sa_local,
                                    long long row0, long long n_local,
                                    int* __restrict__ flat) {
  const unsigned kFull = 0xFFFFFFFFu;
  const int t0 = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // base: the warp's first lane, the same for its 32 threads
  for (long long base = (long long)blockIdx.x * blockDim.x + threadIdx.x - t0;
       base < n; base += stride) {
    const long long l = base + t0;
    int lo = 0, cnt = 0;
    if (l < n) {
      const int a = __ldg(lane_lo + l), b = __ldg(lane_hi + l);
      if (__ldg(lane_mask + l)) {
        lo = a;
        cnt = b - a;
      }
    }
    unsigned live = __ballot_sync(kFull, cnt > 0);
    if (!live) continue;
    const long long o = cnt > 0 ? __ldg(off + l) : 0;
    while (live) {
      const int src = __ffs(live) - 1;
      live &= live - 1;
      const long long lo_s = __shfl_sync(kFull, lo, src);
      const int cnt_s = __shfl_sync(kFull, cnt, src);
      int* out = flat + __shfl_sync(kFull, o, src);
      for (int t = t0; t < cnt_s; t += 32) {
        const long long row = lo_s + t - row0;
        out[t] = (row >= 0 && row < n_local) ? __ldg(sa_local + row) : 0;
      }
    }
  }
}

}  // namespace

// lane_lo, lane_hi: int32 [n]; lane_mask: bool [n]; off: int64 [n], the
// exclusive prefix sums of the masked lanes' counts; sa_local: int32
// [n_local] (may be empty); flat: int32, off[n - 1] + the last count long.
ASGART_API int asgart_gather_owned(const void* lane_lo, const void* lane_hi,
                                   const void* lane_mask, const void* off,
                                   long long n, const void* sa_local,
                                   long long row0, long long n_local,
                                   void* flat, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  gather_owned_kernel<<<asgart::grid_for(n), asgart::kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const int*)lane_lo, (const int*)lane_hi, (const uint8_t*)lane_mask,
      (const long long*)off, n, (const int*)sa_local, row0, n_local,
      (int*)flat);
  return (int)cudaGetLastError();
}
