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
// span. One warp per lane (grid-stride over lanes): its threads write the
// lane's entries, zeros and owned span alike, at consecutive addresses, and
// read the owned span at consecutive addresses, so both coalesce. Lanes
// with no match (most of them) cost one read of their bounds.
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
  const int t0 = threadIdx.x & 31;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long l = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       l < n; l += warps) {
    if (!lane_mask[l]) continue;
    const long long lo = lane_lo[l];
    const long long cnt = (long long)lane_hi[l] - lo;
    int* out = flat + off[l];
    for (long long t = t0; t < cnt; t += 32) {
      const long long row = lo + t - row0;
      out[t] = (row >= 0 && row < n_local) ? __ldg(sa_local + row) : 0;
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
  long long blocks = (n * 32 + asgart::kThreads - 1) / asgart::kThreads;
  if (blocks > 132LL * 32) blocks = 132LL * 32;
  gather_owned_kernel<<<(unsigned)blocks, asgart::kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const int*)lane_lo, (const int*)lane_hi, (const uint8_t*)lane_mask,
      (const long long*)off, n, (const int*)sa_local, row0, n_local,
      (int*)flat);
  return (int)cudaGetLastError();
}
