// KO granule_totals and KP gather_flat: the sliced dispatch of a
// repeat-heavy chunk.
//
// Replaces (JAX reference, asgart_tpu/):
//   KO  device_engine.py:589 _range_granule_totals (the window engines'
//       sizing pass over stage-1 ranges) and :167 _raw_total_granules
//       (the table engine's, over the lanes KM reads from the position
//       tables): the sum of hi - lo over the masked lanes of each granule
//       of SLICE_GRAN consecutive probe lanes, the input of the slice
//       plan. The JAX functions sum in float32; KO sums exactly in int64
//       (a repeat chunk's granules pass 2^24, its slices 2^31).
//   KP  device_engine.py:1112 _gather_flat: out[t] = src[idx[t]] over a
//       flat int32 source and int64 indices. The source is the
//       concatenation of up to S buffers (a sliced chunk's KD outputs),
//       given as a table of pointers and their offsets in the
//       concatenation, so the slices are merged into one buffer without
//       first being copied into one.
//
// KO: one block per granule (grid-stride over granules); its threads read
//   the granule's lanes in order (coalesced), sum in int64, and reduce
//   with warp shuffles, then through shared memory.
//   Bound on the H100: memory. 9 B per lane read once, 8 B per granule
//   written; two integer operations per lane.
// KP: one thread per output (grid-stride); the source buffer of idx[t] by
//   binary search over the S + 1 offsets (S is a handful; the offsets stay
//   in L1), then one 4-byte read.
//   Bound on the H100: memory. 8 B of index and 4 B of output per entry in
//   order, and 4 B of source per entry; the merge's indices run in order
//   within each of the source's segments, so the source reads coalesce.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;
}

__global__ void granule_totals_kernel(const int* __restrict__ lane_lo,
                                      const int* __restrict__ lane_hi,
                                      const uint8_t* __restrict__ lane_mask,
                                      long long n, long long gran,
                                      long long n_gran,
                                      long long* __restrict__ totals) {
  __shared__ long long part[asgart::kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (long long g = blockIdx.x; g < n_gran; g += gridDim.x) {
    const long long a = g * gran;
    const long long b = a + gran < n ? a + gran : n;
    long long s = 0;
    for (long long l = a + threadIdx.x; l < b; l += blockDim.x) {
      if (lane_mask[l]) s += (long long)lane_hi[l] - lane_lo[l];
    }
    s = warp_sum(s);
    if (lane == 0) part[warp] = s;
    __syncthreads();
    if (warp == 0) {
      s = lane < (int)(blockDim.x >> 5) ? part[lane] : 0;
      s = warp_sum(s);
      if (lane == 0) totals[g] = s;
    }
    __syncthreads();  // part is rewritten for the next granule
  }
}

__global__ void gather_flat_kernel(const long long* __restrict__ srcs,
                                   const long long* __restrict__ src_off,
                                   int n_src, const long long* __restrict__ idx,
                                   long long n, int* __restrict__ out) {
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < n; t += (long long)gridDim.x * blockDim.x) {
    const long long i = idx[t];
    const int s = asgart::chunk_of(src_off, n_src, i);
    const int* src = reinterpret_cast<const int*>(srcs[s]);
    out[t] = src[i - src_off[s]];
  }
}

}  // namespace

// lane_lo, lane_hi: int32 [n]; lane_mask: bool [n]; totals: int64
// [ceil(n / gran)] (the last granule partial).
ASGART_API int asgart_granule_totals(const void* lane_lo, const void* lane_hi,
                                     const void* lane_mask, long long n,
                                     long long gran, void* totals,
                                     void* stream) {
  const long long n_gran = (n + gran - 1) / gran;
  if (n_gran <= 0) return (int)cudaGetLastError();
  const long long grid = n_gran < 132LL * 32 ? n_gran : 132LL * 32;
  granule_totals_kernel<<<(unsigned)grid, asgart::kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const int*)lane_lo, (const int*)lane_hi, (const uint8_t*)lane_mask, n,
      gran, n_gran, (long long*)totals);
  return (int)cudaGetLastError();
}

// srcs: int64 [n_src] device pointers of int32 buffers; src_off: int64
// [n_src + 1] their offsets in the concatenation (src_off[0] == 0); idx:
// int64 [n], each in [0, src_off[n_src]); out: int32 [n].
ASGART_API int asgart_gather_flat(const void* srcs, const void* src_off,
                                  int n_src, const void* idx, long long n,
                                  void* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  gather_flat_kernel<<<asgart::grid_for(n), asgart::kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const long long*)srcs, (const long long*)src_off, n_src,
      (const long long*)idx, n, (int*)out);
  return (int)cudaGetLastError();
}
