// KM table_ranges: the table engine's per-lane reads of its position
// tables (KJ invert_tables, which builds them, is the table form of KC's
// partitioned scatter: csrc/invert.cu).
//
// Replaces (JAX reference, asgart_tpu/):
//   KM  the front of device_engine.py:202 _scan_chunk, as
//       _scan_chunks_group (:375) maps it over a chunk group: the probe
//       positions x = _probe_x0 (:130) + j * step, the table reads
//       _dec_read (:116), the N-probe mask from pos_lo's sign bit and the
//       lane bound; plus the exact raw totals that the cap pre-passes
//       _raw_total (:146) and _raw_totals_batch (:187) bound in float32.
//
// KM: lane l of chunk c (its lanes [lane_off[c], lane_off[c + 1])) probes
//   j = l - lane_off[c] at x = x0[c] + j * step; it is live when
//   j * step < len - k - step, x < n and pos_lo[x] >= 0 (the probe's first
//   symbol is not N); live lanes get [pos_lo[x] & 0x7FFFFFFF, pos_hi[x]),
//   the rest (0, 0). Per-chunk totals are the exact int64 sums of
//   (hi - lo) over the live lanes.
//   Bound on the H100: memory. Each lane reads 8 B at a stride of step
//   positions (one 32-byte sector per table read for step >= 8) and writes
//   9 B in order. One thread per lane; the totals reduce a warp's lanes
//   with shuffles when the warp lies inside one chunk, with atomics only at
//   chunk edges (as KC and KH do).
#include "common.cuh"

namespace {

__global__ void table_ranges_kernel(const int* __restrict__ pos_lo,
                                    const int* __restrict__ pos_hi,
                                    long long n,
                                    const long long* __restrict__ lane_off,
                                    const long long* __restrict__ x0cl,
                                    int n_chunks, int k,
                                    int* __restrict__ lane_lo,
                                    int* __restrict__ lane_hi,
                                    uint8_t* __restrict__ lane_mask,
                                    unsigned long long* __restrict__ totals) {
  const unsigned kFull = 0xFFFFFFFFu;
  const int step = k / 2;
  const long long n_live = lane_off[n_chunks];
  // the loop bound is uniform over the block, so every warp stays
  // converged for the shuffles
  for (long long base = (long long)blockIdx.x * blockDim.x; base < n_live;
       base += (long long)gridDim.x * blockDim.x) {
    const long long lane = base + threadIdx.x;
    int c = -1;
    unsigned long long v = 0;
    if (lane < n_live) {
      c = asgart::chunk_of(lane_off, n_chunks, lane);
      const long long j = lane - lane_off[c];
      const long long x = x0cl[2 * c] + j * step;
      const long long cl = x0cl[2 * c + 1];
      int lo = 0, hi = 0;
      bool live = j * step < cl - k - step && x < n;
      if (live) {
        const int raw = __ldg(pos_lo + x);
        live = raw >= 0;
        if (live) {
          lo = raw & 0x7FFFFFFF;
          hi = __ldg(pos_hi + x);
          v = (unsigned long long)(hi - lo);
        }
      }
      lane_lo[lane] = lo;
      lane_hi[lane] = hi;
      lane_mask[lane] = live;
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

// x0cl [n_chunks, 2]: each chunk's x0 (the table position of its probe
// j = 0) and length; lane_off [n_chunks + 1]
ASGART_API int asgart_table_ranges(const void* pos_lo, const void* pos_hi,
                                   long long n, const void* lane_off,
                                   const void* x0cl, int n_chunks, int k,
                                   long long total, void* lane_lo,
                                   void* lane_hi, void* lane_mask,
                                   void* totals, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t rc = cudaMemsetAsync(
      totals, 0, sizeof(unsigned long long) * (n_chunks > 0 ? n_chunks : 1),
      s);
  if (rc != cudaSuccess || total == 0) return (int)rc;
  table_ranges_kernel<<<asgart::grid_for(total), asgart::kThreads, 0, s>>>(
      (const int*)pos_lo, (const int*)pos_hi, n, (const long long*)lane_off,
      (const long long*)x0cl, n_chunks, k, (int*)lane_lo, (int*)lane_hi,
      (uint8_t*)lane_mask, (unsigned long long*)totals);
  return (int)cudaGetLastError();
}
