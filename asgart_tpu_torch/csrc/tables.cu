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
// The planes pos_lo and pos_hi are decimated as the JAX package keeps them
// (device_index.py:441 _dec_of): position x at (x % step) * C + x / step,
// C = ceil(n / step), step = k / 2, with no padding past C. The probes of a
// chunk share x % step, so lane j of a chunk reads entry base + j of each
// plane, base = the decimated index of its probe j = 0: a chunk's lanes
// read one contiguous run of each plane.
//
// KM: lane l of chunk c (its lanes [off[c], off[c + 1])) probes j = l -
//   off[c]; it is live when j < live[c] (the wrapper folds the lane bound
//   j * step < len - k - step and x < n into live[c]) and pos_lo's entry
//   is >= 0 (the probe's first symbol is not N); live lanes get
//   [pos_lo & 0x7FFFFFFF, pos_hi), the rest (0, 0). Per-chunk totals are
//   the exact int64 sums of (hi - lo) over the live lanes.
//   Bound on the H100: memory. Each lane reads 8 B, in order, and writes
//   9 B in order. The chunk table (off, base, live) goes in the launch by
//   value (a __grid_constant__ table, as KC's lane offsets) up to kOffCap
//   chunks, else the wrapper copies it to the card from pinned memory, so
//   the wrapper never waits for the card. A thread takes kLanes
//   consecutive lanes: lane 0 of a warp finds the warp's first chunk once
//   (a binary search), each thread walks on from it; both planes' loads go
//   out together, then the masks; lane_lo and lane_hi leave in 16-byte
//   stores, the mask in one 4-byte store. The totals reduce a warp's lanes
//   with shuffles when the warp lies inside one chunk, with atomics only at
//   chunk edges (as KC and KH do).
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
// chunks whose table goes in the launch (kernels/tables.py KM_OFF_CAPACITY)
constexpr int kOffCap = 256;
constexpr int kLanes = 4;  // lanes a thread

// The chunk table by value: each chunk's first lane (then the total), the
// decimated index of its probe j = 0, and its live lanes.
struct ChunkTable {
  int off[kOffCap + 1];
  unsigned base[kOffCap];
  int live[kOffCap];
};

// The chunk whose lanes [off[c], off[c + 1]) hold `lane`.
__device__ __forceinline__ int chunk_of(const int* off, int n_chunks,
                                        long long lane) {
  int lo = 0, hi = n_chunks - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (off[mid] <= lane) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ void table_ranges_body(
    const int* __restrict__ pos_lo, const int* __restrict__ pos_hi,
    const int* off, const unsigned* base, const int* live, int n_chunks,
    long long total, int* __restrict__ lane_lo, int* __restrict__ lane_hi,
    uint8_t* __restrict__ lane_mask, unsigned long long* __restrict__ totals) {
  const int ln = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x * kLanes;
  // w0, the warp's first lane, and so the loop bound are uniform over the
  // warp, which stays converged for the shuffles
  for (long long w0 = ((long long)blockIdx.x * blockDim.x +
                       (threadIdx.x & ~31)) * kLanes;
       w0 < total; w0 += stride) {
    int c0 = 0;
    if (ln == 0) c0 = chunk_of(off, n_chunks, w0);
    c0 = __shfl_sync(kFull, c0, 0);
    const long long l0 = w0 + (long long)ln * kLanes;
    int ch[kLanes];
    long long at[kLanes];
    bool ok[kLanes];
    int c = c0;
#pragma unroll
    for (int i = 0; i < kLanes; ++i) {
      const long long l = l0 + i;
      ch[i] = -1;
      ok[i] = false;
      at[i] = 0;
      if (l < total) {
        while (c + 1 < n_chunks && off[c + 1] <= l) ++c;
        const long long j = l - off[c];
        ch[i] = c;
        ok[i] = j < live[c];
        at[i] = (long long)base[c] + j;
      }
    }
    int lo[kLanes], hi[kLanes];
#pragma unroll
    for (int i = 0; i < kLanes; ++i) {
      lo[i] = ok[i] ? __ldg(pos_lo + at[i]) : -1;
      hi[i] = ok[i] ? __ldg(pos_hi + at[i]) : 0;
    }
    unsigned long long sum = 0;
    bool one_chunk = true;
    uint8_t m[kLanes];
#pragma unroll
    for (int i = 0; i < kLanes; ++i) {
      m[i] = lo[i] >= 0;
      lo[i] = m[i] ? lo[i] & 0x7FFFFFFF : 0;
      hi[i] = m[i] ? hi[i] : 0;
      sum += (unsigned long long)(hi[i] - lo[i]);
      one_chunk &= ch[i] < 0 || ch[i] == c0;
    }
    if (l0 + kLanes <= total) {
      *reinterpret_cast<int4*>(lane_lo + l0) =
          make_int4(lo[0], lo[1], lo[2], lo[3]);
      *reinterpret_cast<int4*>(lane_hi + l0) =
          make_int4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uchar4*>(lane_mask + l0) =
          make_uchar4(m[0], m[1], m[2], m[3]);
    } else {
#pragma unroll
      for (int i = 0; i < kLanes; ++i) {
        if (l0 + i < total) {
          lane_lo[l0 + i] = lo[i];
          lane_hi[l0 + i] = hi[i];
          lane_mask[l0 + i] = m[i];
        }
      }
    }
    if (__all_sync(kFull, one_chunk)) {
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_down_sync(kFull, sum, o);
      if (ln == 0 && sum) atomicAdd(totals + c0, sum);
    } else {
#pragma unroll
      for (int i = 0; i < kLanes; ++i) {
        if (ch[i] >= 0 && hi[i] > lo[i]) {
          atomicAdd(totals + ch[i], (unsigned long long)(hi[i] - lo[i]));
        }
      }
    }
  }
}

__global__ void table_ranges_kernel(const int* __restrict__ pos_lo,
                                    const int* __restrict__ pos_hi,
                                    const __grid_constant__ ChunkTable t,
                                    int n_chunks, long long total,
                                    int* __restrict__ lane_lo,
                                    int* __restrict__ lane_hi,
                                    uint8_t* __restrict__ lane_mask,
                                    unsigned long long* __restrict__ totals) {
  table_ranges_body(pos_lo, pos_hi, t.off, t.base, t.live, n_chunks, total,
                    lane_lo, lane_hi, lane_mask, totals);
}

// the chunk table on the card: off [n_chunks + 1], base, live [n_chunks]
__global__ void table_ranges_dev_kernel(const int* __restrict__ pos_lo,
                                        const int* __restrict__ pos_hi,
                                        const int* __restrict__ table,
                                        int n_chunks, long long total,
                                        int* __restrict__ lane_lo,
                                        int* __restrict__ lane_hi,
                                        uint8_t* __restrict__ lane_mask,
                                        unsigned long long* __restrict__
                                            totals) {
  table_ranges_body(
      pos_lo, pos_hi, table, (const unsigned*)table + n_chunks + 1,
      table + 2 * n_chunks + 1, n_chunks, total, lane_lo, lane_hi, lane_mask,
      totals);
}

}  // namespace

// table: int32 [3 n_chunks + 1], off [n_chunks + 1], base (uint32 bits)
// and live [n_chunks]; on the host (copied into the launch) when cap is
// kOffCap, on the card when cap is 0. totals: int64 [n_chunks], zeroed
// here. total >= 1 lanes, below 2^31; lane_lo and lane_hi 16-byte
// aligned, lane_mask 4-byte aligned (for the vector stores).
ASGART_API int asgart_table_ranges(const void* pos_lo, const void* pos_hi,
                                   const void* table, int n_chunks, int cap,
                                   long long total, void* lane_lo,
                                   void* lane_hi, void* lane_mask,
                                   void* totals, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((cap != kOffCap && cap != 0) || (cap && n_chunks > kOffCap) ||
      n_chunks < 1 || total < 1 || total >= (1LL << 31) ||
      (((uintptr_t)lane_lo | (uintptr_t)lane_hi) & 15) != 0 ||
      ((uintptr_t)lane_mask & 3) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t rc = cudaMemsetAsync(
      totals, 0, sizeof(unsigned long long) * n_chunks, s);
  if (rc != cudaSuccess) return (int)rc;
  const unsigned grid = asgart::grid_for((total + kLanes - 1) / kLanes);
  const int* lo = (const int*)pos_lo;
  const int* hi = (const int*)pos_hi;
  int* llo = (int*)lane_lo;
  int* lhi = (int*)lane_hi;
  uint8_t* lm = (uint8_t*)lane_mask;
  unsigned long long* tot = (unsigned long long*)totals;
  if (cap) {
    ChunkTable t{};
    const int* host = (const int*)table;
    for (int c = 0; c <= n_chunks; ++c) t.off[c] = host[c];
    for (int c = 0; c < n_chunks; ++c) {
      t.base[c] = (unsigned)host[n_chunks + 1 + c];
      t.live[c] = host[2 * n_chunks + 1 + c];
    }
    table_ranges_kernel<<<grid, asgart::kThreads, 0, s>>>(
        lo, hi, t, n_chunks, total, llo, lhi, lm, tot);
  } else {
    table_ranges_dev_kernel<<<grid, asgart::kThreads, 0, s>>>(
        lo, hi, (const int*)table, n_chunks, total, llo, lhi, lm, tot);
  }
  return (int)cudaGetLastError();
}
