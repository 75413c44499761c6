// KC invert_fused: slot-indexed run bounds -> position-indexed rank and
// lane-ordered probe windows, plus per-chunk raw-match totals; and its
// table form, KJ invert_tables: the table engine's position tables.
//
// Replaces (JAX reference, asgart_tpu/):
//   KC  device_index.py:1519 _invert_fused (with _assemble_dec :447,
//       _dec_of :441, _fused_lane_totals :1545), and with no lanes :631
//       _invert_perm (the merge-join window's rank).
//   KJ  device_index.py:467 _invert_tables_dec (with _dec_of :441 and
//       _assemble_dec :447): pos_lo[sa] = run_lo (the N-probe flag of the
//       position, set by KB, in its sign bit), pos_hi[sa] = run_hi and the
//       doubling loop's rank seed rank[sa] = run_lo & 0x7FFFFFFF.
//
// Every row of the sorted fused index has a unique destination: a direct
// row (sa < W) writes rank[sa] = run_lo, a probe row writes
// lane_lo/hi[sa - W] = run_lo/hi. The JAX package did this with one more
// full sort (scatters were slow on the TPU) into a decimated layout; here
// it is a permutation scatter, and rank stays in plain position layout.
// The table form is the case W = 0 (every row a "probe" row, its position
// the lane) with a third output, rank, written from the same tile as
// pos_lo; it takes no lane mask and computes no totals. Its pos_lo and
// pos_hi keep the JAX tables' decimated layout (position d at (d % step)
// * C + d / step, C = ceil(n / step), step = k / 2, unpadded), in which
// KM reads a chunk's probes as one contiguous run (csrc/tables.cu): the
// fill writes a tile's positions residue by residue, each a contiguous
// run of ~2^kTile / step entries.
// The totals are exact int64 sums of (lane_hi - lane_lo) over masked
// lanes per chunk (the JAX float32 sums are exact only below 2^24).
//
// Bound on the H100: memory. A scatter that stores each row where it lands
// makes one 4-8 B store to a random address: into an output larger than
// the 50 MB L2 a DRAM sector a row at the random-access rate, and even
// into an L2-sized output ~20-30 ps a row (PERF.md §6: 32 M rows into 128
// MB take 2.38 ms with index_put_, 8 M rows into 32 MB 0.21 ms, a
// coalesced copy of 128 MB 0.09 ms). Design: a partitioned scatter whose
// random stores all land in shared memory.
//   partition (twice): sa is a permutation, so the rows bound for any
//     aligned range of 2^s destinations number exactly min(2^s, M - start):
//     a bucket's region of the scratch starts at its first destination, and
//     no histogram or scan is needed. A block takes kPartRows rows in
//     order, counts them per bucket in shared memory (warp-aggregated:
//     one atomic per bucket a warp), claims each bucket's run in its region
//     with one atomicAdd on the bucket's cursor, sorts its rows by bucket in
//     shared memory and writes each run whole: dest and run_lo as two int32
//     planes, and a probe row's run_hi in a third that starts at the bucket
//     holding W. Coalesced stores, the frontiers few enough for the L2. The
//     first pass sorts the rows into buckets of 2^kCoarse destinations (at
//     most 1024); the second sorts each bucket's region, 512 blocks of it,
//     into its 2^(kCoarse - kTile) tiles of 2^kTile destinations.
//   fill: one block a tile reads the tile's region in order, stores each
//     row's values at its destination's place in shared memory, then
//     writes the tile out whole (coalesced): rank for destinations below W,
//     lane_lo / lane_hi for the rest (a tile that straddles W splits), and
//     in the table form the rank plane beside lane_lo.
//     Every destination is written once (a permutation), so the result is
//     deterministic although the order within a region is not.
// 44 B a row of DRAM traffic (68 B for a probe row, 72 B in the table
// form), all of it in order, against the bound's 12 B (21 B; 24 B).
// The totals pass streams 9 B per lane: it
// reduces a warp's lanes with shuffles when the warp lies inside one chunk
// (the common case: chunks are contiguous lane ranges) and falls back to
// per-lane atomics at chunk edges. The chunks' lane offsets come in the
// launch itself (a __grid_constant__ table of kOffCap + 1 words) up to
// kOffCap chunks, else from device memory.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kPartThreads = 512;
// rows a thread of a partition pass, all loaded before the first is
// placed, and its blocks an SM (at most 64 registers a thread): on a
// random permutation fewer rows a thread with more blocks an SM, or 8
// rows in 68 registers (one block an SM), ran slower
constexpr int kPartPer = 8;
constexpr int kPartBlocks = 2;
constexpr int kPartRows = kPartThreads * kPartPer;
// log2 of a bucket's and a tile's destinations (kernels/invert.py
// KC_COARSE, KC_TILE): M < 2^31 makes at most 1024 buckets, scanned two a
// thread; a bucket's region is 512 blocks of rows exactly, so a block of
// the second pass reads one bucket's rows; a tile's run_lo and run_hi take
// 64 KB of shared memory
constexpr int kCoarse = 21;
constexpr int kTile = 13;
constexpr int kMaxBuckets = 2 * kPartThreads;
constexpr int kFillThreads = 512;
// chunks whose offsets go in the launch; kernels/invert.py KC_OFF_CAPACITY
constexpr int kOffCap = 256;

// Exclusive prefix sum of v over the block (kT threads); *total gets the
// block's sum. ws: kT / 32 ints of shared memory.
template <int kT>
__device__ __forceinline__ int block_scan(int v, int* ws, int* total) {
  const int ln = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (ln >= o) x += y;
  }
  if (ln == 31) ws[w] = x;
  __syncthreads();
  if (w == 0) {
    int s = ln < kT / 32 ? ws[ln] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, s, o);
      if (ln >= o) s += y;
    }
    if (ln < kT / 32) ws[ln] = s;
  }
  __syncthreads();
  const int r = (w ? ws[w - 1] : 0) + x - v;
  *total = ws[kT / 32 - 1];
  __syncthreads();
  return r;
}

// The scratch planes of one pass: dest and run_lo [M], run_hi for the
// slots from hi_first (null: no probe rows).
struct Planes {
  const int* dest;
  const int* lo;
  const int* hi;
  long long hi_first;
};
struct OutPlanes {
  int* dest;
  int* lo;
  int* hi;
  long long hi_first;
};

// One partition pass over M rows (in: sa and the run bounds, or the first
// pass's planes) into buckets of 2^shift destinations (out). Bucket g's
// region starts at g << shift; cursor[g] counts its rows claimed so far.
// A block's rows fall in buckets [base, base + n_local): base is 0 in the
// first pass; in the second, the first tile of the block's bucket of the
// first pass (row0 >> kCoarse). Dynamic shared memory: hist, boff, gbase
// [n_local], then the staged rows' planes [kPartRows] each.
__global__ void __launch_bounds__(kPartThreads, kPartBlocks)
invert_partition_kernel(Planes in, long long M, long long W, int shift,
                        int second, int n_local,
                        unsigned* __restrict__ cursor, OutPlanes out) {
  extern __shared__ int smem[];
  __shared__ int ws[kPartThreads / 32];
  int* hist = smem;
  int* boff = hist + n_local;
  int* gbase = boff + n_local;
  int* st_d = gbase + n_local;
  int* st_lo = st_d + kPartRows;
  int* st_hi = st_lo + kPartRows;
  const long long row0 = (long long)blockIdx.x * kPartRows;
  const long long base =
      second ? (row0 >> kCoarse) << (kCoarse - shift) : 0;
  const int ln = threadIdx.x & 31;
  const bool lanes = out.hi != nullptr;
  for (int j = threadIdx.x; j < n_local; j += kPartThreads) hist[j] = 0;
  __syncthreads();
  // the rows' loads first, all in flight together
  int d[kPartPer], rk[kPartPer], lo[kPartPer], hi[kPartPer];
#pragma unroll
  for (int j = 0; j < kPartPer; ++j) {
    const long long i = row0 + threadIdx.x + j * kPartThreads;
    d[j] = i < M ? in.dest[i] : -1;
    lo[j] = i < M ? in.lo[i] : 0;
    hi[j] = lanes && i < M && i >= in.hi_first ? in.hi[i - in.hi_first] : 0;
  }
#pragma unroll
  for (int j = 0; j < kPartPer; ++j) {
    int b = -1;
    if (d[j] >= 0 && d[j] < M) {  // always, for a permutation of [0, M)
      b = (int)((d[j] >> shift) - base);
      if (b >= n_local) b = -1;  // never, for a permutation
    }
    if (b < 0) d[j] = -1;
    // one shared atomic per bucket a warp: the lanes that share a bucket
    // take consecutive ranks after its leader's
    const unsigned same = __match_any_sync(kFull, b);
    const int leader = __ffs(same) - 1;
    int r = 0;
    if (b >= 0 && ln == leader) r = atomicAdd(hist + b, __popc(same));
    r = __shfl_sync(kFull, r, leader);
    rk[j] = r + __popc(same & ((1u << ln) - 1u));
  }
  __syncthreads();
  int staged;
  {
    const int b = 2 * threadIdx.x;
    const int h0 = b < n_local ? hist[b] : 0;
    const int h1 = b + 1 < n_local ? hist[b + 1] : 0;
    const int ex = block_scan<kPartThreads>(h0 + h1, ws, &staged);
    if (b < n_local) boff[b] = ex;
    if (b + 1 < n_local) boff[b + 1] = ex + h0;
  }
  for (int j = threadIdx.x; j < n_local; j += kPartThreads) {
    gbase[j] = hist[j] ? (int)atomicAdd(cursor + base + j,
                                        (unsigned)hist[j]) : 0;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kPartPer; ++j) {
    if (d[j] >= 0) {
      const int p = boff[(d[j] >> shift) - base] + rk[j];
      st_d[p] = d[j];
      st_lo[p] = lo[j];
      if (lanes) st_hi[p] = hi[j];
    }
  }
  __syncthreads();
  const long long span = 1LL << shift;
  for (int p = threadIdx.x; p < staged; p += kPartThreads) {
    const int dd = st_d[p];
    const long long g = dd >> shift;
    const int b = (int)(g - base);
    const long long at = (long long)gbase[b] + (p - boff[b]);
    const long long start = g << shift;
    if (at < (M - start < span ? M - start : span)) {  // always (as above)
      const long long slot = start + at;
      out.dest[slot] = dd;
      out.lo[slot] = st_lo[p];
      if (lanes && dd >= W) out.hi[slot - out.hi_first] = st_hi[p];
    }
  }
}

// One block a tile of 2^kTile destinations: its region of the second
// pass's planes into shared memory, then out in order. The table form
// (lane_rank, its rank, not null; W = 0) writes rank in order and lane_lo
// and lane_hi decimated (position d at (d % step) * C + d / step): the
// tile's positions of one residue are one contiguous run there, so it
// writes them residue by residue, and the last tile zeroes each plane's
// slots past the M positions (one a residue at most).
__global__ void __launch_bounds__(kFillThreads)
invert_fill_kernel(Planes in, long long M, long long W,
                   int* __restrict__ rank, int* __restrict__ lane_lo,
                   int* __restrict__ lane_hi, int* __restrict__ lane_rank,
                   int step, long long C) {
  extern __shared__ int smem[];
  int* t_lo = smem;
  int* t_hi = smem + (1 << kTile);
  const long long start = (long long)blockIdx.x << kTile;
  const int n = (int)(M - start < (1 << kTile) ? M - start : (1 << kTile));
  const bool lanes = in.hi != nullptr && start + n > W;
  for (int p = threadIdx.x; p < n; p += kFillThreads) {
    const long long s = start + p;
    const int d = __ldcs(in.dest + s);
    const long long off = d - start;
    if (off < 0 || off >= n) continue;  // never, for a permutation
    t_lo[off] = __ldcs(in.lo + s);
    if (lanes && d >= W) t_hi[off] = __ldcs(in.hi + (s - in.hi_first));
  }
  __syncthreads();
  if (lane_rank) {
    for (int p = threadIdx.x; p < n; p += kFillThreads) {
      lane_rank[start + p] = t_lo[p] & 0x7FFFFFFF;
    }
    const int s0 = (int)(start % step);
    for (int r = 0; r < step; ++r) {
      const int q0 = (r - s0 + step) % step;  // its first offset here
      if (q0 >= n) continue;
      const int cnt = (n - 1 - q0) / step + 1;
      const long long out0 = r * C + (start + q0) / step;
      for (int m = threadIdx.x; m < cnt; m += kFillThreads) {
        lane_lo[out0 + m] = t_lo[q0 + m * step];
        lane_hi[out0 + m] = t_hi[q0 + m * step];
      }
    }
    if (start + n == M && threadIdx.x < step &&
        threadIdx.x + (C - 1) * step >= M) {
      lane_lo[threadIdx.x * C + C - 1] = 0;
      lane_hi[threadIdx.x * C + C - 1] = 0;
    }
    return;
  }
  for (int p = threadIdx.x; p < n; p += kFillThreads) {
    const long long d = start + p;
    if (d < W) {
      rank[d] = t_lo[p];
    } else {
      lane_lo[d - W] = t_lo[p];
      lane_hi[d - W] = t_hi[p];
    }
  }
}

// The chunks' lane offsets (n_chunks + 1 ascending int64) by value.
struct OffTable {
  long long off[kOffCap + 1];
};

__device__ __forceinline__ void lane_totals_body(
    const int* __restrict__ lane_lo, const int* __restrict__ lane_hi,
    const uint8_t* __restrict__ lane_mask, const long long* lane_off,
    int n_chunks, unsigned long long* __restrict__ totals) {
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
      if (lane_mask[lane]) v = (unsigned long long)(lane_hi[lane] -
                                                    lane_lo[lane]);
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

__global__ void lane_totals_kernel(const int* __restrict__ lane_lo,
                                   const int* __restrict__ lane_hi,
                                   const uint8_t* __restrict__ lane_mask,
                                   const __grid_constant__ OffTable t,
                                   int n_chunks,
                                   unsigned long long* __restrict__ totals) {
  lane_totals_body(lane_lo, lane_hi, lane_mask, t.off, n_chunks, totals);
}

__global__ void lane_totals_table_kernel(
    const int* __restrict__ lane_lo, const int* __restrict__ lane_hi,
    const uint8_t* __restrict__ lane_mask, const long long* lane_off,
    int n_chunks, unsigned long long* __restrict__ totals) {
  lane_totals_body(lane_lo, lane_hi, lane_mask, lane_off, n_chunks, totals);
}

// The partitioned scatter of M rows (W direct) into rank [W], lane_lo and
// lane_hi [M - W] and, in the table form (W = 0), lane_rank [M] (else
// null), lane_lo and lane_hi then decimated by step: scratch as in
// asgart_invert_fused.
cudaError_t scatter(const void* sa, const void* run_lo, const void* run_hi,
                    long long M, long long W, void* cursor, int n_coarse,
                    int n_tiles, void* d1, void* l1, void* h1,
                    long long h1_first, void* d2, void* l2, void* h2,
                    long long h2_first, void* rank, void* lane_lo,
                    void* lane_hi, void* lane_rank, int step,
                    cudaStream_t s) {
  if (M <= 0) return cudaSuccess;
  if (n_coarse != (M + (1LL << kCoarse) - 1) >> kCoarse ||
      n_tiles != (M + (1LL << kTile) - 1) >> kTile ||
      n_coarse > kMaxBuckets || step < 1 || step > kFillThreads) {
    return cudaErrorInvalidValue;
  }
  cudaError_t rc;
  const bool lanes = M > W;
  static bool attr = false;
  if (!attr) {
    rc = cudaFuncSetAttribute(invert_partition_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)(sizeof(int) * (3 * kMaxBuckets +
                                                   3 * kPartRows)));
    if (rc != cudaSuccess) return rc;
    rc = cudaFuncSetAttribute(invert_fill_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)(sizeof(int) << (kTile + 1)));
    if (rc != cudaSuccess) return rc;
    attr = true;
  }
  unsigned* cur = (unsigned*)cursor;
  rc = cudaMemsetAsync(cur, 0, sizeof(unsigned) * (n_coarse + n_tiles), s);
  if (rc != cudaSuccess) return rc;
  const unsigned blocks = (unsigned)((M + kPartRows - 1) / kPartRows);
  const size_t rows_smem = sizeof(int) * (2 + lanes) * (size_t)kPartRows;
  const Planes in1{(const int*)sa, (const int*)run_lo, (const int*)run_hi,
                   0};
  const OutPlanes out1{(int*)d1, (int*)l1, lanes ? (int*)h1 : nullptr,
                       h1_first};
  invert_partition_kernel<<<blocks, kPartThreads,
                            sizeof(int) * 3 * n_coarse + rows_smem, s>>>(
      in1, M, W, kCoarse, 0, n_coarse, cur, out1);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  const Planes in2{(const int*)d1, (const int*)l1, out1.hi, h1_first};
  const OutPlanes out2{(int*)d2, (int*)l2, lanes ? (int*)h2 : nullptr,
                       h2_first};
  const int per = 1 << (kCoarse - kTile);
  invert_partition_kernel<<<blocks, kPartThreads,
                            sizeof(int) * 3 * per + rows_smem, s>>>(
      in2, M, W, kTile, 1, per, cur + n_coarse, out2);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  const Planes in3{(const int*)d2, (const int*)l2, out2.hi, h2_first};
  invert_fill_kernel<<<(unsigned)n_tiles, kFillThreads,
                       sizeof(int) << (kTile + lanes), s>>>(
      in3, M, W, (int*)rank, (int*)lane_lo, (int*)lane_hi, (int*)lane_rank,
      step, (M + step - 1) / step);
  return cudaGetLastError();
}

}  // namespace

// lane_off: n_chunks + 1 int64 offsets, on the host when cap is kOffCap
// (copied into the launch), on the card when cap is 0. scratch: the
// cursors of the buckets (n_coarse) and of the tiles, then the two passes'
// planes at the offsets kernels/invert.py kc_plan gives (d1, l1, h1 and
// d2, l2, h2, each h from hi_first, the first slot of the bucket or tile
// that holds W; h null without probe rows).
ASGART_API int asgart_invert_fused(const void* sa, const void* run_lo,
                                   const void* run_hi, const void* lane_mask,
                                   long long M, long long W,
                                   const void* lane_off, int n_chunks,
                                   int cap, void* cursor, int n_coarse,
                                   int n_tiles, void* d1, void* l1, void* h1,
                                   long long h1_first, void* d2, void* l2,
                                   void* h2, long long h2_first, void* rank,
                                   void* lane_lo, void* lane_hi, void* totals,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((cap != kOffCap && cap != 0) || (cap && n_chunks > kOffCap)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t rc = scatter(sa, run_lo, run_hi, M, W, cursor, n_coarse,
                           n_tiles, d1, l1, h1, h1_first, d2, l2, h2,
                           h2_first, rank, lane_lo, lane_hi, nullptr, 1, s);
  if (rc != cudaSuccess) return (int)rc;
  if (n_chunks == 0) return (int)cudaSuccess;
  rc = cudaMemsetAsync(totals, 0, sizeof(unsigned long long) * n_chunks, s);
  if (rc != cudaSuccess) return (int)rc;
  const unsigned grid = asgart::grid_for(M - W);
  if (cap) {
    OffTable t{};
    const long long* host = (const long long*)lane_off;
    for (int c = 0; c <= n_chunks; ++c) t.off[c] = host[c];
    lane_totals_kernel<<<grid, asgart::kThreads, 0, s>>>(
        (const int*)lane_lo, (const int*)lane_hi, (const uint8_t*)lane_mask,
        t, n_chunks, (unsigned long long*)totals);
  } else {
    lane_totals_table_kernel<<<grid, asgart::kThreads, 0, s>>>(
        (const int*)lane_lo, (const int*)lane_hi, (const uint8_t*)lane_mask,
        (const long long*)lane_off, n_chunks, (unsigned long long*)totals);
  }
  return (int)cudaGetLastError();
}

// KJ, the table form: the scatter of n rows with W = 0 (scratch laid out
// by kc_plan(n, 0): every plane of n slots, h1_first = h2_first = 0);
// pos_lo and pos_hi int32 [step * C], decimated by step (C = ceil(n /
// step); 1: in order), rank int32 [n] in order.
ASGART_API int asgart_invert_tables(const void* sa, const void* run_lo,
                                    const void* run_hi, long long n,
                                    void* cursor, int n_coarse, int n_tiles,
                                    void* d1, void* l1, void* h1, void* d2,
                                    void* l2, void* h2, void* pos_lo,
                                    void* pos_hi, void* rank, int step,
                                    void* stream) {
  return (int)scatter(sa, run_lo, run_hi, n, 0, cursor, n_coarse, n_tiles,
                      d1, l1, h1, 0, d2, l2, h2, 0, nullptr, pos_lo, pos_hi,
                      rank, step, (cudaStream_t)stream);
}
