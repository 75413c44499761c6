// KQ equal_range, KR gather_ranges and KS pack_probe_planes: the seed
// lookups of SearchEngine(engine="cuda") (asgart_tpu_torch/seed.py).
//
// Replaces (JAX reference, asgart_tpu/):
//   KQ  seed.py:73 equal_range: per probe, the rows [lo, hi) of a sorted key
//       array equal to it, from its prefix bucket's two bounds (:89-95; the
//       whole array without buckets) and a binary search of at most `steps`
//       halvings on each side (:97-117). The JAX program holds each key as
//       two int32 planes of 30 bits (device x64 was off); here a key is one
//       int64 word, whose order is the planes' lexicographic order, and the
//       bucket prefix is the word shifted by the plane shift plus 30.
//   KR  seed.py:125 _gather_range_rows (the rows of the [n, 2] int32 table
//       at x) and :120 _gather_tables (two [n] int32 tables at x): one
//       kernel over two int32 sources with one stride (2 for the rows' two
//       columns, 1 for two tables), written out as int64.
//   KS  seed.py:47 pack_probe_planes: the k codes at each position folded
//       3 bits at a time into the (hi, lo) int32 planes, hi holding
//       max(k - 10, 0) codes (int32 arithmetic, wrapping as XLA's does).
//
// KQ: one thread per probe (grid-stride): the probe, its bucket's bounds,
//   then both bounds from one descent: the lower bound by bisection of
//   [lo0, hi0); the key at the lower bound is the last one the descent
//   read at or above the probe, so where it differs from the probe (or
//   the bucket is passed) the upper bound is the lower one, with no
//   further read; else a gallop forward from it (asgart::run_end: rows
//   +1, +2, +4, ... in the sector where the descent ended, then a
//   bisection of the last gap). This equals the JAX result whenever both
//   JAX loops converge, i.e. when the bucket's width hi0 - lo0 is below
//   2^steps, which the pipeline's steps (the widest bucket's halvings)
//   always gives. A probe whose bucket is wider runs the JAX loop's two
//   searches, halving for halving, so any `steps`, also one too small to
//   converge, gives the JAX result. One probe a thread ran as fast on the
//   H100 as 2 and faster than 4, each thread issuing its probes' reads
//   before any comparison (PERF.md): at 6.4 M probes the threads already
//   keep enough reads in flight.
//   The counting instance (kCount, a non-null `counts`) adds the keys each
//   thread read and the probes that took the JAX loop to counts[0] and
//   counts[1], one atomic add each a thread: the bound's data-dependent
//   bytes, read from the kernel itself.
//   A probe that is negative, whose prefix lies past the bucket table, or
//   whose bucket bounds do not satisfy 0 <= lo0 <= hi0 <= n reads no key
//   and sets the error flag, which the entry point zeroes on the stream
//   before the launch and the wrapper reads after it.
//   Bound on the H100: memory, 8 B of probe, 8 B of bucket bounds and 16 B
//   of output per probe, and 8 B per key read; each read of a descent is
//   a dependent read of one random row (neighbouring probes are unrelated
//   k-mers), so latency, not the bytes, sets the time.
// KR: each thread takes 2 indices (a block's width apart, so every load
//   and store of a warp is coalesced) and issues both row reads before any
//   store (2, 4 and 8 indices a thread ran alike on the H100: the reads
//   stream the table's span, see below). A row is one 8-byte load when the
//   sources are the two columns of an 8-byte aligned [n, 2] table (hi_src
//   == lo_src + 1, stride 2), else two 4-byte loads. An index outside
//   [0, n), negative ones included, reads nothing and sets the error flag,
//   which the entry point zeroes on the stream before the launch and the
//   wrapper reads after it (the JAX gathers clamp instead).
//   Bound on the H100: memory, 8 B of index, 8 B of table and 16 B of
//   output per index. A chunk's probes lie k/2 text positions apart, so
//   its rows lie 80 B apart in the [n, 2] table and the row reads fetch
//   most of the table's span between the first and the last probe.
// KS: one thread per position: k bytes of codes (neighbouring positions
//   read overlapping bytes, served by L1), 8 B of position and 8 B of
//   output. Memory bound.
#include "common.cuh"

namespace {

// The JAX loop's search (asgart_tpu/seed.py:97-117): the first row of
// keys[lo, hi) whose key is above (right) or at least (left) the probe p,
// after at most `steps` halvings; adds its key reads to `reads`.
__device__ __forceinline__ long long jax_search(
    const long long* __restrict__ keys, long long lo, long long hi,
    long long p, int steps, bool right, unsigned long long& reads) {
  for (int s = 0; s < steps && lo < hi; ++s) {
    const long long mid = (lo + hi) >> 1;
    const long long key = __ldg(keys + mid);
    ++reads;
    if (right ? key <= p : key < p) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <bool kCount>
__global__ void equal_range_kernel(const long long* __restrict__ keys,
                                   long long n,
                                   const int* __restrict__ bucket_starts,
                                   long long n_starts, int key_shift,
                                   const long long* __restrict__ probes,
                                   long long b, int steps,
                                   long long* __restrict__ lo_out,
                                   long long* __restrict__ hi_out,
                                   int* __restrict__ bad,
                                   unsigned long long* __restrict__ counts) {
  bool outside = false;
  unsigned long long reads = 0, jax_loop = 0;  // used by kCount alone
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < b; t += (long long)gridDim.x * blockDim.x) {
    const long long p = probes[t];
    long long lo = 0, hi = n;
    if (key_shift >= 0) {
      const long long pre = p >> key_shift;
      if (p < 0 || pre > n_starts - 2) {
        outside = true;
        continue;
      }
      lo = __ldg(bucket_starts + pre);
      hi = __ldg(bucket_starts + pre + 1);
      if (!(0 <= lo && lo <= hi && hi <= n)) {
        outside = true;
        continue;
      }
    }
    const long long top = hi;
    if (steps < 63 && hi - lo >= (1LL << steps)) {  // a JAX loop stops short
      lo_out[t] = jax_search(keys, lo, top, p, steps, false, reads);
      hi_out[t] = jax_search(keys, lo, top, p, steps, true, reads);
      ++jax_loop;
      continue;
    }
    long long key_hi = 0;  // keys[hi] once hi < top
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      const long long key = __ldg(keys + mid);
      ++reads;
      if (key < p) {
        lo = mid + 1;
      } else {
        hi = mid;
        key_hi = key;
      }
    }
    lo_out[t] = lo;
    hi_out[t] = lo < top && key_hi == p
        ? asgart::run_end(lo, top, [&](long long r) {
            ++reads;
            return __ldg(keys + r) == p;
          })
        : lo;
  }
  if (outside) *bad = 1;
  if (kCount) {
    atomicAdd(counts, reads);
    atomicAdd(counts + 1, jax_loop);
  }
}

constexpr int kRangesPerThread = 2;

template <bool kRows>
__global__ void gather_ranges_kernel(const int* __restrict__ lo_src,
                                     const int* __restrict__ hi_src,
                                     long long stride, long long n,
                                     const long long* __restrict__ x,
                                     long long b,
                                     long long* __restrict__ lo_out,
                                     long long* __restrict__ hi_out,
                                     int* __restrict__ bad) {
  constexpr int V = kRangesPerThread;
  const long long tile = (long long)blockDim.x * V;
  bool outside = false;
  for (long long t0 = blockIdx.x * tile + threadIdx.x; t0 < b;
       t0 += (long long)gridDim.x * tile) {
    long long i[V];
    bool ok[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const long long t = t0 + (long long)j * blockDim.x;
      i[j] = t < b ? x[t] : 0;
      ok[j] = t < b && (unsigned long long)i[j] < (unsigned long long)n;
      outside |= t < b && !ok[j];
    }
    int lo[V], hi[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (!ok[j]) continue;
      if (kRows) {
        const int2 r = __ldg(reinterpret_cast<const int2*>(lo_src) + i[j]);
        lo[j] = r.x;
        hi[j] = r.y;
      } else {
        lo[j] = __ldg(lo_src + i[j] * stride);
        hi[j] = __ldg(hi_src + i[j] * stride);
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const long long t = t0 + (long long)j * blockDim.x;
      if (!ok[j]) continue;
      lo_out[t] = lo[j];
      hi_out[t] = hi[j];
    }
  }
  if (outside) *bad = 1;
}

__global__ void pack_probe_planes_kernel(const uint8_t* __restrict__ codes,
                                         const long long* __restrict__ pos,
                                         long long b, int k,
                                         int* __restrict__ hi_out,
                                         int* __restrict__ lo_out) {
  const int n_hi = k > 10 ? k - 10 : 0;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < b; t += (long long)gridDim.x * blockDim.x) {
    const uint8_t* c = codes + pos[t];
    unsigned hi = 0, lo = 0;  // unsigned: the shifts wrap as int32's do
    for (int j = 0; j < n_hi; ++j) hi = (hi << 3) | c[j];
    for (int j = n_hi; j < k; ++j) lo = (lo << 3) | c[j];
    hi_out[t] = (int)hi;
    lo_out[t] = (int)lo;
  }
}

}  // namespace

// keys: int64 [n] sorted; bucket_starts: int32 [n_starts], read only
// when key_shift >= 0 (the bucket of a probe p is p >> key_shift); probes:
// int64 [b]; steps in [0, 63]; lo, hi: int64 [b]; bad: int32 [1], set to 1
// when a probe's bucket or its bounds lie outside their arrays (zeroed
// here first); counts: null, or int64 [2] that the counting instance adds
// its key reads and its JAX-loop probes to (not zeroed here).
ASGART_API int asgart_equal_range(const void* keys, long long n,
                                  const void* bucket_starts,
                                  long long n_starts, int key_shift,
                                  const void* probes, long long b, int steps,
                                  void* lo, void* hi, void* bad,
                                  void* counts, void* stream) {
  if (b <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t rc = cudaMemsetAsync(bad, 0, sizeof(int), s);
  if (rc != cudaSuccess) return (int)rc;
  auto kernel = counts ? equal_range_kernel<true> : equal_range_kernel<false>;
  kernel<<<asgart::grid_for(b), asgart::kThreads, 0, s>>>(
      (const long long*)keys, n, (const int*)bucket_starts, n_starts,
      key_shift, (const long long*)probes, b, steps, (long long*)lo,
      (long long*)hi, (int*)bad, (unsigned long long*)counts);
  return (int)cudaGetLastError();
}

// lo_src, hi_src: int32 sources of n rows read at x[t] * stride; x: int64
// [b]; lo, hi: int64 [b]; bad: int32 [1], set to 1 when an index lies
// outside [0, n) (zeroed here first).
ASGART_API int asgart_gather_ranges(const void* lo_src, const void* hi_src,
                                    long long stride, long long n,
                                    const void* x, long long b, void* lo,
                                    void* hi, void* bad, void* stream) {
  if (b <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t rc = cudaMemsetAsync(bad, 0, sizeof(int), s);
  if (rc != cudaSuccess) return (int)rc;
  const bool rows = stride == 2 &&
                    (const int*)hi_src == (const int*)lo_src + 1 &&
                    (reinterpret_cast<uintptr_t>(lo_src) & 7) == 0;
  const long long per_block = (long long)asgart::kThreads * kRangesPerThread;
  long long grid = (b + per_block - 1) / per_block;
  if (grid > 132LL * 32) grid = 132LL * 32;
  if (rows) {
    gather_ranges_kernel<true><<<(unsigned)grid, asgart::kThreads, 0, s>>>(
        (const int*)lo_src, (const int*)hi_src, stride, n,
        (const long long*)x, b, (long long*)lo, (long long*)hi, (int*)bad);
  } else {
    gather_ranges_kernel<false><<<(unsigned)grid, asgart::kThreads, 0, s>>>(
        (const int*)lo_src, (const int*)hi_src, stride, n,
        (const long long*)x, b, (long long*)lo, (long long*)hi, (int*)bad);
  }
  return (int)cudaGetLastError();
}

// codes: uint8, at least pos[t] + k entries; pos: int64 [b]; hi, lo: int32
// [b].
ASGART_API int asgart_pack_probe_planes(const void* codes, const void* pos,
                                        long long b, int k, void* hi,
                                        void* lo, void* stream) {
  if (b <= 0) return (int)cudaGetLastError();
  pack_probe_planes_kernel<<<asgart::grid_for(b), asgart::kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const long long*)pos, b, k, (int*)hi,
      (int*)lo);
  return (int)cudaGetLastError();
}
