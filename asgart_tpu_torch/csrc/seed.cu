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
//   then the left and the right search. A search stops once its interval
//   is empty, where the JAX loop's lanes stop moving, so any `steps`, also
//   one too small to converge, gives the JAX result.
//   Bound on the H100: memory, 8 B of probe, 8 B of bucket bounds and 16 B
//   of output per probe, and 8 B per halving done; each halving is a
//   dependent read of one random row (neighbouring probes are unrelated
//   k-mers), so latency, not the bytes, sets the time of a simple kernel.
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

// The first row of keys[lo, hi) whose key is above (right) or at least
// (left) the probe p, after at most `steps` halvings.
__device__ __forceinline__ long long search(const long long* __restrict__ keys,
                                            long long lo, long long hi,
                                            long long p, int steps,
                                            bool right) {
  for (int s = 0; s < steps && lo < hi; ++s) {
    const long long mid = (lo + hi) >> 1;
    const long long key = keys[mid];
    if (right ? key <= p : key < p) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void equal_range_kernel(const long long* __restrict__ keys,
                                   long long n,
                                   const int* __restrict__ bucket_starts,
                                   int key_shift,
                                   const long long* __restrict__ probes,
                                   long long b, int steps,
                                   long long* __restrict__ lo_out,
                                   long long* __restrict__ hi_out) {
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < b; t += (long long)gridDim.x * blockDim.x) {
    const long long p = probes[t];
    long long lo0 = 0, hi0 = n;
    if (key_shift >= 0) {
      const long long pre = p >> key_shift;
      lo0 = bucket_starts[pre];
      hi0 = bucket_starts[pre + 1];
    }
    lo_out[t] = search(keys, lo0, hi0, p, steps, false);
    hi_out[t] = search(keys, lo0, hi0, p, steps, true);
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

// keys: int64 [n] sorted; bucket_starts: int32 [2^pb + 1], read only when
// key_shift >= 0 (the bucket of a probe p is p >> key_shift); probes:
// int64 [b]; lo, hi: int64 [b].
ASGART_API int asgart_equal_range(const void* keys, long long n,
                                  const void* bucket_starts, int key_shift,
                                  const void* probes, long long b, int steps,
                                  void* lo, void* hi, void* stream) {
  if (b <= 0) return (int)cudaGetLastError();
  equal_range_kernel<<<asgart::grid_for(b), asgart::kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const long long*)keys, n, (const int*)bucket_starts, key_shift,
      (const long long*)probes, b, steps, (long long*)lo, (long long*)hi);
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
