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
// KP: the source table (S pointers and S + 1 offsets) goes into the launch
//   itself, a __grid_constant__ struct of capacity 8, 64 or 1024 sources
//   (the smallest that holds S, chosen by the wrapper from S alone,
//   kernels/slices.py kp_capacity), filled on the host stack from the
//   host arrays: no device allocation, no copy to the card, no host sync.
//   Past 1024 sources the same kernel reads the table from device memory
//   (the wrapper uploads it); no input that fits the card comes near it,
//   since a merge takes the 2-5 slices of one chunk or the P cells of one
//   window. Each thread takes 4 consecutive outputs: idx read as two
//   16-byte loads and out written as one 16-byte store when both are
//   16-byte aligned (else as scalars), the last n % 4 by one thread. The
//   merge's indices run in order within each source, so a thread finds
//   the source of its first index by binary search over the offsets and
//   searches again only when an index leaves that source's range. The
//   sources are read as scalars: a slice's buffer may start at any int32.
//   Bound on the H100: memory. 8 B of index and 4 B of output per entry in
//   order, and 4 B of source per entry; the source reads coalesce within
//   each run of consecutive indices.
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

// KP's source table, passed by value: the S sources' pointers and their
// S + 1 offsets in the concatenation (off[0] == 0).
template <int kCap>
struct SrcTable {
  const int* ptr[kCap];
  long long off[kCap + 1];
  int n;
  __device__ __forceinline__ const int* src(int s) const { return ptr[s]; }
  __device__ __forceinline__ long long start(int s) const { return off[s]; }
};

// The same table in device memory: the form past the largest capacity.
struct DevTable {
  const long long* ptr;
  const long long* off;
  int n;
  __device__ __forceinline__ const int* src(int s) const {
    return reinterpret_cast<const int*>(__ldg(ptr + s));
  }
  __device__ __forceinline__ long long start(int s) const {
    return __ldg(off + s);
  }
};

// The source whose range [start(s), start(s + 1)) holds the flat index i.
template <class Table>
__device__ __forceinline__ int source_of(const Table& t, long long i) {
  int lo = 0, hi = t.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.start(mid) <= i) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// A thread's current source: its range [a, b) and its buffer.
struct Cursor {
  long long a = 1, b = 0;  // empty: the first index searches
  const int* src = nullptr;
  template <class Table>
  __device__ __forceinline__ int read(const Table& t, long long i) {
    if (i < a || i >= b) {
      const int s = source_of(t, i);
      a = t.start(s);
      b = t.start(s + 1);
      src = t.src(s);
    }
    return src[i - a];
  }
};

template <bool kVec, class Table>
__device__ __forceinline__ void gather_flat_body(
    const Table& t, const long long* __restrict__ idx, long long n,
    int* __restrict__ out) {
  const long long n4 = n >> 2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long g0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  Cursor c;
  for (long long g = g0; g < n4; g += stride) {
    long long i[4];
    if (kVec) {
      const longlong2 p = reinterpret_cast<const longlong2*>(idx)[2 * g];
      const longlong2 q = reinterpret_cast<const longlong2*>(idx)[2 * g + 1];
      i[0] = p.x; i[1] = p.y; i[2] = q.x; i[3] = q.y;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) i[j] = idx[4 * g + j];
    }
    int v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = c.read(t, i[j]);
    if (kVec) {
      reinterpret_cast<int4*>(out)[g] = make_int4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) out[4 * g + j] = v[j];
    }
  }
  if (g0 == 0) {  // the tail
    for (long long e = 4 * n4; e < n; ++e) out[e] = c.read(t, idx[e]);
  }
}

template <bool kVec, int kCap>
__global__ void gather_flat_kernel(const __grid_constant__ SrcTable<kCap> t,
                                   const long long* __restrict__ idx,
                                   long long n, int* __restrict__ out) {
  gather_flat_body<kVec>(t, idx, n, out);
}

template <bool kVec>
__global__ void gather_flat_table_kernel(const DevTable t,
                                         const long long* __restrict__ idx,
                                         long long n, int* __restrict__ out) {
  gather_flat_body<kVec>(t, idx, n, out);
}

template <bool kVec, int kCap>
void launch_by_value(const long long* table, int n_src, const long long* idx,
                     long long n, int* out, cudaStream_t stream) {
  SrcTable<kCap> t{};
  for (int s = 0; s < n_src; ++s) {
    t.ptr[s] = reinterpret_cast<const int*>(table[s]);
  }
  for (int s = 0; s <= n_src; ++s) t.off[s] = table[n_src + s];
  t.n = n_src;
  gather_flat_kernel<kVec, kCap>
      <<<asgart::grid_for((n + 3) >> 2), asgart::kThreads, 0, stream>>>(
          t, idx, n, out);
}

template <bool kVec>
int launch_gather_flat(const long long* table, int n_src, int cap,
                       const long long* idx, long long n, int* out,
                       cudaStream_t stream) {
  switch (cap) {
    case 8:
      launch_by_value<kVec, 8>(table, n_src, idx, n, out, stream);
      break;
    case 64:
      launch_by_value<kVec, 64>(table, n_src, idx, n, out, stream);
      break;
    case 1024:
      launch_by_value<kVec, 1024>(table, n_src, idx, n, out, stream);
      break;
    case 0:
      gather_flat_table_kernel<kVec>
          <<<asgart::grid_for((n + 3) >> 2), asgart::kThreads, 0, stream>>>(
              DevTable{table, table + n_src, n_src}, idx, n, out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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

// table: int64 [2 n_src + 1], the n_src pointers of int32 buffers, then
// their n_src + 1 offsets in the concatenation (the first 0); on the host
// for cap 8, 64 or 1024 (>= n_src: passed by value), on the card for cap 0.
// idx: int64 [n], each in [0, the last offset); out: int32 [n].
ASGART_API int asgart_gather_flat(const void* table, int n_src, int cap,
                                  const void* idx, long long n, void* out,
                                  void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (n_src < 1 || (cap != 0 && n_src > cap)) return (int)cudaErrorInvalidValue;
  const bool vec =
      ((reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(out)) &
       15) == 0;
  return vec ? launch_gather_flat<true>(
                   (const long long*)table, n_src, cap, (const long long*)idx,
                   n, (int*)out, (cudaStream_t)stream)
             : launch_gather_flat<false>(
                   (const long long*)table, n_src, cap, (const long long*)idx,
                   n, (int*)out, (cudaStream_t)stream);
}
