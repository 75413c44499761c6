// KA pack_keys: the sort key of every row of the fused index, as one int64
// word (k <= 20) or two words (k = 21..30).
//
// Replaces (JAX reference, asgart_tpu/):
//   device_index.py:269 _pack_planes_all   (text k-mer planes 0..W)
//     and :283 _pack_planes3_all            (3 planes, k = 21..30)
//   device_engine.py:904 _pack_batch_probe_keys (+ _pack_probe_lanes :710,
//     _dec_read :116, _probe_x0 :130) (probe-lane planes + lane mask)
//     and :761 _pack_batch_probe_keys3 (+ _pack_probe_lanes3 :735)
//   device_index.py:1477 _fused_cat_planes and :1496 _fused_cat_planes3
//     (concat, lo clamp)
//   device_index.py:317 _flagged_sort's / :341 _flagged_sort3's flag
//     (direct rows 0, probe rows 1)
//   device_index.py:1462 _transformed_codes / :246 _build_text_codes (the
//     appended half is read through index arithmetic, never built)
//   device_index.py:1288 _window_codes (the trim window's text + '$' + k
//     zeros, read in place: window mode below)
//   for the merge-join window engine, the two sides apart:
//     device_engine.py:904 _pack_batch_probe_keys alone (W = 0: probe-only
//     mode) and device_index.py:269 _pack_planes_all over _window_codes
//     as window_arrays_from_codes uses them (:1306; total = 0)
//
// Every row folds its k symbols (3 bits each) into `hi`, the first k-10
// (0 for k <= 10), and `lo`, the last min(k, 10). Row r < W is a direct
// text row of the window text codes[ws, ws + W - 1) + '$': symbol t is
// codes[ws + r + t] while r + t < W - 1 and 0 past it ('$' rank, the JAX
// zero padding). The whole genome is the window ws = 0, W = n1, whose
// last symbol codes[n1 - 1] is its own '$'. Row
// W + j is probe lane j: its symbols are read from the transformed half
// (complement via COMP, reversed index n1-2-q) at x0 + j*step + t, with
// the flag bit set; lanes past the chunks' total are pad rows with the
// JAX sentinel (every plane 2^31-1, lo clamped to 2^30-1).
//   one word:  key = (hi << 31) | (lo << 1) | flag
//   two words: w1 = (top << 31) | hi30, w0 = (lo << 1) | flag, where
//              top = hi >> 30 is the JAX top plane (first k-20 symbols)
//              and hi30 the low 30 bits of hi (its hi plane).
// Every JAX plane is < 2^31, so the signed order of the key, or of
// (w1, w0), equals the JAX lexicographic order of (hi, flagged lo), or of
// (top, hi, flagged lo).
//
// Bound on the H100: memory. It writes 8 B (12 B with two words) per row
// and reads k bytes per row that neighbouring threads share (direct rows
// overlap by k-1 bytes, probe rows by k-step), so reads hit L1/L2 and the
// store stream sets the time. Design: one thread per row, grid-stride,
// consecutive threads on consecutive rows so the stores coalesce; no
// decimated layout (that existed only to make strided TPU reads
// contiguous).
#include "common.cuh"

namespace {

__constant__ uint8_t kComp[8] = {0, 5, 3, 2, 4, 1, 0, 0};

constexpr long long kPlaneMax = 0x7FFFFFFF;       // JAX sentinel plane
constexpr long long kLoClamp = (1LL << 30) - 1;   // the lo clamp

template <int kWords>
__device__ __forceinline__ void store_key(long long r, long long hi,
                                          long long lo, int flag,
                                          long long* key, int* key_lo) {
  if (kWords == 1) {
    key[r] = (hi << 31) | (lo << 1) | flag;
  } else {
    key[r] = ((hi >> 30) << 31) | (hi & kLoClamp);
    key_lo[r] = (int)((lo << 1) | flag);
  }
}

template <int kWords>
__global__ void pack_keys_kernel(const uint8_t* __restrict__ codes,
                                 long long n1,
                                 const long long* __restrict__ lane_off,
                                 const long long* __restrict__ x0cl,
                                 int n_chunks, long long W, long long ws,
                                 long long total, int k, int reverse,
                                 int complement,
                                 long long* __restrict__ key,
                                 int* __restrict__ key_lo,
                                 uint8_t* __restrict__ lane_mask) {
  const int step = k / 2;
  const int n_hi = k > 10 ? k - 10 : 0;
  const bool transformed = reverse || complement;
  const long long M = W + total;
  const long long n_live = lane_off[n_chunks];
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < M; r += (long long)gridDim.x * blockDim.x) {
    long long hi = 0, lo = 0;
    if (r < W) {
      for (int t = 0; t < k; ++t) {
        long long q = r + t;
        long long s = q < W - 1 ? __ldg(codes + ws + q) : 0;
        if (t < n_hi) hi = (hi << 3) | s; else lo = (lo << 3) | s;
      }
      store_key<kWords>(r, hi, lo, 0, key, key_lo);
      continue;
    }
    const long long lane = r - W;
    if (lane >= n_live) {
      if (kWords == 1) {
        key[r] = (kPlaneMax << 31) | (kLoClamp << 1) | 1;
      } else {
        key[r] = (kPlaneMax << 31) | kPlaneMax;
        key_lo[r] = (int)((kLoClamp << 1) | 1);
      }
      lane_mask[lane] = 0;
      continue;
    }
    const int c = asgart::chunk_of(lane_off, n_chunks, lane);
    const long long j = lane - lane_off[c];
    const long long x0 = x0cl[2 * c], cl = x0cl[2 * c + 1];
    int first = 0;
    for (int t = 0; t < k; ++t) {
      long long q = x0 + j * step + t;
      int s;
      if (transformed) {
        if (q >= n1 - 1) {
          s = 0;
        } else {
          s = __ldg(codes + (reverse ? n1 - 2 - q : q));
          if (complement) s = kComp[s & 7];
        }
      } else {
        s = q < n1 ? __ldg(codes + q) : 0;
      }
      if (t == 0) first = s;
      if (t < n_hi) hi = (hi << 3) | s; else lo = (lo << 3) | s;
    }
    if (lo > kLoClamp) lo = kLoClamp;
    store_key<kWords>(r, hi, lo, 1, key, key_lo);
    lane_mask[lane] = (first != 4) && (j * step < cl - k - step);
  }
}

}  // namespace

// key_lo == nullptr: one int64 word per row into `key` (k <= 20);
// otherwise w1 into `key` (int64) and w0 into `key_lo` (int32).
ASGART_API int asgart_pack_keys(const void* codes, long long n1,
                                const void* lane_off, const void* x0cl,
                                int n_chunks, long long W, long long ws,
                                long long total, int k, int reverse,
                                int complement, void* key, void* key_lo,
                                void* lane_mask, void* stream) {
  const long long M = W + total;
  const unsigned grid = asgart::grid_for(M);
  cudaStream_t s = (cudaStream_t)stream;
  if (key_lo == nullptr) {
    pack_keys_kernel<1><<<grid, asgart::kThreads, 0, s>>>(
        (const uint8_t*)codes, n1, (const long long*)lane_off,
        (const long long*)x0cl, n_chunks, W, ws, total, k, reverse,
        complement, (long long*)key, nullptr, (uint8_t*)lane_mask);
  } else {
    pack_keys_kernel<2><<<grid, asgart::kThreads, 0, s>>>(
        (const uint8_t*)codes, n1, (const long long*)lane_off,
        (const long long*)x0cl, n_chunks, W, ws, total, k, reverse,
        complement, (long long*)key, (int*)key_lo, (uint8_t*)lane_mask);
  }
  return (int)cudaGetLastError();
}

ASGART_API const char* asgart_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}
