// KA pack_keys: one int64 sort key per row of the fused index.
//
// Replaces (JAX reference, asgart_tpu/):
//   device_index.py:269 _pack_planes_all   (text k-mer planes 0..W)
//   device_engine.py:904 _pack_batch_probe_keys (+ _pack_probe_lanes :710,
//     _dec_read :116, _probe_x0 :130) (probe-lane planes + lane mask)
//   device_index.py:1477 _fused_cat_planes (concat, lo clamp)
//   device_index.py:317 _flagged_sort's flag (direct rows 0, probe rows 1)
//   device_index.py:1462 _transformed_codes / :246 _build_text_codes (the
//     appended half is read through index arithmetic, never built)
//
// Row r < W is a direct text row: key = (hi << 31) | (lo << 1), hi the
// first k-10 symbols (3 bits each, 0 for k <= 10), lo the last min(k, 10);
// symbols past n1 read 0 ('$' rank, the JAX zero padding). Row W + j is
// probe lane j: its symbols are read from the transformed half
// (complement via COMP, reversed index n1-2-q) at x0 + j*step + t, with
// the flag bit set; lanes past the chunks' total are pad rows with the
// JAX sentinel (hi = 2^31-1, lo clamped to 2^30-1). Ordering the key as a
// signed int64 equals the JAX lexicographic (hi, (lo << 1) | flag) order.
//
// Bound on the H100: memory. It writes 8 B per row and reads k bytes per
// row that neighbouring threads share (direct rows overlap by k-1 bytes,
// probe rows by k-step), so reads hit L1/L2 and the store stream of
// ~8 B/row (1.1 GB at 141 M rows) sets the time. Design: one thread per
// row, grid-stride, consecutive threads on consecutive rows so the 8-byte
// stores coalesce; no decimated layout (that existed only to make strided
// TPU reads contiguous).
#include "common.cuh"

namespace {

__constant__ uint8_t kComp[8] = {0, 5, 3, 2, 4, 1, 0, 0};

__global__ void pack_keys_kernel(const uint8_t* __restrict__ codes,
                                 long long n1,
                                 const long long* __restrict__ lane_off,
                                 const long long* __restrict__ x0cl,
                                 int n_chunks, long long W, long long total,
                                 int k, int reverse, int complement,
                                 long long* __restrict__ key,
                                 uint8_t* __restrict__ lane_mask) {
  constexpr long long kPadKey =
      ((long long)0x7FFFFFFF << 31) | ((long long)((1 << 30) - 1) << 1) | 1;
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
        long long s = q < n1 ? __ldg(codes + q) : 0;
        if (t < n_hi) hi = (hi << 3) | s; else lo = (lo << 3) | s;
      }
      key[r] = (hi << 31) | (lo << 1);
      continue;
    }
    const long long lane = r - W;
    if (lane >= n_live) {
      key[r] = kPadKey;
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
    if (lo > (1 << 30) - 1) lo = (1 << 30) - 1;
    key[r] = (hi << 31) | (lo << 1) | 1;
    lane_mask[lane] = (first != 4) && (j * step < cl - k - step);
  }
}

}  // namespace

ASGART_API int asgart_pack_keys(const void* codes, long long n1,
                                const void* lane_off, const void* x0cl,
                                int n_chunks, long long W, long long total,
                                int k, int reverse, int complement,
                                void* key, void* lane_mask, void* stream) {
  const long long M = W + total;
  pack_keys_kernel<<<asgart::grid_for(M), asgart::kThreads, 0,
                     (cudaStream_t)stream>>>(
      (const uint8_t*)codes, n1, (const long long*)lane_off,
      (const long long*)x0cl, n_chunks, W, total, k, reverse, complement,
      (long long*)key, (uint8_t*)lane_mask);
  return (int)cudaGetLastError();
}

ASGART_API const char* asgart_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}
