// KD scan_core: per-lane match filtering and event compaction for one
// chunk of the fused index.
//
// Replaces (JAX reference): asgart_tpu/device_engine.py:249
// _core_from_ranges, as dispatched by _scan_core (:352) and
// _scan_core_group (:402) for the fused engine (self_base = 0,
// dir_base = chunk_start, rev_t0 = chunk_start + chunk_len), with the
// slicing helpers _range_granule_totals (:589), _slice_lanes_dyn (:601)
// and _slice_lanes (:964) made unnecessary.
//
// For lane l (probe i = (j0 + l + 1) * step) and each match m = sa[x],
// x in [lane_lo, lane_hi): keep m when m != i, m < max_match_pos and
// (reverse ? m >= rev_t0 - i : m > i + dir_base). A lane is an event when
// masked in and 0 < kept <= max_cardinality, quiet-valid when masked in
// with kept == 0. Outputs, sized exactly (no capacity, no overflow, no
// retry): ev_pack [3, n_events] = (probe i, quiet lanes since the previous
// event, kept count), m_flat [total_kept] in (lane, slot) order, and
// z_trail (quiet lanes after the last event) — the live prefixes of the
// JAX outputs.
//
// Three launches around one torch.cumsum done by the wrapper:
//   count: per lane, kept matches, stopping at max_cardinality + 1 (exact:
//          such a lane is neither an event nor quiet-valid); writes the
//          event / quiet / kept-count rows [3, n_lanes];
//   (cumsum of the three rows, inclusive, int64; the host reads the two
//          totals to size the outputs);
//   emit:  per event lane, its ev_pack column, the running quiet count,
//          and its kept matches at their m_flat offset;
//   finish: z_before as differences of the running quiet counts, and
//          z_trail.
// Bound on the H100: the sa reads, latency-bound — a lane walks its
// window sequentially (sa[lo..hi) is contiguous, but neighbouring lanes'
// windows are not), and a repeat-dense lane serialises its thread. Design
// for this first version: one thread per lane, early stop at
// max_cardinality + 1, and a match list written once at its final offset
// (the JAX version sorted a capacity-sized flat buffer twice).
#include "common.cuh"

namespace {

struct ScanArgs {
  const int* lane_lo;
  const int* lane_hi;
  const uint8_t* lane_mask;
  const int* sa;
  long long n_lanes, chunk_start, chunk_len;
  int max_card;
  long long j0;
  int step, reverse;
  long long max_match_pos;
};

__device__ __forceinline__ bool keep_match(const ScanArgs& a, long long m,
                                           long long i) {
  if (m == i || m >= a.max_match_pos) return false;
  return a.reverse ? m >= a.chunk_start + a.chunk_len - i
                   : m > i + a.chunk_start;
}

__global__ void scan_count_kernel(ScanArgs a, int* __restrict__ flags) {
  const long long n = a.n_lanes;
  for (long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       l < n; l += (long long)gridDim.x * blockDim.x) {
    int kept = 0;
    const bool live = a.lane_mask[l] != 0;
    if (live) {
      const long long i = (a.j0 + l + 1) * a.step;
      const int hi = a.lane_hi[l];
      for (int x = a.lane_lo[l]; x < hi; ++x) {
        if (keep_match(a, __ldg(a.sa + x), i) && ++kept > a.max_card) break;
      }
    }
    const bool event = live && kept > 0 && kept <= a.max_card;
    flags[l] = event;
    flags[n + l] = live && kept == 0;
    flags[2 * n + l] = event ? kept : 0;
  }
}

__global__ void scan_emit_kernel(ScanArgs a, const int* __restrict__ flags,
                                 const long long* __restrict__ cums,
                                 long long n_events, int* __restrict__ ev_pack,
                                 int* __restrict__ m_flat,
                                 int* __restrict__ a_evt) {
  const long long n = a.n_lanes;
  for (long long l = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       l < n; l += (long long)gridDim.x * blockDim.x) {
    if (!flags[l]) continue;
    const long long e = cums[l] - 1;
    const int kept = flags[2 * n + l];
    const long long i = (a.j0 + l + 1) * a.step;
    ev_pack[e] = (int)i;
    ev_pack[2 * n_events + e] = kept;
    a_evt[e] = (int)cums[n + l];
    long long off = cums[2 * n + l] - kept;
    const long long end = off + kept;
    const int hi = a.lane_hi[l];
    for (int x = a.lane_lo[l]; x < hi && off < end; ++x) {
      const int m = __ldg(a.sa + x);
      if (keep_match(a, m, i)) m_flat[off++] = m;
    }
  }
}

__global__ void scan_finish_kernel(const int* __restrict__ a_evt,
                                   long long n_events,
                                   const long long* __restrict__ quiet_total,
                                   int* __restrict__ ev_z,
                                   int* __restrict__ z_trail) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long e = tid; e < n_events;
       e += (long long)gridDim.x * blockDim.x) {
    ev_z[e] = a_evt[e] - (e ? a_evt[e - 1] : 0);
  }
  if (tid == 0) {
    *z_trail = (int)(*quiet_total - (n_events ? a_evt[n_events - 1] : 0));
  }
}

ScanArgs make_args(const void* lane_lo, const void* lane_hi,
                   const void* lane_mask, const void* sa, long long n_lanes,
                   long long chunk_start, long long chunk_len, int max_card,
                   long long j0, int k, int reverse,
                   long long max_match_pos) {
  ScanArgs a;
  a.lane_lo = (const int*)lane_lo;
  a.lane_hi = (const int*)lane_hi;
  a.lane_mask = (const uint8_t*)lane_mask;
  a.sa = (const int*)sa;
  a.n_lanes = n_lanes;
  a.chunk_start = chunk_start;
  a.chunk_len = chunk_len;
  a.max_card = max_card;
  a.j0 = j0;
  a.step = k / 2;
  a.reverse = reverse;
  a.max_match_pos = max_match_pos;
  return a;
}

}  // namespace

ASGART_API int asgart_scan_count(const void* lane_lo, const void* lane_hi,
                                 const void* lane_mask, const void* sa,
                                 long long n_lanes, long long chunk_start,
                                 long long chunk_len, int max_card,
                                 long long j0, int k, int reverse,
                                 long long max_match_pos, void* flags,
                                 void* stream) {
  ScanArgs a = make_args(lane_lo, lane_hi, lane_mask, sa, n_lanes,
                         chunk_start, chunk_len, max_card, j0, k, reverse,
                         max_match_pos);
  scan_count_kernel<<<asgart::grid_for(n_lanes), asgart::kThreads, 0,
                      (cudaStream_t)stream>>>(a, (int*)flags);
  return (int)cudaGetLastError();
}

ASGART_API int asgart_scan_emit(const void* lane_lo, const void* lane_hi,
                                const void* lane_mask, const void* sa,
                                long long n_lanes, long long chunk_start,
                                long long chunk_len, int max_card,
                                long long j0, int k, int reverse,
                                long long max_match_pos, const void* flags,
                                const void* cums, long long n_events,
                                void* ev_pack, void* m_flat, void* z_trail,
                                void* a_evt, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  ScanArgs a = make_args(lane_lo, lane_hi, lane_mask, sa, n_lanes,
                         chunk_start, chunk_len, max_card, j0, k, reverse,
                         max_match_pos);
  scan_emit_kernel<<<asgart::grid_for(n_lanes), asgart::kThreads, 0, s>>>(
      a, (const int*)flags, (const long long*)cums, n_events, (int*)ev_pack,
      (int*)m_flat, (int*)a_evt);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  // quiet_total: the inclusive quiet-lane count at the last lane
  scan_finish_kernel<<<asgart::grid_for(n_events), asgart::kThreads, 0, s>>>(
      (const int*)a_evt, n_events,
      (const long long*)cums + 2 * n_lanes - 1, (int*)ev_pack + n_events,
      (int*)z_trail);
  return (int)cudaGetLastError();
}
