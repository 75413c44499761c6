// KD scan_core: per-lane match filtering and event compaction for one
// chunk of the fused index.
//
// Replaces (JAX reference): asgart_tpu/device_engine.py:249
// _core_from_ranges, as dispatched by _scan_core (:352) and
// _scan_core_group (:402) for the fused engine (self_base = 0, dir_base =
// chunk_start, rev_t0 = chunk_start + chunk_len), and by _scan_core_based
// (:665) and _scan_core_based_group (:636) for the merge-join engine,
// whose suffix order is window-relative (the three constants rebased by
// the window start and clamped on the host, as BigWindowEngine._rebased,
// :2632, computes them). A repeat-heavy chunk is scanned slice by slice,
// each slice a view of the chunk's lanes with j0 at its lane offset
// (_slice_lanes_dyn, :601, and _slice_lanes, :964, need no kernel; the
// slice plan's granule totals are KO, csrc/slices.cu).
//
// For lane l (probe i = (j0 + l + 1) * step) and each match m = sa[x],
// x in [lane_lo, lane_hi): keep m when m != i + self_base,
// m < max_match_pos and (reverse ? m >= rev_t0 - i : m > i + dir_base),
// all in 64-bit arithmetic. A lane is an event when
// masked in and 0 < kept <= max_cardinality, quiet-valid when masked in
// with kept == 0. Outputs, sized exactly (no capacity, no overflow, no
// retry): ev_pack [3, n_events] = (probe i, quiet lanes since the previous
// event, kept count), m_flat [total_kept] in (lane, slot) order, and
// z_trail (quiet lanes after the last event) — the live prefixes of the
// JAX outputs.
//
// Four launches and one read of the totals by the host:
//   count:  one block per kScanThreads lanes. Each lane's kept matches,
//           stopping at max_cardinality + 1 (exact: such a lane is neither
//           an event nor quiet-valid), into one int32 code per lane (kept
//           for an event, 0 for a quiet lane, -1 otherwise), and the
//           block's event, quiet and kept counts (warp shuffles, then
//           shared memory) into its column of the block sums;
//   blocks: one block scans the block sums into each block's exclusive
//           offsets and the three totals (the host reads two of them to
//           size the outputs);
//   emit:   each block rescans its codes in shared memory and writes, at
//           their final offsets, its events' ev_pack columns, each event's
//           running quiet count and its kept matches;
//   finish: z_before as differences of the running quiet counts, and
//           z_trail.
// Bound on the H100: memory. 9 B a lane of inputs and 4 B of code written
// and read again, plus the sa entries the windows need and the outputs.
// The scans are the block sums' and, in shared memory, each block's own:
// no scan runs over [3, n] buffers, since PyTorch's cumsum along the last
// dimension of such a buffer runs one block per row (3 blocks on 132 SMs:
// 11.84 ms of a 12.44 ms call on a 6.4 M-lane chunk, PERF.md §6).
// The window walk: a lane walks its window in one thread when the window
// holds at most kWarpWalk entries, and a warp walks a longer one: it reads
// 32 consecutive sa entries at a time, counts the kept ones with
// __ballot_sync / __popc, stops at the same max_cardinality + 1 and, in
// emit, writes each kept match at its offset plus the popcount of the kept
// slots below it (coalesced, in slot order).
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
// lanes per block of count and emit (kernels/scan_core.py
// KD_BLOCK_LANES): 6,250 block sums on a 6.4 M-lane chunk
constexpr int kScanThreads = 1024;
constexpr int kWarps = kScanThreads / 32;
constexpr int kBlockScanThreads = 1024;
// The longest window one thread walks; longer ones take a warp. The masked
// windows' lengths (PERF.md §6): whole k = 20's 6.4 M-lane chunk 99.2%
// empty, the rest 1-31 entries but 42 lanes of 256-483; table_repeats'
// chunk 58% empty, 11% of 1-7 entries, 31% of 64-159 (224 M of its 225 M
// reads). Any threshold from 8 to 63 splits both alike; at 32 a warp's
// walk costs one read of 32 entries, and a thread's walk of up to 32
// holds its warp's other lanes no longer than that.
constexpr int kWarpWalk = 32;

struct ScanArgs {
  const int* lane_lo;
  const int* lane_hi;
  const uint8_t* lane_mask;
  const int* sa;
  long long n_lanes, self_base, dir_base, rev_t0;
  int max_card;
  long long j0;
  int step, reverse;
  long long max_match_pos;
};

__device__ __forceinline__ bool keep_match(const ScanArgs& a, long long m,
                                           long long i) {
  if (m == i + a.self_base || m >= a.max_match_pos) return false;
  return a.reverse ? m >= a.rev_t0 - i : m > i + a.dir_base;
}

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;
}

// Exclusive prefix sum of v over the block (kT threads, a multiple of 32);
// *total, where given, gets the block's sum. ws: kT / 32 words of shared
// memory, free again when this returns.
template <int kT>
__device__ __forceinline__ long long block_scan(long long v, long long* ws,
                                                long long* total) {
  const int ln = threadIdx.x & 31, w = threadIdx.x >> 5;
  long long x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(kFull, x, o);
    if (ln >= o) x += y;
  }
  if (ln == 31) ws[w] = x;
  __syncthreads();
  if (w == 0) {
    long long s = ln < kT / 32 ? ws[ln] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(kFull, s, o);
      if (ln >= o) s += y;
    }
    if (ln < kT / 32) ws[ln] = s;
  }
  __syncthreads();
  const long long r = (w ? ws[w - 1] : 0) + x - v;
  if (total) *total = ws[kT / 32 - 1];
  __syncthreads();
  return r;
}

// Kept matches of window [lo, hi) for probe i, walked by one warp 32
// entries at a time, stopping once past max_card (the count is then some
// value above it). Every lane of the warp gets the count.
__device__ __forceinline__ int warp_count(const ScanArgs& a, int lo, int hi,
                                          long long i) {
  const int ln = threadIdx.x & 31;
  int c = 0;
  for (int x0 = lo; x0 < hi; x0 += 32) {
    const int x = x0 + ln;
    const bool k = x < hi && keep_match(a, __ldg(a.sa + x), i);
    c += __popc(__ballot_sync(kFull, k));
    if (c > a.max_card) break;
  }
  return c;
}

__global__ void __launch_bounds__(kScanThreads)
scan_count_kernel(ScanArgs a, int* __restrict__ code,
                  long long* __restrict__ sums) {
  __shared__ int long_lanes[kScanThreads];
  __shared__ int long_kept[kScanThreads];
  __shared__ int n_long;
  __shared__ long long part[3][kWarps];
  const int t = threadIdx.x, ln = t & 31, w = t >> 5;
  const long long l0 = (long long)blockIdx.x * kScanThreads;
  const long long l = l0 + t;
  if (t == 0) n_long = 0;
  __syncthreads();
  bool live = false, walked = false;
  int kept = 0;
  if (l < a.n_lanes && a.lane_mask[l]) {
    live = true;
    const int lo = a.lane_lo[l], hi = a.lane_hi[l];
    if (hi - lo > kWarpWalk) {
      long_lanes[atomicAdd(&n_long, 1)] = t;
      walked = true;
    } else {
      const long long i = (a.j0 + l + 1) * a.step;
      for (int x = lo; x < hi; ++x) {
        if (keep_match(a, __ldg(a.sa + x), i) && ++kept > a.max_card) break;
      }
    }
  }
  __syncthreads();
  for (int j = w; j < n_long; j += kWarps) {  // the long windows, a warp each
    const int u = long_lanes[j];
    const long long lu = l0 + u;
    const int c = warp_count(a, a.lane_lo[lu], a.lane_hi[lu],
                             (a.j0 + lu + 1) * a.step);
    if (ln == 0) long_kept[u] = c;
  }
  __syncthreads();
  if (walked) kept = long_kept[t];
  const bool event = live && kept > 0 && kept <= a.max_card;
  const bool quiet = live && kept == 0;
  if (l < a.n_lanes) code[l] = event ? kept : (quiet ? 0 : -1);
  const long long v[3] = {event, quiet, event ? kept : 0};
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const long long s = warp_sum(v[r]);
    if (ln == 0) part[r][w] = s;
  }
  __syncthreads();
  if (w == 0) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const long long s = warp_sum(ln < kWarps ? part[r][ln] : 0);
      if (ln == 0) sums[(long long)r * gridDim.x + blockIdx.x] = s;
    }
  }
}

// The three rows of block sums [3, n_blocks] into exclusive offsets, in
// place, and their totals (n_events, quiet lanes, total_kept) into tot.
// One block, a row at a time, in rounds of kBlockScanThreads x kRun sums
// (one round up to 16 M lanes): each thread loads kRun consecutive sums
// into registers (all its loads in flight at once), the block scans the
// threads' sums, each thread rewrites its run.
__global__ void __launch_bounds__(kBlockScanThreads)
scan_blocks_kernel(long long* __restrict__ sums, long long n_blocks,
                   long long* __restrict__ tot) {
  constexpr int kRun = 16;
  __shared__ long long ws[kBlockScanThreads / 32];
  for (int r = 0; r < 3; ++r) {
    long long* row = sums + (long long)r * n_blocks;
    long long carry = 0;
    for (long long c0 = 0; c0 < n_blocks;
         c0 += (long long)kBlockScanThreads * kRun) {
      const long long b0 = c0 + (long long)threadIdx.x * kRun;
      long long v[kRun];
      long long s = 0;
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        v[j] = b0 + j < n_blocks ? row[b0 + j] : 0;
        s += v[j];
      }
      long long total;
      long long run = carry + block_scan<kBlockScanThreads>(s, ws, &total);
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        if (b0 + j < n_blocks) row[b0 + j] = run;
        run += v[j];
      }
      carry += total;
    }
    if (threadIdx.x == 0) tot[r] = carry;
  }
}

__global__ void __launch_bounds__(kScanThreads)
scan_emit_kernel(ScanArgs a, const int* __restrict__ code,
                 const long long* __restrict__ offs, long long n_events,
                 int* __restrict__ ev_pack, int* __restrict__ m_flat,
                 int* __restrict__ a_evt) {
  __shared__ long long ws[kWarps];
  __shared__ int long_lanes[kScanThreads];
  __shared__ long long long_off[kScanThreads];
  __shared__ int n_long;
  const int t = threadIdx.x, ln = t & 31, w = t >> 5;
  const long long nb = gridDim.x, b = blockIdx.x;
  const long long l0 = b * kScanThreads;
  const long long l = l0 + t;
  if (t == 0) n_long = 0;
  const int c = l < a.n_lanes ? code[l] : -1;
  const bool event = c > 0;
  // events (high word) and quiet lanes (low word) before this lane in the
  // block: each at most kScanThreads, so the words never carry
  const long long eq = block_scan<kScanThreads>(
      event ? (1LL << 32) : (c == 0 ? 1 : 0), ws, nullptr);
  const long long kb = block_scan<kScanThreads>(event ? c : 0, ws, nullptr);
  if (event) {
    const long long e = offs[b] + (eq >> 32);
    const long long i = (a.j0 + l + 1) * a.step;
    ev_pack[e] = (int)i;
    ev_pack[2 * n_events + e] = c;
    a_evt[e] = (int)(offs[nb + b] + (eq & 0xFFFFFFFFLL));
    long long off = offs[2 * nb + b] + kb;
    const int lo = a.lane_lo[l], hi = a.lane_hi[l];
    if (hi - lo > kWarpWalk) {
      const int j = atomicAdd(&n_long, 1);
      long_lanes[j] = t;
      long_off[t] = off;
    } else {
      const long long end = off + c;
      for (int x = lo; x < hi && off < end; ++x) {
        const int m = __ldg(a.sa + x);
        if (keep_match(a, m, i)) m_flat[off++] = m;
      }
    }
  }
  __syncthreads();
  for (int j = w; j < n_long; j += kWarps) {  // the long windows, a warp each
    const int u = long_lanes[j];
    const long long lu = l0 + u;
    const int lo = a.lane_lo[lu], hi = a.lane_hi[lu];
    const long long i = (a.j0 + lu + 1) * a.step;
    long long off = long_off[u];
    const long long end = off + code[lu];
    for (int x0 = lo; x0 < hi && off < end; x0 += 32) {
      const int x = x0 + ln;
      const int m = x < hi ? __ldg(a.sa + x) : 0;
      const bool k = x < hi && keep_match(a, m, i);
      const unsigned bal = __ballot_sync(kFull, k);
      if (k) m_flat[off + __popc(bal & ((1u << ln) - 1u))] = m;
      off += __popc(bal);
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
                   long long self_base, long long dir_base, long long rev_t0,
                   int max_card, long long j0, int k, int reverse,
                   long long max_match_pos) {
  ScanArgs a;
  a.lane_lo = (const int*)lane_lo;
  a.lane_hi = (const int*)lane_hi;
  a.lane_mask = (const uint8_t*)lane_mask;
  a.sa = (const int*)sa;
  a.n_lanes = n_lanes;
  a.self_base = self_base;
  a.dir_base = dir_base;
  a.rev_t0 = rev_t0;
  a.max_card = max_card;
  a.j0 = j0;
  a.step = k / 2;
  a.reverse = reverse;
  a.max_match_pos = max_match_pos;
  return a;
}

}  // namespace

// count + blocks: codes [n_lanes] int32, block sums [3, n_blocks] int64
// (n_blocks = ceil(n_lanes / kScanThreads), as kernels/scan_core.py
// kd_plan gives it; another count is refused), totals [3] int64
// (n_events, quiet lanes, total_kept).
ASGART_API int asgart_scan_count(const void* lane_lo, const void* lane_hi,
                                 const void* lane_mask, const void* sa,
                                 long long n_lanes, long long self_base,
                                 long long dir_base, long long rev_t0,
                                 int max_card, long long j0, int k,
                                 int reverse, long long max_match_pos,
                                 long long n_blocks, void* code, void* sums,
                                 void* tot, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  ScanArgs a = make_args(lane_lo, lane_hi, lane_mask, sa, n_lanes,
                         self_base, dir_base, rev_t0, max_card, j0, k,
                         reverse, max_match_pos);
  if (n_blocks != (n_lanes + kScanThreads - 1) / kScanThreads) {
    return (int)cudaErrorInvalidValue;
  }
  scan_count_kernel<<<(unsigned)n_blocks, kScanThreads, 0, s>>>(
      a, (int*)code, (long long*)sums);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  scan_blocks_kernel<<<1, kBlockScanThreads, 0, s>>>(
      (long long*)sums, n_blocks, (long long*)tot);
  return (int)cudaGetLastError();
}

// emit + finish, once the host has sized ev_pack [3, n_events], m_flat and
// z_trail from the totals; a_evt [n_events] int32 scratch.
ASGART_API int asgart_scan_emit(const void* lane_lo, const void* lane_hi,
                                const void* lane_mask, const void* sa,
                                long long n_lanes, long long self_base,
                                long long dir_base, long long rev_t0,
                                int max_card, long long j0, int k,
                                int reverse, long long max_match_pos,
                                long long n_blocks, const void* code,
                                const void* sums, const void* tot,
                                long long n_events, void* ev_pack,
                                void* m_flat, void* z_trail, void* a_evt,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  ScanArgs a = make_args(lane_lo, lane_hi, lane_mask, sa, n_lanes,
                         self_base, dir_base, rev_t0, max_card, j0, k,
                         reverse, max_match_pos);
  if (n_blocks != (n_lanes + kScanThreads - 1) / kScanThreads) {
    return (int)cudaErrorInvalidValue;
  }
  scan_emit_kernel<<<(unsigned)n_blocks, kScanThreads, 0, s>>>(
      a, (const int*)code, (const long long*)sums, n_events, (int*)ev_pack,
      (int*)m_flat, (int*)a_evt);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  // the quiet-lane total: tot[1]
  scan_finish_kernel<<<asgart::grid_for(n_events), asgart::kThreads, 0, s>>>(
      (const int*)a_evt, n_events, (const long long*)tot + 1,
      (int*)ev_pack + n_events, (int*)z_trail);
  return (int)cudaGetLastError();
}
