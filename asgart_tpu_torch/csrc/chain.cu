// KN chain_bursts: the arm automaton over independent bursts of events.
//
// Replaces (JAX reference): asgart_tpu/chain_jax.py:337 chain_events_lane
// under the vmap of chain_bursts (:369), as chain_events_device (:434)
// runs them, and through it chain_scan (:245) / chain_device (:275), whose
// probe stream the port turns into events first. It computes, exactly,
// what asgart_native.cpp asgart_chain_events computes for each burst: the
// automaton of src/automaton.rs, with int64 positions throughout and the
// native's double-precision `allow` (the JAX version held int32 positions
// and a float32 `allow`).
//
// A burst is a maximal run of events whose quiet gaps stay under t_split =
// ceil(max_gap / step) probes; after t_split quiet probes every arm is dead
// and the families are out, so each burst starts from an empty automaton.
// Per event, in the native order: the event's quiet run (each step ages
// every arm, prunes above 200 arms, emits on simultaneous death, and stops
// once no arm is active); every match classified against the pre-step
// snapshot (the first active arm in arm order with d_ss < allow and m_end >
// r_end); extensions, the last match winning r_end; spawns in match order,
// appended; aging of every arm not extended; the prune; the emission. After
// the last event, the trailing quiet run: t_split steps, or min(z_trail,
// t_split) for the last burst.
//
// Design. Persistent blocks take bursts from a global counter in the
// order the caller gives (longest first), one block per burst. The arm set
// (capacity A, struct of arrays) lives in dynamic shared memory, or, when
// A does not fit there, in a per-block slice of global scratch (the same
// code through generic pointers). A burst whose arms pass A stops and
// reports status 1; the caller reruns those bursts with 2A. Classification:
// a warp per (match, arm segment) walks 32 arms at a time and takes the
// first admissible one with a ballot (early exit, as the native's loop);
// several warps share a match when the event has fewer matches than warps
// (atomicMin). Extensions: an atomicMax of the match index per arm. Spawns,
// prune compaction (stable, in place, a tile of blockDim arms at a time) and
// emission: block prefix sums. Output rows (key = burst << 32 | row within
// the burst, l, r, l_len, r_len, family within the burst) go to a global
// buffer through an atomic counter that keeps counting past its capacity;
// the caller sorts them by key and reruns with the exact count when they
// did not fit. Each burst also reports the (match, arm) tests the native
// walk makes on it (for the bound).
//
// Bound on the H100: the burst chain is sequential within a burst, so the
// longest burst's events x the per-event latency (its block's barriers and
// the classification's dependent loads) set the time; the bytes (events and
// matches read once) and the tests over the ALU rate are far below it.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPruneAbove = 200;  // automaton.rs:173
constexpr int kMaxThreads = 512;  // kernels/chain.py THREADS

struct ChainArgs {
  const int* ev_i;               // probe index of each event [E]
  const int* ev_z;               // quiet probes before each event [E]
  const long long* m_off;        // CSR offsets of the matches [E + 1]
  const void* m;                 // matches, int32 or int64
  int m_is_i64;
  long long m_offset;            // added to every match, in int64
  const long long* burst_start;  // [NB + 1]
  const int* order;              // the bursts to run [n_order]
  int n_order, n_bursts;
  const int* z_trail;            // quiet probes after the last event [1]
  int t_split;
  long long ps, step, max_gap, min_dup;
  int arms_cap;
  long long* rows;               // [out_cap, 6]
  long long out_cap;
  unsigned long long* n_rows;    // rows emitted (counts past out_cap)
  int* next;                     // work counter
  int* status;                   // [NB]: 0 done, 1 arm overflow
  long long* tests;              // [NB]: native (match, arm) tests
  unsigned char* arms_global;    // nullptr: arms in shared memory
};

// The arm set of one block: struct of arrays over capacity A.
struct Arms {
  long long *ls, *le, *rs, *re, *allow, *gap;
  int *last, *act;
};

constexpr long long kArmBytes = 6 * 8 + 2 * 4;

__device__ Arms arms_at(unsigned char* base, int A) {
  Arms s;
  long long* p = (long long*)base;
  s.ls = p;
  s.le = p + A;
  s.rs = p + 2 * (long long)A;
  s.re = p + 3 * (long long)A;
  s.allow = p + 4 * (long long)A;
  s.gap = p + 5 * (long long)A;
  s.last = (int*)(p + 6 * (long long)A);
  s.act = s.last + A;
  return s;
}

__device__ __forceinline__ long long load_m(const ChainArgs& a, long long x) {
  const long long v = a.m_is_i64 ? ((const long long*)a.m)[x]
                                 : (long long)((const int*)a.m)[x];
  return v + a.m_offset;
}

// Exclusive block prefix sum of v; *total gets the block's sum. Every
// thread of the block must call it (three barriers).
__device__ int block_scan(int v, int* wsum, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[w] = x;
  __syncthreads();
  if (w == 0) {
    int s = lane < nw ? wsum[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    if (lane < nw) wsum[lane] = s;
  }
  __syncthreads();
  const int before = w ? wsum[w - 1] : 0;
  *total = wsum[nw - 1];
  __syncthreads();
  return before + x - v;
}

__device__ __forceinline__ bool admissible(const Arms& s, int j,
                                           long long m_s, long long m_e) {
  const long long a_s = s.rs[j], a_e = s.re[j];
  long long d = 0;
  if (!((m_s >= a_s && m_s <= a_e) || (m_e >= a_s && m_e <= a_e))) {
    const long long d1 = a_s - m_e < 0 ? m_e - a_s : a_s - m_e;
    const long long d2 = a_e - m_s < 0 ? m_s - a_e : a_e - m_s;
    d = d1 < d2 ? d1 : d2;
  }
  // allow is 0 for an inactive arm, and d >= 0: never admissible
  return d < s.allow[j] && m_e > a_e;
}

struct Burst {  // the block's per-burst scalars, in shared memory
  int n;        // live arms
  int over;     // arm overflow
  int fam;      // families emitted
  int job;
  long long rows;  // rows emitted
  long long slot;  // first global row of an emission tile
};

// The step tail shared by matched and quiet steps, after aging: the prune
// above 200 arms, then the emission on simultaneous death.
__device__ void prune_emit(const ChainArgs& a, const Arms& s, Burst& B,
                           int* wsum, int b, bool any_active) {
  const int T = blockDim.x;
  int n = B.n;
  if (n > kPruneAbove) {
    int out = 0;
    for (int t0 = 0; t0 < n; t0 += T) {
      const int j = t0 + threadIdx.x;
      long long ls = 0, le = 0, rs = 0, re = 0, gap = 0;
      int act = 0;
      bool keep = false;
      if (j < n) {
        ls = s.ls[j]; le = s.le[j]; rs = s.rs[j]; re = s.re[j];
        gap = s.gap[j]; act = s.act[j];
        keep = act || le - ls >= a.min_dup || re - rs >= a.min_dup;
      }
      int tot;
      const int dst = out + block_scan(keep, wsum, &tot);
      if (keep) {  // dst <= j: this tile's reads are all done
        s.ls[dst] = ls; s.le[dst] = le; s.rs[dst] = rs; s.re[dst] = re;
        s.gap[dst] = gap; s.act[dst] = act;
      }
      out += tot;
    }
    __syncthreads();
    if (threadIdx.x == 0) B.n = out;
    n = out;
  }
  if (n == 0 || any_active) {
    __syncthreads();
    return;
  }
  long long fam_rows = 0;
  for (int t0 = 0; t0 < n; t0 += T) {
    const int j = t0 + threadIdx.x;
    const bool em = j < n && s.re[j] - s.rs[j] >= a.min_dup;
    int tot;
    const int r = block_scan(em, wsum, &tot);
    if (tot == 0) continue;
    if (threadIdx.x == 0)
      B.slot = (long long)atomicAdd(a.n_rows, (unsigned long long)tot);
    __syncthreads();
    const long long g = B.slot + r;
    if (em && g < a.out_cap) {
      long long* row = a.rows + 6 * g;
      row[0] = ((long long)b << 32) | (B.rows + fam_rows + r);
      row[1] = s.ls[j];
      row[2] = s.rs[j];
      row[3] = s.le[j] - s.ls[j];
      row[4] = s.re[j] - s.rs[j];
      row[5] = B.fam;
    }
    fam_rows += tot;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    if (fam_rows) {
      B.rows += fam_rows;
      B.fam += 1;
    }
    B.n = 0;
  }
  __syncthreads();
}

// z quiet steps (fewer once no arm is left).
__device__ void quiet_run(const ChainArgs& a, const Arms& s, Burst& B,
                          int* wsum, int b, long long z) {
  for (long long q = 0; q < z; ++q) {
    const int n = B.n;
    if (n == 0) break;
    int any = 0;
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const long long g = s.gap[j] + a.step;
      s.gap[j] = g;
      if (g >= a.max_gap) s.act[j] = 0;
      any |= s.act[j];
    }
    const bool any_active = __syncthreads_or(any);
    prune_emit(a, s, B, wsum, b, any_active);
  }
}

// One event: classification, extensions, spawns, aging, prune, emission.
__device__ void match_step(const ChainArgs& a, const Arms& s, Burst& B,
                           int* wsum, long long* mt, int* first, int b,
                           long long e, long long& tests) {
  const int T = blockDim.x, A = a.arms_cap;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = T >> 5;
  const long long i = a.ev_i[e];
  const long long mb = a.m_off[e], me = a.m_off[e + 1];
  const int n0 = B.n;  // the snapshot's arms
  for (int j = threadIdx.x; j < n0; j += T) {
    s.last[j] = -1;
    s.allow[j] = 0;
    if (s.act[j]) {
      const long long fl = (long long)(0.1 * (double)(s.le[j] - s.ls[j]));
      s.allow[j] = a.max_gap > fl ? a.max_gap : fl;
    }
  }
  int spawned = 0;
  bool over = false;
  for (long long t0 = mb; t0 < me; t0 += T) {
    const int tn = (int)(me - t0 < T ? me - t0 : T);
    if (threadIdx.x < tn) {
      mt[threadIdx.x] = load_m(a, t0 + threadIdx.x);
      first[threadIdx.x] = n0;
    }
    __syncthreads();
    // warps per match: all warps share the tile's matches
    const int wpm = tn >= nw ? 1 : nw / tn;
    for (int q = w; q < tn * wpm; q += nw) {
      const int mi = q / wpm, sub = q % wpm;
      const long long m_s = mt[mi], m_e = m_s + a.ps;
      for (int base = sub * 32; base < n0; base += wpm * 32) {
        if (wpm > 1) {
          int f = 0;
          if (lane == 0) f = atomicAdd(first + mi, 0);
          if (__shfl_sync(kFull, f, 0) < base) break;  // a lower arm hit
        }
        const int j = base + lane;
        const bool hit = j < n0 && admissible(s, j, m_s, m_e);
        const unsigned mask = __ballot_sync(kFull, hit);
        if (mask) {
          if (lane == 0) atomicMin(first + mi, base + __ffs(mask) - 1);
          break;
        }
      }
    }
    __syncthreads();
    bool fresh = false;
    if (threadIdx.x < tn) {
      const int f = first[threadIdx.x];
      const int mi = (int)(t0 - mb) + threadIdx.x;
      fresh = f >= n0;
      tests += fresh ? n0 : f + 1;
      if (!fresh) atomicMax(s.last + f, mi);
    }
    int tot;
    const int slot = n0 + spawned + block_scan(fresh, wsum, &tot);
    if (fresh) {
      if (slot < A) {
        const long long m_s = mt[threadIdx.x];
        s.ls[slot] = i;
        s.le[slot] = i + a.ps;
        s.rs[slot] = m_s;
        s.re[slot] = m_s + a.ps;
        s.gap[slot] = 0;
        s.act[slot] = 1;
      }
    }
    spawned += tot;
    over = n0 + spawned > A;
    if (over) break;  // uniform: every thread holds the same totals
  }
  __syncthreads();  // the spawned arms are written before they age
  if (over) {
    if (threadIdx.x == 0) B.over = 1;
    __syncthreads();
    return;
  }
  const int n = n0 + spawned;
  int any = 0;
  for (int j = threadIdx.x; j < n; j += T) {
    const int l = j < n0 ? s.last[j] : -1;
    if (l >= 0) {  // extended by its last match: dirty, not aged
      s.le[j] = i + a.ps;
      s.re[j] = load_m(a, mb + l) + a.ps;
      s.gap[j] = 0;
    } else {
      const long long g = s.gap[j] + a.step;
      s.gap[j] = g;
      if (g >= a.max_gap) s.act[j] = 0;
    }
    any |= s.act[j];
  }
  if (threadIdx.x == 0) B.n = n;
  const bool any_active = __syncthreads_or(any);
  prune_emit(a, s, B, wsum, b, any_active);
}

__global__ void __launch_bounds__(kMaxThreads)
chain_bursts_kernel(ChainArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Burst B;
  __shared__ int wsum[32];
  __shared__ long long tsum;
  const int T = blockDim.x;
  long long* mt = (long long*)smem;
  int* first = (int*)(mt + T);
  unsigned char* arm_base =
      a.arms_global
          ? a.arms_global + (size_t)blockIdx.x * a.arms_cap * kArmBytes
          : (unsigned char*)(first + T);  // T * 12 bytes: 8-aligned
  const Arms s = arms_at(arm_base, a.arms_cap);
  for (;;) {
    if (threadIdx.x == 0) B.job = atomicAdd(a.next, 1);
    __syncthreads();
    const int job = B.job;
    if (job >= a.n_order) return;
    const int b = a.order[job];
    if (threadIdx.x == 0) {
      B.n = 0;
      B.over = 0;
      B.fam = 0;
      B.rows = 0;
    }
    __syncthreads();
    long long tests = 0;
    const long long e0 = a.burst_start[b], e1 = a.burst_start[b + 1];
    for (long long e = e0; e < e1; ++e) {
      if (e > e0) quiet_run(a, s, B, wsum, b, a.ev_z[e]);
      match_step(a, s, B, wsum, mt, first, b, e, tests);
      if (B.over) break;
    }
    const bool over = B.over;
    if (!over) {
      const long long zt = *a.z_trail;
      const long long tz =
          b == a.n_bursts - 1 && zt < a.t_split ? zt : a.t_split;
      quiet_run(a, s, B, wsum, b, tz);
    }
    // the burst's native test count
    for (int o = 16; o; o >>= 1) tests += __shfl_down_sync(kFull, tests, o);
    if (threadIdx.x == 0) tsum = 0;
    __syncthreads();
    if ((threadIdx.x & 31) == 0 && tests)
      atomicAdd((unsigned long long*)&tsum, (unsigned long long)tests);
    __syncthreads();
    if (threadIdx.x == 0) {
      a.status[b] = over ? 1 : 0;
      a.tests[b] = tsum;
    }
    __syncthreads();
  }
}

long long smem_bytes(int threads, int arms_cap, int arms_in_smem) {
  return (long long)threads * 12 + 8 +
         (arms_in_smem ? (long long)arms_cap * kArmBytes : 0);
}

}  // namespace

// Blocks of `threads` the card keeps resident at once for a launch with
// arms_cap arms (in shared memory or not); 0 when a block does not fit.
ASGART_API int asgart_chain_grid(int threads, int arms_cap, int arms_in_smem,
                                 void* blocks) {
  const long long sm = smem_bytes(threads, arms_cap, arms_in_smem);
  int dev = 0, n_sm = 0, per_sm = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  *(int*)blocks = 0;
  if (sm + (long long)sizeof(Burst) + 32 * 4 + 8 > limit)
    return (int)cudaGetLastError();
  cudaError_t rc = cudaFuncSetAttribute(
      chain_bursts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sm);
  if (rc != cudaSuccess) return (int)rc;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, chain_bursts_kernel, threads, (size_t)sm);
  if (rc != cudaSuccess) return (int)rc;
  *(int*)blocks = per_sm * n_sm;
  return (int)cudaGetLastError();
}

ASGART_API int asgart_chain_bursts(
    const void* ev_i, const void* ev_z, const void* m_off, const void* m,
    int m_is_i64, long long m_offset, const void* burst_start,
    const void* order, int n_order, int n_bursts, const void* z_trail,
    int t_split, long long ps, long long step, long long max_gap,
    long long min_dup, int arms_cap, void* rows, long long out_cap,
    void* n_rows, void* next, void* status, void* tests, void* arms_global,
    int blocks, int threads, void* stream) {
  ChainArgs a;
  a.ev_i = (const int*)ev_i;
  a.ev_z = (const int*)ev_z;
  a.m_off = (const long long*)m_off;
  a.m = m;
  a.m_is_i64 = m_is_i64;
  a.m_offset = m_offset;
  a.burst_start = (const long long*)burst_start;
  a.order = (const int*)order;
  a.n_order = n_order;
  a.n_bursts = n_bursts;
  a.z_trail = (const int*)z_trail;
  a.t_split = t_split;
  a.ps = ps;
  a.step = step;
  a.max_gap = max_gap;
  a.min_dup = min_dup;
  a.arms_cap = arms_cap;
  a.rows = (long long*)rows;
  a.out_cap = out_cap;
  a.n_rows = (unsigned long long*)n_rows;
  a.next = (int*)next;
  a.status = (int*)status;
  a.tests = (long long*)tests;
  a.arms_global = (unsigned char*)arms_global;
  const long long sm = smem_bytes(threads, arms_cap, arms_global == nullptr);
  cudaError_t rc = cudaFuncSetAttribute(
      chain_bursts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sm);
  if (rc != cudaSuccess) return (int)rc;
  chain_bursts_kernel<<<blocks, threads, (size_t)sm,
                        (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
