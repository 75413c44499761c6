// KE tie_keys and KF tie_refine: one round of prefix doubling on the tied
// subset of the fused index, around a library sort of the round keys; KK
// full_round_keys and KL full_round_refine: one round over every row of a
// table build, around the same sort.
//
// Replaces (JAX reference): asgart_tpu/device_index.py:696
// _doubling_rounds (one_round: the rank[p + h] gather, the (prim, sec)
// sort keys, the scatter into the ascending slots, the cummax of sub-run
// start slots and the still-tied flags), with :682 _slot_payload's
// gather, driven by :807 _resolve_ties.
//
// Entry i of the tied subset holds slot slots[i] (ascending), position
// ps[i] and the rank prims[i] of its group (the slot of the group start).
//   KE  key[i] = (prims[i] << 32) | (rank[ps[i] + h] + 1). A read past the
//       direct text (ps[i] + h >= W) cannot happen for a strand that ends
//       in a unique '$'; it sets *bad, which the caller reads with the
//       round's still-tied count, and reads rank[W - 1] instead (the
//       caller raises). The JAX package clamps the read silently.
//   (the caller sorts key stably: skey, order)
//   KF  per sorted entry r: p = ps[order[r]]; the sub-run start s of r in
//       skey; sa[slots[r]] = p, rank[p] = slots[s]; r is still tied when
//       its sub-run is longer than one. The still-tied entries' next
//       (slots[r], p, slots[s]) are written compacted, in r order (so
//       slots ascend, as the JAX stable partition keeps them), and their
//       count into *count: the whole tail of one_round in one launch.
//
// Bound on the H100: KE reads 12 B per entry in order plus one random
// 4-byte rank gather and writes 8 B; KF reads 8 B of keys and 8 B of
// order in order, gathers ps, scatters 4 B into sa (slots ascending, so
// nearly coalesced) and 4 B into rank (random), and writes 12 B a
// still-tied entry. Both are memory-bound with a random access per entry.
// The JAX cummax scan over sub-run starts is a cross-block dependency on
// a GPU; KF finds each entry's sub-run start by galloping back over the
// sorted keys (asgart::run_start), so entries deep in long runs (the
// repeat-dense case) pay O(log run) cached reads and nothing crosses
// blocks. Its compaction is a single-pass scan with decoupled look-back:
// a block takes the next tile of kRefTile entries in launch order (a
// counter), ranks its still-tied entries by warp ballots and __popc,
// publishes the tile's count, and its first warp sums the counts of the
// tiles before it, 32 at a time, back to the nearest tile whose
// inclusive prefix is out. A tile only waits on tiles that took their
// numbers before it, so the wait ends. Once the tie loop's set is a few
// thousand entries a round is launch-bound, and the JAX round's
// compaction (a cumsum, a where, three scatters and the count read) is
// this one launch.
//
// KK and KL replace asgart_tpu/device_index.py:769 _full_round, which the
// JAX package's _resolve_ties (:807) runs while the tied count exceeds
// tied_cap (the table build of a repeat-dense text; default n // 8), with
// the undecimated rank of the port's tables (dec_step = 0).
//
// Precondition (the position-order invariant): within each run of equal
// rank in the current order sa, the positions ascend. The table build's
// first sort is stable over keys made in position order, so it holds
// there; a round is a stable sort whose equal keys share a rank, so it
// holds after every round. Then the JAX round, a stable sort of (rank[p],
// flag, sec) in the current order, breaks every tie by position, which is
// what a stable sort of the same keys made in position order does: the
// sort's order is the new sa, and a round never reads sa.
//   KK  row q (a position): key[q] = (rank[q] << 32) | ((q >= direct_bound)
//       << 31) | (sec + 1), sec = rank[q + h] when q < n - h, else -1
//       (past the text, the JAX clamp). rank < 2^31 and sec + 1 < 2^31, so
//       the 63-bit key orders as the JAX (prim, flag, sec) sort keys.
//   (the caller sorts key stably: skey, order; order is the new sa)
//   KL  per sorted row r: p = order[r]; new_sa[r] = p; the run start s of r
//       in skey; rank[p] = s (a permutation scatter: every position is
//       written once); tied[r] = the run is longer than one and p is direct
//       (p < direct_bound).
// Bound on the H100: KK reads rank and writes the key, 12 B a row, both in
// order (rank[q + h] is the same stream h rows on, from L2 at the rounds'
// small h); each thread takes kKeyRows consecutive rows with 16-byte loads
// and stores (scalar loads where the shifted read is not 16-byte aligned,
// still coalesced across the warp), no gather. KL reads 16 B per row in
// order, scatters 4 B of rank and writes 5 B. Run starts by galloping back
// (asgart::run_start), as KF finds them. KL's random store, one DRAM sector
// a row into a plane larger than the L2, is most of its time, so KL is two
// steps (kernels/ties.py): here its in-order pass, which writes new_sa, the
// run start s[r] and tied[r], all coalesced; then rank[new_sa] = s through
// KC's partitioned scatter with no lanes (csrc/invert.cu,
// asgart_invert_fused with M = W = n), whose random stores all land in
// shared memory.
#include "common.cuh"

namespace {

__global__ void tie_keys_kernel(const int* __restrict__ ps,
                                const int* __restrict__ prims,
                                const int* __restrict__ rank, long long n,
                                long long W, long long h,
                                long long* __restrict__ key,
                                int* __restrict__ bad) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    long long ph = (long long)ps[i] + h;
    if (ph >= W) {
      *bad = 1;
      ph = W - 1;
    }
    key[i] = ((long long)prims[i] << 32) | ((long long)__ldg(rank + ph) + 1);
  }
}

constexpr unsigned kFull = 0xFFFFFFFFu;
// KF: one entry a thread, a tile a block. An entry's work is a chain of
// dependent loads (order, ps, the gallop back, slots), so a thread takes
// one: with four, a late round's few dozen blocks ran four chains one
// after another, 0.019 ms a round on an H100 against the unfused
// kernel's 0.007.
constexpr int kRefTile = 256;
constexpr int kRefWarps = kRefTile / 32;
// a tile's status word: its count in the low 32 bits, above them what the
// count is (0: nothing yet, 1: the tile's own, 2: through this tile)
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// scratch: [0] the tile counter, then n_tiles status words; zeroed before
// the launch
__global__ void __launch_bounds__(kRefTile)
tie_refine_kernel(const long long* __restrict__ skey,
                  const long long* __restrict__ order,
                  const int* __restrict__ slots, const int* __restrict__ ps,
                  long long n, int* __restrict__ sa, int* __restrict__ rank,
                  int* __restrict__ out_slots, int* __restrict__ out_ps,
                  int* __restrict__ out_prims, int* __restrict__ count,
                  unsigned long long* __restrict__ scratch, int n_tiles) {
  __shared__ int s_tile;
  __shared__ int s_off[kRefWarps];
  __shared__ long long s_base;
  const int ln = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = (int)atomicAdd(scratch, 1ull);
  __syncthreads();
  const int tile = s_tile;
  unsigned long long* status = scratch + 1;
  const long long r = (long long)tile * kRefTile + threadIdx.x;
  int sl = 0, p = 0, rs = 0;
  bool still = false;
  if (r < n) {
    // the in-order loads first, together
    const long long v = skey[r];
    const long long o = order[r];
    const bool next = r + 1 < n && __ldg(skey + r + 1) == v;
    sl = __ldg(slots + r);
    p = __ldg(ps + o);
    const long long s = asgart::run_start(
        r, [&](long long i) { return __ldg(skey + i) == v; });
    rs = s == r ? sl : __ldg(slots + s);
    sa[sl] = p;
    rank[p] = rs;
    still = s < r || next;
  }
  const unsigned b = __ballot_sync(kFull, still);
  const int at = __popc(b & ((1u << ln) - 1u));
  if (ln == 0) s_off[w] = __popc(b);
  __syncthreads();
  if (w == 0) {
    // the warps' counts, scanned in entry order
    const int c = ln < kRefWarps ? s_off[ln] : 0;
    int x = c;
#pragma unroll
    for (int o = 1; o < kRefWarps; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (ln >= o) x += y;
    }
    if (ln < kRefWarps) s_off[ln] = x - c;
    const int agg = __shfl_sync(kFull, x, kRefWarps - 1);
    long long base = 0;
    if (tile == 0) {
      if (ln == 0) atomicExch(status, kInclusive | (unsigned)agg);
    } else {
      if (ln == 0) atomicExch(status + tile, kAggregate | (unsigned)agg);
      for (int look = tile - 1;;) {
        const int t = look - ln;
        unsigned long long st = kInclusive;  // before tile 0: nothing
        do {
          if (t >= 0) st = load_status(status + t);
        } while (__any_sync(kFull, (st >> 32) == 0));
        const unsigned inc = __ballot_sync(kFull, (st >> 32) == 2);
        const int first = inc ? __ffs(inc) - 1 : 32;
        long long v = ln <= first ? (long long)(st & 0xFFFFFFFFu) : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
        base += __shfl_sync(kFull, v, 0);
        if (inc) break;
        look -= 32;
      }
      if (ln == 0) {
        atomicExch(status + tile,
                   kInclusive | (unsigned)(base + agg));
      }
    }
    if (ln == 0) {
      s_base = base;
      if (tile == n_tiles - 1) *count = (int)(base + agg);
    }
  }
  __syncthreads();
  if (still) {
    const long long o = s_base + s_off[w] + at;
    out_slots[o] = sl;
    out_ps[o] = p;
    out_prims[o] = rs;
  }
}

constexpr int kKeyRows = 4;  // KK's rows a thread: one 16-byte rank load

__device__ __forceinline__ long long round_key(int prim, int sec, long long q,
                                               long long direct_bound) {
  return ((long long)prim << 32) | ((long long)(q >= direct_bound) << 31) |
         ((long long)sec + 1);
}

// kVec: rank and key 16-byte aligned (else scalar loads and stores)
template <bool kVec>
__global__ void full_round_keys_kernel(const int* __restrict__ rank,
                                       long long n, long long h,
                                       long long direct_bound,
                                       long long* __restrict__ key) {
  constexpr int R = kKeyRows;
  const long long inside = n - h;  // rows with a rank h rows on
  const bool shift_vec = kVec && (h % R) == 0;
  for (long long q0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * R;
       q0 < n; q0 += (long long)gridDim.x * blockDim.x * R) {
    int prim[R], sec[R];
    if (kVec && q0 + R <= n) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(rank + q0));
      prim[0] = a.x;
      prim[1] = a.y;
      prim[2] = a.z;
      prim[3] = a.w;
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        prim[j] = q0 + j < n ? __ldg(rank + q0 + j) : 0;
      }
    }
    if (shift_vec && q0 + R <= inside) {
      const int4 b = __ldg(reinterpret_cast<const int4*>(rank + q0 + h));
      sec[0] = b.x;
      sec[1] = b.y;
      sec[2] = b.z;
      sec[3] = b.w;
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        sec[j] = q0 + j < inside ? __ldg(rank + q0 + j + h) : -1;
      }
    }
    if (kVec && q0 + R <= n) {
      longlong2* out = reinterpret_cast<longlong2*>(key + q0);
      out[0] = make_longlong2(round_key(prim[0], sec[0], q0, direct_bound),
                              round_key(prim[1], sec[1], q0 + 1,
                                        direct_bound));
      out[1] = make_longlong2(round_key(prim[2], sec[2], q0 + 2,
                                        direct_bound),
                              round_key(prim[3], sec[3], q0 + 3,
                                        direct_bound));
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (q0 + j < n) {
          key[q0 + j] = round_key(prim[j], sec[j], q0 + j, direct_bound);
        }
      }
    }
  }
}

__global__ void full_round_refine_kernel(const long long* __restrict__ skey,
                                         const long long* __restrict__ order,
                                         long long n, long long direct_bound,
                                         int* __restrict__ new_sa,
                                         int* __restrict__ run_start,
                                         uint8_t* __restrict__ tied) {
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < n; r += (long long)gridDim.x * blockDim.x) {
    const long long v = skey[r];
    const long long p = order[r];
    const long long s = asgart::run_start(
        r, [&](long long j) { return __ldg(skey + j) == v; });
    new_sa[r] = (int)p;
    run_start[r] = (int)s;
    tied[r] = (s < r || (r + 1 < n && __ldg(skey + r + 1) == v)) &&
              p < direct_bound;
  }
}

}  // namespace

ASGART_API int asgart_tie_keys(const void* ps, const void* prims,
                               const void* rank, long long n, long long W,
                               long long h, void* key, void* bad,
                               void* stream) {
  tie_keys_kernel<<<asgart::grid_for(n), asgart::kThreads, 0,
                    (cudaStream_t)stream>>>(
      (const int*)ps, (const int*)prims, (const int*)rank, n, W, h,
      (long long*)key, (int*)bad);
  return (int)cudaGetLastError();
}

// KF: outputs int32 [n] each (their first *count entries written);
// scratch: n_tiles + 1 words (kernels/ties.py TIE_TILE entries a tile).
ASGART_API int asgart_tie_refine(const void* skey, const void* order,
                                 const void* slots, const void* ps,
                                 long long n, void* sa, void* rank,
                                 void* out_slots, void* out_ps,
                                 void* out_prims, void* count, void* scratch,
                                 int n_tiles, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || n_tiles != (n + kRefTile - 1) / kRefTile) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t rc = cudaMemsetAsync(
      scratch, 0, sizeof(unsigned long long) * (n_tiles + 1), s);
  if (rc != cudaSuccess) return (int)rc;
  tie_refine_kernel<<<(unsigned)n_tiles, kRefTile, 0, s>>>(
      (const long long*)skey, (const long long*)order, (const int*)slots,
      (const int*)ps, n, (int*)sa, (int*)rank, (int*)out_slots, (int*)out_ps,
      (int*)out_prims, (int*)count, (unsigned long long*)scratch, n_tiles);
  return (int)cudaGetLastError();
}

// rank: int32 [n]; key: int64 [n]; 0 <= h <= n.
ASGART_API int asgart_full_round_keys(const void* rank, long long n,
                                      long long h, long long direct_bound,
                                      void* key, void* stream) {
  const bool vec = (((uintptr_t)rank | (uintptr_t)key) & 15) == 0;
  auto kernel = vec ? full_round_keys_kernel<true>
                    : full_round_keys_kernel<false>;
  kernel<<<asgart::grid_for((n + kKeyRows - 1) / kKeyRows), asgart::kThreads,
           0, (cudaStream_t)stream>>>((const int*)rank, n, h, direct_bound,
                                      (long long*)key);
  return (int)cudaGetLastError();
}

// KL's in-order pass (its scatter is KC's: kernels/ties.py).
ASGART_API int asgart_full_round_refine(const void* skey, const void* order,
                                        long long n, long long direct_bound,
                                        void* new_sa, void* run_start,
                                        void* tied, void* stream) {
  full_round_refine_kernel<<<asgart::grid_for(n), asgart::kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const long long*)skey, (const long long*)order, n, direct_bound,
      (int*)new_sa, (int*)run_start, (uint8_t*)tied);
  return (int)cudaGetLastError();
}
