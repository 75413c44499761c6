// KE tie_keys and KF tie_refine: one round of prefix doubling on the tied
// subset of the fused index, KE sorting each tied group of the round
// itself; KK full_round_keys and KL full_round_refine: one round over every
// row of a table build, around a library sort.
//
// Replaces (JAX reference): asgart_tpu/device_index.py:696
// _doubling_rounds (one_round: the rank[p + h] gather, the (prim, sec)
// sort of :728, the scatter into the ascending slots, the cummax of sub-run
// start slots and the still-tied flags), with :682 _slot_payload's
// gather, driven by :807 _resolve_ties.
//
// Entry i of the tied subset holds slot slots[i] (ascending), position
// ps[i] and the rank prims[i] of its group (the slot of the group start):
// prims never decreases, and a group (a run of equal prims) has at least
// two entries (tied means a sub-run longer than one).
//   KE  the round's keys key[i] = (prims[i] << 32) | (sec[i] + 1), sec[i] =
//       rank[ps[i] + h], and their stable sort (skey, order): what
//       torch.sort(key, stable=True) gives. Since prims ascends, that sort
//       is a stable sort by sec within each group. A read past the direct
//       text (ps[i] + h >= W) cannot happen for a strand that ends in a
//       unique '$'; it ORs 1 into *bad, which the caller reads with the
//       round's still-tied count, and reads rank[W - 1] instead (the
//       caller raises). The JAX package clamps the read silently.
//       Two entry points: asgart_tie_sort (the keys sorted here) and
//       asgart_tie_keys, the key pass alone, which the caller follows with
//       torch.sort: its route for a round whose largest group passes
//       kernels/ties.py TIE_SORT_CAP (128, below), or whose largest group
//       is not known. The choice is made by size before the launch: before
//       the first round from KE's sizing pass (asgart_tie_groups), where
//       the tied set is large enough to pay for its host read (ties.py
//       SIZING_MIN), and after each round from KF's figure.
//   KF  per sorted entry r: p = ps[order[r]]; the sub-run start s of r in
//       skey; sa[slots[r]] = p, rank[p] = slots[s]; r is still tied when
//       its sub-run is longer than one. The still-tied entries' next
//       (slots[r], p, slots[s]) are written compacted, in r order (so
//       slots ascend, as the JAX stable partition keeps them), their count
//       into *count and the longest still-tied sub-run (the next round's
//       largest group) into *largest: the whole tail of one_round in one
//       launch.
//
// KE's sort (asgart_tie_sort). A block of kSortThreads takes a tile of
//   kSortTile entries and sorts the groups that start in it, also where a
//   group runs past the tile's end; each warp takes kSub entries of the
//   tile and the groups that start there. A window of 32 entries from a
//   group start, one a lane: group edges from the neighbours' prims
//   (shuffles), ends by ballot; the window's complete groups (at most 32
//   entries each) are sorted together in registers by the unique key
//   (group start lane, sec, lane): an odd-even transposition sort of g
//   steps where the largest of them has g < 15 entries (a run of g sorts
//   by then, and no step moves an entry across a group edge), else a
//   bitonic network of 15 steps over the 32 lanes. The lane in the key
//   makes it the stable order. The next window starts after the last
//   complete group, so every entry is gathered once. A group with no end
//   in its window: the warp finds its end (32 probes a step) and sorts it
//   itself in registers (keys (sec << 8) | entry, 2 or 4 a lane, the
//   bitonic network across lanes and registers), up to kRegGroup (128)
//   entries: the capacity (kernels/ties.py TIE_SORT_CAP). A round whose
//   largest group passes it takes the library route. Longer groups were
//   tried on an H100: a warp's radix sort of one group of 512 random secs
//   took 0.025 ms against the library route's 0.038 (of 1,000, 0.045
//   against 0.039), but no round measured holds a group of 129 to 512
//   entries (a repeat-dense text's largest are 87 and 43, a 30 kb N run's
//   9,521 to 29,981), so it is not built; a block a longer group (its
//   radix sort over tiles of 4,096 entries) spent 5 cycles or more an
//   entry a phase on one SM, 0.11-0.25 ms a round on the N run's group
//   against the library's 0.085 on the whole card, so such rounds stay
//   with the library. A longer group that reaches the kernel all the same
//   is written unsorted (order[i] = i and the entry's own key, so that KF
//   reads in range) and ORs 2 into *bad, on which the caller raises.
// Bound on the H100: KE reads 8 B per entry in order (ps, prims) plus one
// random 4-byte rank gather and writes 16 B (skey and order; its key pass
// 8 B of keys); its sort adds no device-memory traffic (every group it
// takes sorts in registers). KF reads 8 B of keys and 8 B
// of order in order, gathers ps, scatters 4 B into sa (slots ascending, so
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
// this one launch. The longest still-tied sub-run comes from each
// sub-run's last entry, which knows its start from the gallop: a tile's
// maximum travels in its status word beside its count, and the look-back
// carries the running maximum as it carries the sum, so the last tile
// writes it with the count (no atomic on one address, no memset).
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

// KE's sort: a block's warps and its tile, a warp's entries of the tile
constexpr int kSortThreads = 256;
constexpr int kTileWarps = kSortThreads / 32;
constexpr int kSub = 32;
constexpr int kSortTile = kTileWarps * kSub;
// a group of more than 32 entries is sorted by the warp that finds it in
// registers (2 or 4 a lane), up to kRegGroup entries: the capacity
// (kernels/ties.py TIE_SORT_CAP)
constexpr int kRegGroup = 128;
// a window whose largest group has fewer entries takes the transposition
// sort (that many steps), else the bitonic network (15 steps)
constexpr int kOets = 15;

// rank[p + h]; past the direct text, 1 ORed into *bad and rank[W - 1]
__device__ __forceinline__ int gather_sec(const int* __restrict__ rank,
                                          int p, long long W, long long h,
                                          int* __restrict__ bad) {
  long long ph = (long long)p + h;
  if (ph >= W) {
    atomicOr(bad, 1);
    ph = W - 1;
  }
  return __ldg(rank + ph);
}

// One compare-exchange step across the warp: this lane keeps the smaller
// key where `lower`, else the larger, of its key and `partner`'s.
__device__ __forceinline__ unsigned long long exchange(unsigned long long key,
                                                       int partner,
                                                       bool lower) {
  const unsigned long long o = __shfl_sync(kFull, key, partner & 31);
  if (partner < 0 || partner > 31) return key;
  return lower ? (o < key ? o : key) : (o > key ? o : key);
}

// *at = max(*at, v) from lane 0 of a warp, an atomic only where v passes
// the value already there: one address takes every warp's figure, and
// most see one as large already
__device__ __forceinline__ void raise_to(int* at, int v, int ln) {
  if (ln == 0 && v > *reinterpret_cast<volatile int*>(at)) atomicMax(at, v);
}

// One past the last entry of the group that holds [pos, pos + 32) (all 32
// entries in it), found by the warp: 32 probes a step, a step 32 times the
// last until one leaves the group, then 32 times narrower to the edge.
__device__ __forceinline__ long long group_end(const int* __restrict__ prims,
                                               long long n, long long pos,
                                               int prim, int ln) {
  long long lo = pos + 31, hi, step = 1;  // lo in the group, hi past it
  for (;;) {
    const long long q = lo + step * (ln + 1);
    const unsigned b =
        __ballot_sync(kFull, q >= n || __ldg(prims + q) != prim);
    if (b) {
      const int f = __ffs(b) - 1;
      hi = lo + step * (f + 1);
      lo += step * f;
      break;
    }
    lo += 32 * step;
    step *= 32;
  }
  if (hi > n) hi = n;
  while (hi - lo > 1) {
    step = (hi - lo + 31) / 32;  // lane 31 probes at or past hi
    const long long q = lo + step * (ln + 1);
    const unsigned b =
        __ballot_sync(kFull, q >= hi || __ldg(prims + q) != prim);
    const int f = __ffs(b) - 1;
    const long long top = lo + step * (f + 1);
    lo += step * f;
    hi = top < hi ? top : hi;
  }
  return hi;
}

// The warp's sort of a group of 32 < s <= 32 * E entries in registers:
// entry e = r * 32 + lane in key[r] = (sec << 8) | e, the bitonic network
// over the 32 * E keys (steps across lanes by shuffles, across registers
// within the lane), then (skey, order) written in order.
template <int E>
__device__ void sort_group_regs(const int* __restrict__ ps,
                                const int* __restrict__ rank, long long g0,
                                int s, int prim, long long W, long long h,
                                long long* skey, long long* order,
                                int* __restrict__ bad) {
  const int ln = threadIdx.x & 31;
  unsigned long long key[E];
  int p[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    p[r] = r * 32 + ln < s ? __ldg(ps + g0 + r * 32 + ln) : 0;
  }
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int e = r * 32 + ln;
    key[r] = e < s ? ((unsigned long long)(unsigned)gather_sec(
                          rank, p[r], W, h, bad) << 8) | (unsigned)e
                   : ~0ull;
  }
#pragma unroll
  for (int k = 2; k <= 32 * E; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int r = 0; r < E; ++r) {
        const int e = r * 32 + ln;
        const bool asc = (e & k) == 0;
        if (j >= 32) {  // the partner is register r ^ (j / 32)
          const int rp = r ^ (j >> 5);
          if (rp > r) {
            const unsigned long long a = key[r], b = key[rp];
            if (asc ? a > b : a < b) {
              key[r] = b;
              key[rp] = a;
            }
          }
        } else {
          key[r] = exchange(key[r], ln ^ j, ((e & j) == 0) == asc);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int e = r * 32 + ln;
    if (e < s) {
      skey[g0 + e] = ((long long)prim << 32) | (long long)((key[r] >> 8) + 1);
      order[g0 + e] = g0 + (long long)(key[r] & 255u);
    }
  }
}

// A tile of kSortTile entries a block, kSub a warp. The caller routes a
// round whose largest group passes kRegGroup to the library; a longer
// group that comes here all the same is written unsorted, in range, and
// ORs 2 into *bad.
__global__ void __launch_bounds__(kSortThreads, 4)
tie_sort_kernel(const int* __restrict__ ps, const int* __restrict__ prims,
                const int* __restrict__ rank, long long n, long long W,
                long long h, long long* skey, long long* order,
                int* __restrict__ bad) {
  const int ln = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long sub_lo = (long long)blockIdx.x * kSortTile + w * kSub;
  const long long sub_hi = sub_lo + kSub < n ? sub_lo + kSub : n;
  long long pos = -1;  // the first group start in the warp's entries
  for (long long x = sub_lo; x < sub_hi; x += 32) {
    const long long i = x + ln;
    const bool st = i < sub_hi && (i == 0 || __ldg(prims + i) !=
                                                  __ldg(prims + i - 1));
    const unsigned b = __ballot_sync(kFull, st);
    if (b) {
      pos = x + __ffs(b) - 1;
      break;
    }
  }
  while (pos >= 0 && pos < sub_hi) {
    const long long i = pos + ln;
    const bool valid = i < n;
    const int prim = valid ? __ldg(prims + i) : 0;
    const int p = valid ? __ldg(ps + i) : 0;
    int nxt = __shfl_down_sync(kFull, prim, 1);
    if (ln == 31 && i + 1 < n) nxt = __ldg(prims + i + 1);
    const int prv = __shfl_up_sync(kFull, prim, 1);
    const bool end = valid && (i + 1 >= n || nxt != prim);
    const bool own_start = valid && i < sub_hi && (ln == 0 || prv != prim);
    const unsigned E = __ballot_sync(kFull, end);
    const unsigned S = __ballot_sync(kFull, own_start);  // bit 0 is set
    const int last = 31 - __clz(S);  // the window's last group of this warp
    const unsigned after = E & (kFull << last);
    const int m = after ? __ffs(after) : last;  // the complete groups' lanes
    if (m == 0) {  // the group at pos passes the window
      const int prim0 = __shfl_sync(kFull, prim, 0);
      const long long e = group_end(prims, n, pos, prim0, ln);
      if (e - pos <= kRegGroup / 2) {
        sort_group_regs<kRegGroup / 64>(ps, rank, pos, (int)(e - pos), prim0,
                                        W, h, skey, order, bad);
      } else if (e - pos <= kRegGroup) {
        sort_group_regs<kRegGroup / 32>(ps, rank, pos, (int)(e - pos), prim0,
                                        W, h, skey, order, bad);
      } else {  // past the capacity: the caller's route was wrong
        for (long long r = pos + ln; r < e; r += 32) {
          skey[r] = ((long long)prim0 << 32) |
                    ((long long)gather_sec(rank, __ldg(ps + r), W, h, bad) +
                     1);
          order[r] = r;
        }
        if (ln == 0) atomicOr(bad, 2);
      }
      pos = e;
      continue;
    }
    const bool in = ln < m;
    const int sec = in ? gather_sec(rank, p, W, h, bad) : 0;
    const int start = 31 - __clz(S & (kFull >> (31 - ln)));
    const int size = in ? __ffs(E & (kFull << ln)) - start : 0;
    const int g = (int)__reduce_max_sync(kFull, (unsigned)size);
    unsigned long long key =
        in ? ((unsigned long long)start << 36) |
                 ((unsigned long long)(unsigned)sec << 5) | (unsigned)ln
           : ~0ull;
    if (g < kOets) {
      for (int q = 0; q < g; ++q) {
        const bool lower = ((ln - q) & 1) == 0;
        key = exchange(key, lower ? ln + 1 : ln - 1, lower);
      }
    } else {
#pragma unroll
      for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
        for (int j = k >> 1; j > 0; j >>= 1) {
          key = exchange(key, ln ^ j, ((ln & j) == 0) == ((ln & k) == 0));
        }
      }
    }
    if (in) {
      const int sorted_sec = (int)((key >> 5) & 0x7FFFFFFFull);
      skey[i] = ((long long)prim << 32) | ((long long)sorted_sec + 1);
      order[i] = pos + (long long)(key & 31ull);
    }
    pos += m;
  }
}

// KE's sizing pass: the longest run of equal prims (the round's largest
// group) from each run's last entry, which gallops back to its start; a
// thread's maximum over its rows, then the block's, and an atomicMax where
// it passes *largest (zeroed before).
__global__ void tie_groups_kernel(const int* __restrict__ prims, long long n,
                                  int* __restrict__ largest) {
  int len = 0;  // this thread's longest run, over its rows
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int v = __ldg(prims + i);
    if (i + 1 >= n || __ldg(prims + i + 1) != v) {
      const long long s = asgart::run_start(
          i, [&](long long j) { return __ldg(prims + j) == v; });
      len = max(len, (int)(i - s + 1));
    }
  }
  __shared__ int s_len[asgart::kThreads / 32];
  const int ln = threadIdx.x & 31, w = threadIdx.x >> 5;
  len = (int)__reduce_max_sync(kFull, (unsigned)len);
  if (ln == 0) s_len[w] = len;
  __syncthreads();
  if (w == 0) {  // the block's, one read a block
    raise_to(largest,
             (int)__reduce_max_sync(kFull, ln < asgart::kThreads / 32
                                               ? (unsigned)s_len[ln]
                                               : 0u),
             ln);
  }
}

// KF: one entry a thread, a tile a block. An entry's work is a chain of
// dependent loads (order, ps, the gallop back, slots), so a thread takes
// one: with four, a late round's few dozen blocks ran four chains one
// after another, 0.019 ms a round on an H100 against the unfused
// kernel's 0.007.
constexpr int kRefTile = 256;
constexpr int kRefWarps = kRefTile / 32;
// a tile's status word: its count in the low 32 bits, above them what the
// count is (0: nothing yet, 1: the tile's own, 2: through this tile), and
// from bit 34 the longest still-tied sub-run that ends in the tile (its
// own) or in any tile through it, saturated at kLongMax
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;
constexpr int kLongShift = 34;
constexpr unsigned kLongMax = (1u << 30) - 1u;

__device__ __forceinline__ unsigned long long status_word(
    unsigned long long kind, unsigned count, unsigned longest) {
  return kind | count |
         ((unsigned long long)min(longest, kLongMax) << kLongShift);
}

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
                  int* __restrict__ largest,
                  unsigned long long* __restrict__ scratch, int n_tiles) {
  __shared__ int s_tile;
  __shared__ int s_off[kRefWarps];
  __shared__ int s_long[kRefWarps];  // the warps' longest still-tied runs
  __shared__ long long s_base;
  const int ln = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = (int)atomicAdd(scratch, 1ull);
  __syncthreads();
  const int tile = s_tile;
  unsigned long long* status = scratch + 1;
  const long long r = (long long)tile * kRefTile + threadIdx.x;
  int sl = 0, p = 0, rs = 0, run_len = 0;
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
    if (s < r && !next) run_len = (int)(r - s + 1);  // a sub-run's last
  }
  const int longest = (int)__reduce_max_sync(kFull, (unsigned)run_len);
  const unsigned b = __ballot_sync(kFull, still);
  const int at = __popc(b & ((1u << ln) - 1u));
  if (ln == 0) {
    s_off[w] = __popc(b);
    s_long[w] = longest;
  }
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
    // the tile's longest still-tied sub-run, then through the tile
    unsigned run = __reduce_max_sync(
        kFull, ln < kRefWarps ? (unsigned)s_long[ln] : 0u);
    long long base = 0;
    if (tile == 0) {
      if (ln == 0) atomicExch(status, status_word(kInclusive, agg, run));
    } else {
      if (ln == 0) {
        atomicExch(status + tile, status_word(kAggregate, agg, run));
      }
      for (int look = tile - 1;;) {
        const int t = look - ln;
        unsigned long long st = kInclusive;  // before tile 0: nothing
        do {
          if (t >= 0) st = load_status(status + t);
        } while (__any_sync(kFull, ((st >> 32) & 3) == 0));
        const unsigned inc = __ballot_sync(kFull, ((st >> 32) & 3) == 2);
        const int first = inc ? __ffs(inc) - 1 : 32;
        long long v = ln <= first ? (long long)(st & 0xFFFFFFFFu) : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
        base += __shfl_sync(kFull, v, 0);
        run = max(run, __reduce_max_sync(
                           kFull, ln <= first ? (unsigned)(st >> kLongShift)
                                              : 0u));
        if (inc) break;
        look -= 32;
      }
      if (ln == 0) {
        atomicExch(status + tile,
                   status_word(kInclusive, (unsigned)(base + agg), run));
      }
    }
    if (ln == 0) {
      s_base = base;
      if (tile == n_tiles - 1) {
        *count = (int)(base + agg);
        *largest = (int)run;
      }
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

// KE's sizing pass: largest int32 [1], the longest run of equal prims.
ASGART_API int asgart_tie_groups(const void* prims, long long n,
                                 void* largest, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t rc = cudaMemsetAsync(largest, 0, sizeof(int), s);
  if (rc != cudaSuccess) return (int)rc;
  if (n <= 0) return (int)cudaGetLastError();
  tie_groups_kernel<<<asgart::grid_for(n), asgart::kThreads, 0, s>>>(
      (const int*)prims, n, (int*)largest);
  return (int)cudaGetLastError();
}

// KE's sort: skey, order int64 [n] (what torch.sort of the round's keys
// gives); prims non-decreasing, no group longer than kRegGroup.
ASGART_API int asgart_tie_sort(const void* ps, const void* prims,
                               const void* rank, long long n, long long W,
                               long long h, void* skey, void* order,
                               void* bad, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  tie_sort_kernel<<<(unsigned)((n + kSortTile - 1) / kSortTile),
                    kSortThreads, 0, (cudaStream_t)stream>>>(
      (const int*)ps, (const int*)prims, (const int*)rank, n, W, h,
      (long long*)skey, (long long*)order, (int*)bad);
  return (int)cudaGetLastError();
}

// KF: outputs int32 [n] each (their first *count entries written); largest
// gets the longest still-tied sub-run, 0 if none;
// scratch: n_tiles + 1 words (kernels/ties.py TIE_TILE entries a tile).
ASGART_API int asgart_tie_refine(const void* skey, const void* order,
                                 const void* slots, const void* ps,
                                 long long n, void* sa, void* rank,
                                 void* out_slots, void* out_ps,
                                 void* out_prims, void* count, void* largest,
                                 void* scratch, int n_tiles, void* stream) {
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
      (int*)out_prims, (int*)count, (int*)largest,
      (unsigned long long*)scratch, n_tiles);
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
