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
// once no arm is left); every match classified against the pre-step
// snapshot (the first active arm in arm order with d_ss < allow and m_end >
// r_end); extensions, the last match winning r_end; spawns in match order,
// appended; aging of every arm not extended; the prune; the emission. After
// the last event, the trailing quiet run: t_split steps, or min(z_trail,
// t_split) for the last burst.
//
// Bound on the H100: a burst is a sequential automaton, so the longest
// burst's events x the latency of one event step set the time; the bytes
// (events and matches read once) and the (match, arm) tests over the ALU
// rate are far below it. The design cuts that latency:
//
// - Aging is implicit. Steps (event steps and quiet steps) are counted; an
//   arm keeps the step `x` after which it is dead (extended at step s: s +
//   D, spawned at step s: s - 1 + D, D = max(1, ceil(max_gap / step)), the
//   steps an arm outlives its last extension), so an arm is active at the
//   snapshot before step s + 1 while s < x, and nothing is written when it
//   ages. `X`, the largest x since the last emission, says when the last
//   active arm dies: no reduction over the arms.
// - Classification with one test: an arm's right end is at least a probe
//   long, so m_end > r_end leaves d_ss = max(m_start - r_end, 0), and the
//   match is admissible while r_end - ps < m_start < r_end + allow: one
//   unsigned comparison against the arm's width w = allow + ps - 1 (allow
//   from its left length, when that changes; a spawned arm's is a
//   constant).
// - Quiet runs in closed form: with at most 200 arms nothing happens but
//   the emission at step X, when X falls in the run; above 200 arms the
//   prune fires at every step while more than 200 arms are left, so a
//   histogram of the short arms' deaths over the run's steps (32 at a
//   time) gives the last step it fires, and one compaction removes every
//   short arm dead by then, as the native's steps would.
// - A warp per burst. Every burst starts on a warp of its own, its arms in
//   registers (kWarpSlots a lane, kWarpArms in all), with ballots and
//   shuffles and no barrier at all (a kernel of its own, so that no
//   block-path state takes its registers). A burst whose arms pass the
//   warp's budget (`warp_arms`, at most kWarpArms) is handed over to the
//   block path through a queue in global memory: the block path's kernel,
//   launched next on the same stream, reruns it from its first event and
//   writes only the rows the warp did not, so its rows, families and test
//   count are those of one block.
// - The block path (bursts with more arms): arms in shared memory (or in a
//   per-block slice of global scratch when arms_cap does not fit). An
//   event's matches are ranked by position (each thread counts the
//   matches below its own), and each live arm finds by bisection the
//   matches inside its window and offers them its index (atomicMin): the
//   work is the arms x log(matches), not the arms x matches of the
//   native's walk. Barriers an event: after the ranking, after the
//   offers, and at the step's end; one more to collect extensions where a
//   tile holds more than 64 matches (else each match's thread finds
//   whether it is its arm's last), two more for a prune (a stable
//   in-place compaction of kQ arms a thread) or an emission. An event
//   with at most 32 arms and 32 matches runs on warp 0 alone, with one
//   barrier (solo).
// - Events stream in ahead, and nothing reads a load's register before
//   it is needed (a select or an add on it would wait for the load): each
//   warp path warp holds three batches of 32 events a lane (probe index,
//   quiet count, match offset, and the first match as stored), moved up
//   every 32 events, which is all a sparse event needs; on the block path
//   the last warp loads each event's record (probe index, quiet count,
//   match offsets) an event ahead into shared memory, and every thread
//   its match of the first tile two events ahead.
//
// Output rows (key = burst << 32 | row within the burst, l, r, l_len,
// r_len, family within the burst) go to a global buffer through an atomic
// counter that keeps counting past its capacity; the caller sorts them by
// key and reruns with the exact count when they did not fit. A burst whose
// arms pass arms_cap stops and reports status 1 (the caller reruns it with
// 2 arms_cap). Each burst also reports the (match, arm) tests the native
// walk makes on it (for the bound).
#include <climits>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPruneAbove = 200;  // automaton.rs:173
constexpr int kMaxThreads = 512;  // kernels/chain.py THREADS at most
constexpr int kWarpThreads = 256;  // the warp path's blocks
constexpr int kWarpSlots = 2;  // arms a lane holds on the warp path
constexpr int kWarpArms = 32 * kWarpSlots;  // kernels/chain.py WARP_ARMS
constexpr int kQ = 2;       // arms a thread holds in a compaction round
constexpr int kWindow = 32; // quiet steps a prune histogram covers
static_assert(kWarpArms <= kPruneAbove, "the warp path never prunes");

#ifdef KN_PHASES
// a burst's SM cycles by phase and its counts (scripts/kn_probe.py
// PHASES): classification's barrier and results, spawns, the step's end,
// quiet runs; quiet runs that did work, compactions; the loop's top,
// classification, extensions; the snapshots' arms and the matches summed
// over the events
constexpr int kPhases = 12;
__device__ long long* kn_phase_out;
#define KN_DECL long long kn_acc[kPhases] = {}, kn_t = clock64();
#define KN_MARK(k) { const long long t_ = clock64(); kn_acc[k] += t_ - kn_t; \
    kn_t = t_; }
#define KN_ADD(k, v) kn_acc[k] += (v);
#define KN_STORE(lead, b) if (lead) for (int q_ = 0; q_ < kPhases; ++q_) \
    kn_phase_out[kPhases * (long long)(b) + q_] = kn_acc[q_];
#else
#define KN_DECL
#define KN_MARK(k)
#define KN_ADD(k, v)
#define KN_STORE(lead, b)
#endif

struct ChainArgs {
  const int* ev_i;               // probe index of each event [E]
  const int* ev_z;               // quiet probes before each event [E]
  const long long* m_off;        // CSR offsets of the matches [E + 1]
  const void* m;                 // matches, int32 or int64 (M)
  long long m_total;             // matches
  long long m_offset;            // added to every match, in int64
  const long long* burst_start;  // [NB + 1]
  const int* order;              // the bursts to run [n_order]
  int n_order, n_bursts;
  const int* z_trail;            // quiet probes after the last event [1]
  int t_split;
  long long ps, step, max_gap, min_dup;
  long long D;                   // steps an arm outlives its extension
  long long w_spawn;             // a spawned arm's width (arm_w at ps)
  int arms_cap;
  int warp_arms;                 // the warp path's arm budget
  long long* rows;               // [out_cap, 6]
  long long out_cap;
  unsigned long long* n_rows;    // rows emitted (counts past out_cap)
  int* ctr;                      // [0] the warp path's next job, [1]
                                 // handovers, [2] the block path's next
  unsigned long long* queue;     // handovers [n_order]
  int* status;                   // [NB]: 0 done, 1 arm overflow
  long long* tests;              // [NB]: native (match, arm) tests
  unsigned char* arms_global;    // nullptr: arms in shared memory
};

// The block path's arm set: struct of arrays over capacity A.
struct Arms {
  long long *ls, *le, *rs, *re, *w, *x;
  int* last;  // the event's last extending match, -1 between events
};

constexpr long long kArmBytes = 56;  // 6 * 8 + 4, 8-aligned per block

__device__ Arms arms_at(unsigned char* base, int A) {
  Arms s;
  long long* p = (long long*)base;
  s.ls = p;
  s.le = p + A;
  s.rs = p + 2 * (long long)A;
  s.re = p + 3 * (long long)A;
  s.w = p + 4 * (long long)A;
  s.x = p + 5 * (long long)A;
  s.last = (int*)(p + 6 * (long long)A);
  return s;
}

// Match x, where its value is needed at once (the load waits).
template <typename M>
__device__ __forceinline__ long long load_m(const ChainArgs& a, long long x) {
  return (long long)((const M*)a.m)[x] + a.m_offset;
}

// Match x as stored, or 0 when `ok` is false: a load issued ahead of its
// use, so nothing reads the register (no select, no add) until then.
template <typename M>
__device__ __forceinline__ M load_raw(const ChainArgs& a, long long x,
                                      bool ok) {
  M v = 0;
  if (ok) v = ((const M*)a.m)[x];
  return v;
}

// The width of an arm's window: a match is admissible while (unsigned)
// (m_start - (r_end - ps + 1)) < w, that is r_end - ps < m_start < r_end +
// allow; w = allow + ps - 1 with the native's allow = max(max_gap, (long
// long)(0.1 * l_len)) in double, and 0 where allow <= 0 (d_ss >= 0: never
// admissible).
__host__ __device__ __forceinline__ long long arm_w(long long max_gap,
                                                    long long ps,
                                                    long long l_len) {
  const long long fl = (long long)(0.1 * (double)l_len);
  const long long allow = max_gap > fl ? max_gap : fl;
  return allow > 0 ? allow + ps - 1 : 0;
}

__device__ __forceinline__ bool admissible(long long m_s, long long re,
                                           long long w, long long ps) {
  return (unsigned long long)(m_s - re + ps - 1) < (unsigned long long)w;
}

__device__ __forceinline__ bool is_short(const ChainArgs& a, long long l_len,
                                         long long r_len) {
  return l_len < a.min_dup && r_len < a.min_dup;
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// The events of a burst, the warp path's view: lane l holds event base + l
// of the current batch of 32, of the next and of the one after (probe
// index, quiet count, match offset, and for the first two the first match
// as stored); the current batch's match counts too. A batch moves up every
// 32 events, so no register is read before its load was issued 32 events
// earlier, and event e (e - base < 32) costs a shuffle a value.
template <typename M>
struct Stream {
  long long base, e1;
  int ci, cz, ai, az, bi, bz;  // current batch, next (a), the one after (b)
  long long co, ao, bo;
  M cm, am;
  int cc;  // the current batch's match counts

  __device__ void counts() {
    const long long nx = __shfl_down_sync(kFull, co, 1);
    const long long na = __shfl_sync(kFull, ao, 0);
    cc = (int)((lane_id() == 31 ? na : nx) - co);
  }
  __device__ void load(const ChainArgs& a, long long bb, int& i, int& z,
                       long long& o) const {
    const long long e = bb + lane_id();
    const long long ec = e < e1 ? e : e1 - 1;
    i = a.ev_i[ec];
    z = a.ev_z[ec];
    o = a.m_off[e < e1 ? e : e1];
  }
  __device__ void init(const ChainArgs& a, long long e0, long long end) {
    base = e0;
    e1 = end;
    load(a, base, ci, cz, co);
    load(a, base + 32, ai, az, ao);
    load(a, base + 64, bi, bz, bo);
    cm = load_raw<M>(a, co, co < a.m_total);
    am = load_raw<M>(a, ao, ao < a.m_total);
    counts();
  }
  __device__ void advance(const ChainArgs& a, long long e) {
    if (e - base >= 32) {
      ci = ai; cz = az; co = ao; cm = am;
      ai = bi; az = bz; ao = bo;
      am = load_raw<M>(a, ao, ao < a.m_total);
      base += 32;
      load(a, base + 64, bi, bz, bo);
      counts();
    }
  }
  // event e of the current batch (e - base < 32): one shuffle a value
  __device__ int probe(long long e) const {
    return __shfl_sync(kFull, ci, (int)(e - base));
  }
  __device__ int quiet(long long e) const {
    return __shfl_sync(kFull, cz, (int)(e - base));
  }
  __device__ int count(long long e) const {
    return __shfl_sync(kFull, cc, (int)(e - base));
  }
  __device__ long long off(long long e) const {
    return __shfl_sync(kFull, co, (int)(e - base));
  }
  __device__ long long first(const ChainArgs& a, long long e) const {
    return (long long)__shfl_sync(kFull, cm, (int)(e - base)) + a.m_offset;
  }
};

__device__ __forceinline__ long long trail_steps(const ChainArgs& a, int b) {
  const long long zt = *a.z_trail;
  return b == a.n_bursts - 1 && zt < a.t_split ? zt : a.t_split;
}

// ---------------------------------------------------------------- warp path

// The arms of a burst on one warp: slot j = r * 32 + lane in registers.
struct WarpArms {
  long long ls[kWarpSlots], le[kWarpSlots], rs[kWarpSlots], re[kWarpSlots];
  long long w[kWarpSlots], x[kWarpSlots], ext[kWarpSlots];
  bool extended[kWarpSlots];
};

// Emission on simultaneous death: the arms with r_len >= min_dup, in arm
// order, as one family.
__device__ __forceinline__ void warp_emit(const ChainArgs& a,
                                          const WarpArms& w, int b, int n,
                                          int& fam, long long& rows) {
  const int lane = lane_id();
  unsigned bal[kWarpSlots];
  int total = 0;
#pragma unroll
  for (int r = 0; r < kWarpSlots; ++r) {
    const bool em = r * 32 + lane < n && w.re[r] - w.rs[r] >= a.min_dup;
    bal[r] = __ballot_sync(kFull, em);
    total += __popc(bal[r]);
  }
  if (total == 0) return;
  unsigned long long slot = 0;
  if (lane == 0)
    slot = atomicAdd(a.n_rows, (unsigned long long)total);
  slot = __shfl_sync(kFull, slot, 0);
  const unsigned lt = (1u << lane) - 1;
  int before = 0;
#pragma unroll
  for (int r = 0; r < kWarpSlots; ++r) {
    if (bal[r] >> lane & 1) {
      const int rank = before + __popc(bal[r] & lt);
      const long long g = (long long)slot + rank;
      if (g < a.out_cap) {
        long long* row = a.rows + 6 * g;
        row[0] = ((long long)b << 32) | (rows + rank);
        row[1] = w.ls[r];
        row[2] = w.rs[r];
        row[3] = w.le[r] - w.ls[r];
        row[4] = w.re[r] - w.rs[r];
        row[5] = fam;
      }
    }
    before += __popc(bal[r]);
  }
  rows += total;
  fam += 1;
}

// Arm j = r * 32 + lane of a warp's arms takes (le, re, w, x); with `all`
// the spawned arm's ls and rs too. Every lane computes, the owner keeps.
__device__ __forceinline__ void warp_set(WarpArms& w, int j, bool all,
                                         long long ls, long long le,
                                         long long rs, long long re,
                                         long long wd, long long x) {
  const int lane = lane_id();
#pragma unroll
  for (int r = 0; r < kWarpSlots; ++r) {
    const bool own = j == r * 32 + lane;
    w.ls[r] = own && all ? ls : w.ls[r];
    w.rs[r] = own && all ? rs : w.rs[r];
    w.le[r] = own ? le : w.le[r];
    w.re[r] = own ? re : w.re[r];
    w.w[r] = own ? wd : w.w[r];
    w.x[r] = own ? x : w.x[r];
  }
}

// The first arm of the snapshot's n0 that admits m_s at step c, or
// INT_MAX.
__device__ __forceinline__ int warp_first(const WarpArms& w, int n0,
                                          long long c, long long m_s,
                                          long long ps) {
  const int lane = lane_id();
  int f = INT_MAX;
#pragma unroll
  for (int r = kWarpSlots - 1; r >= 0; --r) {
    if (r * 32 < n0) {
      const unsigned mask = __ballot_sync(
          kFull, r * 32 + lane < n0 && c < w.x[r] &&
                     admissible(m_s, w.re[r], w.w[r], ps));
      if (mask) f = r * 32 + __ffs(mask) - 1;
    }
  }
  return f;
}

// Burst b on this warp. Returns false when its arms passed the warp's
// budget below arms_cap: it was handed over to the block path.
template <typename M>
__device__ __forceinline__ bool run_warp(const ChainArgs& a, int b) {
  const int lane = lane_id();
  const long long e0 = a.burst_start[b], e1 = a.burst_start[b + 1];
  const int budget = a.warp_arms < a.arms_cap ? a.warp_arms : a.arms_cap;
  const long long ps = a.ps, D = a.D;
  KN_DECL
  WarpArms w;
#pragma unroll
  for (int r = 0; r < kWarpSlots; ++r) {
    w.ls[r] = w.le[r] = w.rs[r] = w.re[r] = w.w[r] = w.x[r] = w.ext[r] = 0;
    w.extended[r] = false;
  }
  Stream<M> st;
  st.init(a, e0, e1);
  int n = 0, fam = 0;
  long long rows = 0, tests = 0, c = 0, X = LLONG_MIN;
  bool over = false;
  for (long long e = e0; e < e1; ++e) {
    st.advance(a, e);
    const long long i = st.probe(e);
    const int cnt = st.count(e);
    const long long m_first = st.first(a, e);
    KN_MARK(6)
    if (e > e0) {  // the quiet run: no prune under 200 arms
      const long long z = st.quiet(e);
      if (n > 0 && X <= c + z) {
        warp_emit(a, w, b, n, fam, rows);
        n = 0;
        X = LLONG_MIN;
        KN_ADD(4, 1)
      }
      c += z;
      KN_MARK(3)
    }
    const int n0 = n;
    KN_ADD(9, n0)
    KN_ADD(10, cnt)
    if (cnt == 1) {  // one match (sparse chunks): it extends or spawns
      const int f = warp_first(w, n0, c, m_first, ps);
      if (f != INT_MAX) {
        tests += f + 1;
        const long long ls = __shfl_sync(
            kFull, f < 32 ? w.ls[0] : w.ls[kWarpSlots - 1], f & 31);
        warp_set(w, f, false, 0, i + ps, 0, m_first + ps,
                 arm_w(a.max_gap, ps, i + ps - ls), c + 1 + D);
        X = c + 1 + D;
      } else {
        tests += n0;
        if (n0 + 1 > budget) {
          over = true;
          break;
        }
        warp_set(w, n0, true, i, i + ps, m_first, m_first + ps, a.w_spawn,
                 c + D);
        X = c + D > X ? c + D : X;
        n = n0 + 1;
      }
      KN_MARK(0)
    } else {  // several: classified against the snapshot, then applied
      const long long mb = st.off(e);
      int spawned = 0;
      bool any_ext = false;
      for (int c0 = 0; c0 < cnt; c0 += 32) {
        const long long chunk =
            c0 + lane < cnt ? load_m<M>(a, mb + c0 + lane) : 0;
        const int cn = cnt - c0 < 32 ? cnt - c0 : 32;
        for (int mi = 0; mi < cn; ++mi) {
          const long long m_s = __shfl_sync(kFull, chunk, mi);
          const int f = warp_first(w, n0, c, m_s, ps);
          if (f != INT_MAX) {  // the last match wins
            tests += f + 1;
            any_ext = true;
#pragma unroll
            for (int r = 0; r < kWarpSlots; ++r) {
              const bool own = f == r * 32 + lane;
              w.ext[r] = own ? m_s : w.ext[r];
              w.extended[r] = w.extended[r] || own;
            }
          } else {
            tests += n0;
            const int sp = n0 + spawned;
            ++spawned;
            warp_set(w, sp, true, i, i + ps, m_s, m_s + ps, a.w_spawn,
                     c + D);
          }
        }
      }
      KN_MARK(0)
      if (n0 + spawned > budget) {
        over = true;
        break;
      }
#pragma unroll
      for (int r = 0; r < kWarpSlots; ++r) {
        const bool ex = w.extended[r];
        const long long le = i + ps, re = w.ext[r] + ps;
        const long long wd = arm_w(a.max_gap, ps, le - w.ls[r]);
        w.le[r] = ex ? le : w.le[r];
        w.re[r] = ex ? re : w.re[r];
        w.w[r] = ex ? wd : w.w[r];
        w.x[r] = ex ? c + 1 + D : w.x[r];
        w.extended[r] = false;
      }
      if (any_ext)
        X = c + 1 + D;
      else if (spawned && c + D > X)
        X = c + D;
      n = n0 + spawned;
    }
    c += 1;
    if (n > 0 && X <= c) {  // simultaneous death
      warp_emit(a, w, b, n, fam, rows);
      n = 0;
      X = LLONG_MIN;
    }
    KN_MARK(2)
  }
  if (over && budget < a.arms_cap) {  // to the block path, from the start
    if (lane == 0)
      a.queue[atomicAdd(a.ctr + 1, 1)] =
          ((unsigned long long)rows << 32) | ((unsigned)b + 1u);
    return false;
  }
  if (!over && n > 0 && X <= c + trail_steps(a, b))
    warp_emit(a, w, b, n, fam, rows);
  KN_MARK(3)
  if (lane == 0) {
    a.status[b] = over ? 1 : 0;
    a.tests[b] = tests;
  }
  KN_STORE(lane == 0, b)
  return true;
}

// ---------------------------------------------------------------- block path

// Stable in-place compaction of the n arms: removes the short arms whose
// x <= thr (dead after step thr). Rounds of kQ * T arms, kQ a thread, read
// into registers before the round's one barrier. Returns the arms left.
__device__ __forceinline__ int compact(const ChainArgs& a, const Arms& s,
                                       int n, long long thr, int* wsum) {
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31;
  const int w = tid >> 5, nw = T >> 5;
  int out = 0, par = 0;
  for (int r0 = 0; r0 < n; r0 += kQ * T) {
    long long ls[kQ], le[kQ], rs[kQ], re[kQ], wd[kQ], x[kQ];
    int cnt = 0, keep = 0;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int j = r0 + kQ * tid + q;
      if (j < n) {
        ls[q] = s.ls[j]; le[q] = s.le[j]; rs[q] = s.rs[j]; re[q] = s.re[j];
        wd[q] = s.w[j]; x[q] = s.x[j];
        if (!(x[q] <= thr && is_short(a, le[q] - ls[q], re[q] - rs[q]))) {
          keep |= 1 << q;
          ++cnt;
        }
      }
    }
    int incl = cnt;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) wsum[32 * par + w] = incl;
    __syncthreads();
    int before = 0, tot = 0;
    for (int k = 0; k < nw; ++k) {
      const int v = wsum[32 * par + k];
      before += k < w ? v : 0;
      tot += v;
    }
    int dst = out + before + incl - cnt;
#pragma unroll
    for (int q = 0; q < kQ; ++q)
      if (keep >> q & 1) {
        s.ls[dst] = ls[q]; s.le[dst] = le[q]; s.rs[dst] = rs[q];
        s.re[dst] = re[q]; s.w[dst] = wd[q]; s.x[dst] = x[q];
        ++dst;
      }
    out += tot;
    par ^= 1;
  }
  __syncthreads();
  return out;
}

// Emission on simultaneous death (every thread calls it): the arms with
// r_len >= min_dup, in arm order, as one family; rows of the burst whose
// index is under `skip` were written by the warp that handed it over.
__device__ __forceinline__ void block_emit(const ChainArgs& a, const Arms& s,
                                           int b, int n, int& fam,
                                           long long& rows, long long skip,
                                           int* wsum) {
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31;
  const int w = tid >> 5, nw = T >> 5;
  long long out = 0;
  int par = 0;
  for (int r0 = 0; r0 < n; r0 += kQ * T) {
    int cnt = 0, em = 0;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int j = r0 + kQ * tid + q;
      if (j < n && s.re[j] - s.rs[j] >= a.min_dup) {
        em |= 1 << q;
        ++cnt;
      }
    }
    int incl = cnt;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) wsum[32 * par + w] = incl;
    __syncthreads();
    int before = 0, tot = 0;
    for (int k = 0; k < nw; ++k) {
      const int v = wsum[32 * par + k];
      before += k < w ? v : 0;
      tot += v;
    }
    const long long rank0 = rows + out + before + incl - cnt;
    // this thread's rows that are new, and their place among the warp's
    int fresh = 0;
#pragma unroll
    for (int q = 0, r = 0; q < kQ; ++q)
      if (em >> q & 1) fresh += rank0 + r++ >= skip;
    int f_incl = fresh;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, f_incl, o);
      if (lane >= o) f_incl += y;
    }
    const int f_tot = __shfl_sync(kFull, f_incl, 31);
    unsigned long long slot = 0;
    if (lane == 0 && f_tot)
      slot = atomicAdd(a.n_rows, (unsigned long long)f_tot);
    slot = __shfl_sync(kFull, slot, 0) + (f_incl - fresh);
#pragma unroll
    for (int q = 0, r = 0; q < kQ; ++q)
      if (em >> q & 1) {
        const long long rank = rank0 + r++;
        if (rank < skip) continue;
        const int j = r0 + kQ * tid + q;
        if ((long long)slot < a.out_cap) {
          long long* row = a.rows + 6 * (long long)slot;
          row[0] = ((long long)b << 32) | rank;
          row[1] = s.ls[j];
          row[2] = s.rs[j];
          row[3] = s.le[j] - s.ls[j];
          row[4] = s.re[j] - s.rs[j];
          row[5] = fam;
        }
        ++slot;
      }
    out += tot;
    par ^= 1;
  }
  __syncthreads();
  rows += out;
  if (out) fam += 1;
}

// The shared state of the block path.
struct BlockScratch {
  long long* rec;  // [2][8] by the event's parity: its probe index, quiet
                   // count, match offset and count; the offset and count
                   // of the event two after it (its first tile is loaded
                   // ahead); a solo step's spawns and extensions
  long long* mt;  // [3][T]: two event tiles of matches, an extra tile
  long long* sv;  // [T]: a tile's matches by position
  int* si;        // [T]: their places in the tile
  int* first;     // [2][T]: each tile match's first admissible arm
  int* wsum;      // [2][32]
  int* hist;      // [kWindow]
};

// z quiet steps from step c, in closed form (every thread calls it; it
// ends with a barrier where it wrote the arms). Returns the compactions.
__device__ __forceinline__ int block_quiet(const ChainArgs& a, const Arms& s,
                                           const BlockScratch& sh, int b,
                                           long long z, long long& c,
                                           long long& X, int& n, int& fam,
                                           long long& rows, long long skip) {
  const int T = blockDim.x, tid = threadIdx.x;
  int compactions = 0;
  if (n == 0 || z <= 0) {
    c += z;
    return 0;
  }
  const bool emits = X <= c + z;  // the last active arm dies at step X
  // the prune fires at each step while more than 200 arms are left; up to
  // the emission step (whose prune removes no emitted arm)
  const long long s_end = emits ? X - 1 : c + z;
  long long s0 = c + 1;
  while (n > kPruneAbove && s0 <= s_end) {
    const long long w_end = s_end < s0 + kWindow - 1 ? s_end
                                                       : s0 + kWindow - 1;
    if (tid < kWindow) sh.hist[tid] = 0;
    __syncthreads();
    for (int j = tid; j < n; j += T) {
      const long long x = s.x[j];
      if (x <= w_end &&
          is_short(a, s.le[j] - s.ls[j], s.re[j] - s.rs[j]))
        atomicAdd(sh.hist + (x > s0 ? (int)(x - s0) : 0), 1);
    }
    __syncthreads();
    // it fires at s0 + k while n - C(k - 1) > 200, C(k) the short arms
    // dead by s0 + k: the last firing is the first k with n - C(k) <= 200
    int C = 0;
    long long k = 0;
    for (;; ++k) {
      C += sh.hist[k];
      if (n - C <= kPruneAbove || s0 + k == w_end) break;
    }
    if (C > 0) {
      n = compact(a, s, n, s0 + k, sh.wsum);
      ++compactions;
    } else {
      __syncthreads();
    }
    s0 += k + 1;
  }
  if (emits) {
    block_emit(a, s, b, n, fam, rows, skip, sh.wsum);
    n = 0;
    X = LLONG_MIN;
  }
  c += z;
  return compactions;
}

// What lane k of a warp loads of event e's record: the match offset of
// event e + (k & 3), and the probe index (k even) or quiet count (k odd)
// of event e. Every lane loads, so that no select waits for the loads:
// they are issued an event ahead and used after the next barrier.
struct RecLoad {
  long long off;
  int iz;
};

__device__ __forceinline__ RecLoad rec_load(const ChainArgs& a, long long e,
                                            long long e1) {
  const int k = lane_id();
  const long long x = e + (k & 3), ec = e < e1 ? e : e1 - 1;
  RecLoad v;
  v.off = a.m_off[x < e1 ? x : e1];
  v.iz = ((k & 1) ? a.ev_z : a.ev_i)[ec];
  return v;
}

// Event e's record into its parity's slots: its probe index, quiet count,
// match offset and count, and event e + 2's match offset and count.
__device__ __forceinline__ void rec_store(const RecLoad& v, long long* recs,
                                          long long e) {
  long long* rec = recs + 8 * (e & 1);
  const long long o0 = __shfl_sync(kFull, v.off, 0);
  const long long o1 = __shfl_sync(kFull, v.off, 1);
  const long long o2 = __shfl_sync(kFull, v.off, 2);
  const long long o3 = __shfl_sync(kFull, v.off, 3);
  const int i = __shfl_sync(kFull, v.iz, 0), z = __shfl_sync(kFull, v.iz, 1);
  if (lane_id() == 0) {
    rec[0] = i;
    rec[1] = z;
    rec[2] = o0;
    rec[3] = o1 - o0;
    rec[4] = o2;
    rec[5] = o3 - o2;
  }
}

// Burst b on this block, from its first event; rows under `skip` are not
// written again.
template <typename M>
__device__ __forceinline__ void run_block(const ChainArgs& a, const Arms& s,
                                          const BlockScratch& sh, int b,
                                          long long skip) {
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31;
  const int w = tid >> 5, nw = T >> 5, A = a.arms_cap;
  const long long e0 = a.burst_start[b], e1 = a.burst_start[b + 1];
  const long long ps = a.ps, D = a.D;
  KN_DECL
  // the last warp reads each event's scalars an event ahead and leaves
  // them in sh.rec for the block; each event's first tile is loaded two
  // events ahead as stored, and written to shared memory (with m_offset)
  // in the step before its own
  if (w == nw - 1) rec_store(rec_load(a, e0, e1), sh.rec, e0);
  const long long o0 = a.m_off[e0], o1 = a.m_off[e0 + 1];
  const long long o2 = a.m_off[e0 + 1 < e1 ? e0 + 2 : e1];
  sh.mt[tid] = tid < o1 - o0 ? load_m<M>(a, o0 + tid) : 0;
  sh.first[tid] = INT_MAX;
  M q1 = load_raw<M>(a, o1 + tid, tid < o2 - o1);
  for (int j = tid; j < A; j += T) s.last[j] = -1;
  __syncthreads();
  int n = 0, fam = 0, cur = 0;
  long long rows = 0, tests = 0, c = 0, X = LLONG_MIN;
  bool over = false;
  for (long long e = e0; e < e1; ++e) {
    long long* rec = sh.rec + 8 * (e & 1);
    const long long i = rec[0], z = rec[1], mb = rec[2], cnt = rec[3];
    const M q2 = load_raw<M>(a, rec[4] + tid, tid < rec[5]);
    const RecLoad next = rec_load(a, e + 1, e1);
    KN_MARK(6)
    if (e > e0) {
      const int n_was = n;
      const int cq = block_quiet(a, s, sh, b, z, c, X, n, fam, rows, skip);
      KN_ADD(4, cq || (n_was && !n))
      KN_ADD(5, cq)
      (void)n_was;
      (void)cq;
      KN_MARK(3)
    }
    const int n0 = n;
    KN_ADD(9, n0)
    KN_ADD(10, cnt)
    long long spawned = 0;
    long long* tile = sh.mt + cur * T;
    int* first = sh.first + cur * T;
    // one tile of at most 64 matches: each match's thread finds whether
    // it is its arm's last, with no marks and no barrier for them
    const bool direct = cnt <= 64 && cnt <= T;
    // at most 32 arms and 32 matches: warp 0 alone, a lane an arm, and one
    // barrier at the step's end
    const bool solo = n0 <= 32 && cnt >= 1 && cnt <= 32 && cnt <= T;
    if (solo && w == 0) {
      const bool have = lane < n0;
      const long long re = have ? s.re[lane] : 0;
      const long long wd = have ? s.w[lane] : 0;
      const bool live = have && c < s.x[have ? lane : 0];
      long long ext = 0;
      bool extended = false;
      int sp = 0, hits = 0;
      for (int mi = 0; mi < cnt; ++mi) {
        const long long m_s = tile[mi];
        const unsigned mask =
            __ballot_sync(kFull, live && admissible(m_s, re, wd, ps));
        if (mask) {  // the last match wins
          const int f = __ffs(mask) - 1;
          tests += lane == 0 ? f + 1 : 0;
          ++hits;
          ext = lane == f ? m_s : ext;
          extended = extended || lane == f;
        } else {
          tests += lane == 0 ? n0 : 0;
          const long long slot = n0 + sp++;
          if (lane == 0 && slot < A) {
            s.ls[slot] = i;
            s.le[slot] = i + ps;
            s.rs[slot] = m_s;
            s.re[slot] = m_s + ps;
            s.w[slot] = a.w_spawn;
            s.x[slot] = c + D;
          }
        }
      }
      if (extended) {
        s.le[lane] = i + ps;
        s.re[lane] = ext + ps;
        s.w[lane] = arm_w(a.max_gap, ps, i + ps - s.ls[lane]);
        s.x[lane] = c + 1 + D;
      }
      if (lane == 0) {
        rec[6] = sp;
        rec[7] = hits;
      }
      KN_MARK(0)
    }
    if ((solo || cnt == 0) && w == nw - 1) rec_store(next, sh.rec, e + 1);
    for (long long t0 = 0; t0 < cnt && !solo; t0 += T) {
      const int tn = (int)(cnt - t0 < T ? cnt - t0 : T);
      if (t0 > 0) {  // a further tile of a large event
        __syncthreads();
        tile = sh.mt + 2 * T;
        tile[tid] = tid < tn ? load_m<M>(a, mb + t0 + tid) : 0;
        first[tid] = INT_MAX;
        __syncthreads();
      }
      // the tile's matches sorted by position (each thread ranks its own
      // by counting), then each live arm finds by bisection the matches
      // inside its window and offers its index to each (atomicMin): the
      // first admissible arm of a match is the least offered
      if (tid < tn) {
        const long long v = tile[tid];
        int r = 0;
        for (int k = 0; k < tn; ++k) {
          const long long u = tile[k];
          r += u < v || (u == v && k < tid);
        }
        sh.sv[r] = v;
        sh.si[r] = tid;
      }
      __syncthreads();
      for (int j = tid; j < n0; j += T) {
        const long long wd = c < s.x[j] ? s.w[j] : 0;
        if (wd > 0) {
          const long long lo = s.re[j] - ps + 1;
          int k0 = 0, k1 = tn;
          while (k0 < k1) {
            const int mid = (k0 + k1) >> 1;
            if (sh.sv[mid] < lo) k0 = mid + 1; else k1 = mid;
          }
          for (; k0 < tn &&
                 (unsigned long long)(sh.sv[k0] - lo) < (unsigned long long)wd;
               ++k0)
            atomicMin(first + sh.si[k0], j);
        }
      }
      KN_MARK(7)
      __syncthreads();
      // the last warp, idle here unless the tile holds 480 matches, leaves
      // the next event's record (every thread read this one before the
      // barrier)
      if (t0 == 0 && w == nw - 1) rec_store(next, sh.rec, e + 1);
      if (tid < tn) {
        const int f = first[tid];
        tests += f == INT_MAX ? n0 : f + 1;
        if (f != INT_MAX) {
          if (direct) {  // the last match of its arm extends it now
            bool last = true;
            for (int k = tid + 1; k < tn; ++k) last = last && first[k] != f;
            if (last) {
              const long long re = tile[tid] + ps;
              s.le[f] = i + ps;
              s.re[f] = re;
              s.w[f] = arm_w(a.max_gap, ps, i + ps - s.ls[f]);
              s.x[f] = c + 1 + D;
            }
          } else {
            atomicMax(s.last + f, (int)(t0 + tid));
          }
        }
      }
      KN_MARK(0)
      // spawns in match order, ranked by ballots over the tile's results
      int before = 0, tot = 0;
      unsigned mine = 0;
      for (int ch = 0; ch * 32 < tn; ++ch) {
        const int k = ch * 32 + lane;
        const unsigned bal = __ballot_sync(kFull, k < tn &&
                                           first[k] == INT_MAX);
        before += ch < w ? __popc(bal) : 0;
        if (ch == w) mine = bal;
        tot += __popc(bal);
      }
      if (mine >> lane & 1) {
        const long long slot =
            n0 + spawned + before + __popc(mine & ((1u << lane) - 1));
        if (slot < A) {
          const long long m_s = tile[tid];
          s.ls[slot] = i;
          s.le[slot] = i + ps;
          s.rs[slot] = m_s;
          s.re[slot] = m_s + ps;
          s.w[slot] = a.w_spawn;
          s.x[slot] = c + D;
        }
      }
      spawned += tot;
      KN_MARK(1)
      if (n0 + spawned > A) {
        over = true;
        break;
      }
    }
    if (over) break;  // uniform: every thread holds the same totals
    // extensions (the last match wins); nothing else ages explicitly
    const bool marked = !solo && !direct && spawned < cnt;
    if (marked) __syncthreads();  // the marks are in
    for (int j = tid; j < n0 && marked; j += T) {
      const int l = s.last[j];
      if (l >= 0) {
        s.last[j] = -1;
        const long long m =
            l < T ? sh.mt[cur * T + l] : load_m<M>(a, mb + l);
        s.le[j] = i + ps;
        s.re[j] = m + ps;
        s.w[j] = arm_w(a.max_gap, ps, i + ps - s.ls[j]);
        s.x[j] = c + 1 + D;
      }
    }
    KN_MARK(8)
    // the next event's tile
    sh.mt[(cur ^ 1) * T + tid] = (long long)q1 + a.m_offset;
    sh.first[(cur ^ 1) * T + tid] = INT_MAX;
    q1 = q2;
    cur ^= 1;
    __syncthreads();
    if (solo) {  // warp 0's totals
      spawned = rec[6];
      if (n0 + spawned > A) {
        over = true;
        break;
      }
    }
    if (spawned < cnt)  // an extension
      X = c + 1 + D;
    else if (spawned && c + D > X)
      X = c + D;
    c += 1;
    n = n0 + (int)spawned;
    if (n > 0 && X <= c) {  // simultaneous death
      block_emit(a, s, b, n, fam, rows, skip, sh.wsum);
      n = 0;
      X = LLONG_MIN;
    } else if (n > kPruneAbove) {
      n = compact(a, s, n, c, sh.wsum);
      KN_ADD(5, 1)
    }
    KN_MARK(2)
  }
  if (!over) {
    const int cq = block_quiet(a, s, sh, b, trail_steps(a, b), c, X, n, fam,
                               rows, skip);
    KN_ADD(5, cq)
    (void)cq;
    KN_MARK(3)
  }
  // the burst's native test count
  for (int o = 16; o; o >>= 1) tests += __shfl_down_sync(kFull, tests, o);
  __syncthreads();  // wsum is free
  long long* tsum = (long long*)sh.wsum;
  if (tid == 0) *tsum = 0;
  __syncthreads();
  if (lane == 0 && tests)
    atomicAdd((unsigned long long*)tsum, (unsigned long long)tests);
  __syncthreads();
  if (tid == 0) {
    a.status[b] = over ? 1 : 0;
    a.tests[b] = *tsum;
  }
  KN_STORE(tid == 0, b)
  __syncthreads();
}

// The warp path: warps take bursts one at a time, longest first, and
// hand a burst that passes their budget to the block path's queue.
template <typename M>
__global__ void __launch_bounds__(kWarpThreads)
chain_warp_kernel(ChainArgs a) {
  for (;;) {
    int job = 0;
    if (lane_id() == 0) job = atomicAdd(a.ctr, 1);
    job = __shfl_sync(kFull, job, 0);
    if (job >= a.n_order) return;
    run_warp<M>(a, a.order[job]);
  }
}

// The block path, launched after the warp path on the same stream: blocks
// take the handed-over bursts (or, with warp_arms 0, every burst in
// order) one at a time.
template <typename M>
__global__ void __launch_bounds__(kMaxThreads)
chain_block_kernel(ChainArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long item;
  const int T = blockDim.x;
  BlockScratch sh;
  sh.rec = (long long*)smem;
  sh.mt = sh.rec + 16;
  sh.sv = sh.mt + 3 * T;
  sh.first = (int*)(sh.sv + T);
  sh.wsum = sh.first + 2 * T;
  sh.hist = sh.wsum + 64;
  sh.si = sh.hist + kWindow;
  unsigned char* arm_base =
      a.arms_global
          ? a.arms_global + (size_t)blockIdx.x * a.arms_cap * kArmBytes
          : (unsigned char*)(sh.si + T);  // 8-aligned (T % 32 == 0)
  const Arms s = arms_at(arm_base, a.arms_cap);
  for (;;) {
    if (threadIdx.x == 0) {
      const int j = atomicAdd(a.ctr + 2, 1);
      if (a.warp_arms > 0)
        item = j < a.ctr[1] ? a.queue[j] : 0;
      else
        item = j < a.n_order ? (unsigned long long)a.order[j] + 1 : 0;
    }
    __syncthreads();
    const unsigned long long v = item;
    __syncthreads();
    if (!v) return;
    run_block<M>(a, s, sh, (int)((v & 0xffffffffull) - 1),
                 (long long)(v >> 32));
  }
}

long long smem_bytes(int threads, int arms_cap, int arms_in_smem) {
  return 16 * 8 + (long long)threads * (4 * 8 + 3 * 4) + (64 + kWindow) * 4 +
         (arms_in_smem ? (long long)arms_cap * kArmBytes : 0);
}

// Both block-path instances (int32 and int64 matches) allow `sm` bytes
// of dynamic shared memory; the blocks of `threads` an SM keeps of the
// one resident the least.
cudaError_t chain_attributes(int threads, long long sm, int* per_sm) {
  int p32 = 0, p64 = 0;
  cudaError_t rc = cudaFuncSetAttribute(
      chain_block_kernel<int>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sm);
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(chain_block_kernel<long long>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)sm);
  if (rc == cudaSuccess && per_sm)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &p32, chain_block_kernel<int>, threads, (size_t)sm);
  if (rc == cudaSuccess && per_sm)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &p64, chain_block_kernel<long long>, threads, (size_t)sm);
  if (per_sm) *per_sm = p32 < p64 ? p32 : p64;
  return rc;
}

// Resident blocks of the warp path's kernel (the card's, once).
template <typename M>
int warp_grid() {
  static int grid = 0;
  if (!grid) {
    int dev = 0, n_sm = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, chain_warp_kernel<M>, kWarpThreads, 0);
    grid = per_sm * n_sm > 0 ? per_sm * n_sm : 1;
  }
  return grid;
}

template <typename M>
cudaError_t launch(const ChainArgs& a, int blocks, int threads, long long sm,
                   cudaStream_t stream) {
  if (a.warp_arms > 0) {
    const int want = (a.n_order + kWarpThreads / 32 - 1) / (kWarpThreads / 32);
    const int grid = warp_grid<M>();
    chain_warp_kernel<M><<<want < grid ? want : grid, kWarpThreads, 0,
                           stream>>>(a);
  }
  if (a.warp_arms < a.arms_cap)  // bursts may pass the warp's budget
    chain_block_kernel<M><<<blocks, threads, (size_t)sm, stream>>>(a);
  return cudaGetLastError();
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
  if (sm + 64 > limit) return (int)cudaGetLastError();
  const cudaError_t rc = chain_attributes(threads, sm, &per_sm);
  if (rc != cudaSuccess) return (int)rc;
  *(int*)blocks = per_sm * n_sm;
  return (int)cudaGetLastError();
}

// The warp path's kernel, then (when a burst may pass the warp's budget)
// the block path's on `blocks` blocks. `ctr` is 4 zeroed ints, `queue`
// n_order 64-bit words.
ASGART_API int asgart_chain_bursts(
    const void* ev_i, const void* ev_z, const void* m_off, const void* m,
    int m_is_i64, long long m_total, long long m_offset,
    const void* burst_start,
    const void* order, int n_order, int n_bursts, const void* z_trail,
    int t_split, long long ps, long long step, long long max_gap,
    long long min_dup, int arms_cap, int warp_arms, void* rows,
    long long out_cap, void* n_rows, void* ctr, void* queue, void* status,
    void* tests, void* arms_global, int blocks, int threads, void* stream) {
  ChainArgs a;
  a.ev_i = (const int*)ev_i;
  a.ev_z = (const int*)ev_z;
  a.m_off = (const long long*)m_off;
  a.m = m;
  a.m_total = m_total;
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
  a.D = max_gap <= 0 ? 1 : (max_gap + step - 1) / step;
  if (a.D < 1) a.D = 1;
  a.w_spawn = arm_w(max_gap, ps, ps);
  a.arms_cap = arms_cap;
  a.warp_arms = warp_arms < kWarpArms ? warp_arms : kWarpArms;
  a.rows = (long long*)rows;
  a.out_cap = out_cap;
  a.n_rows = (unsigned long long*)n_rows;
  a.ctr = (int*)ctr;
  a.queue = (unsigned long long*)queue;
  a.status = (int*)status;
  a.tests = (long long*)tests;
  a.arms_global = (unsigned char*)arms_global;
  const long long sm = smem_bytes(threads, arms_cap, arms_global == nullptr);
  const cudaError_t rc = chain_attributes(threads, sm, nullptr);
  if (rc != cudaSuccess) return (int)rc;
  return (int)(m_is_i64
                   ? launch<long long>(a, blocks, threads, sm,
                                       (cudaStream_t)stream)
                   : launch<int>(a, blocks, threads, sm,
                                 (cudaStream_t)stream));
}

#ifdef KN_PHASES
ASGART_API int asgart_chain_phases(void* p) {
  return (int)cudaMemcpyToSymbol(kn_phase_out, &p, sizeof(p));
}
#endif
