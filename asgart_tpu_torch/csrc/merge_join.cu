// KH mj_ranges: the merge join of the window engine. For every probe lane,
// the equal range [lo, hi) of its key in the sorted window keys, plus exact
// per-chunk totals of (hi - lo) over the masked lanes; and the key
// directory that KH searches from, built once per index (mj_directory).
//
// Replaces (JAX reference): asgart_tpu/device_engine.py:788 _mj_tail, as
// reached through _merge_join_core (:845), _window_ranges (:685),
// _window_ranges_batch (:865) and _mj_ranges_from_keys (:946; the donated
// variant :954 and _slice_lanes :964 have no counterpart). The directory
// replaces nothing: the JAX package co-sorts instead of searching.
//
// The JAX package co-sorts the W window keys with the tagged probe keys and
// reads hi (window entries at or before the probe: a cumsum) and lo (window
// entries before the probe's run: a cummax) off the co-sorted stream, then
// sorts both back into lane order: that is exactly the lower and upper
// bound of each probe key in the sorted window keys. Here every lane finds
// them itself, with no co-sort, so no (W + B)-row transient and no
// back-sorts. Keys compare without their flag bit (bit 0: 0 on window
// keys, 1 on probe keys), as KB compares them.
//
// The directory: a key's 3-bit symbol ranks ('$' 0, A 1, C 2, G 3, N 4,
// T 5; first symbol highest, csrc/pack_keys.cu) map to 2-bit digits by a
// non-decreasing map ('$' shares A's digit, N G's, the unused ranks 6 and
// 7 T's); where a symbol shares its digit with a higher rank ('$') every
// later digit is 0, and where it shares it with a lower one (N, 6, 7)
// every later digit is 3. So the digit string of a key's first symbols
// never decreases along the sorted keys, and every key equal to a probe
// lies in the probe's bucket: the top `bits` bits of that string. dir[b]
// (b = 0 .. 2^bits) is the first row whose bucket is at least b, so
// bucket b is rows [dir[b], dir[b + 1]), and dir[2^bits] = W.
// 2^bits + 1 <= W / 16 entries (kernels/merge_join.py mj_directory_bits),
// at most 0.25 B a window row; bits = 0 is no directory: the whole window
// is one bucket. A repeat-poor window's
// buckets hold ~16-32 keys, a span of a few hundred bytes.
// Build: each thread takes kDirRows consecutive rows (two 16-byte key
// loads where the keys are 16-byte aligned), a warp 32 kDirRows rows, the
// warps grid-stride over the rows 0..W (row W: past every key, bucket
// 2^bits). A thread gets the key before its first row from the lane
// before it (__shfl_up_sync); lane 0 loads it, one load a warp. No shared
// memory and no block barrier. Row i writes dir[b] = i for the buckets
// (bucket(i - 1), bucket(i)] that start there (bucket(-1) = -1). Equal
// top 3m bits (the key's first m = ceil(bits / 2) symbols) give equal
// buckets, so only the change rows, where those bits differ from the row
// before's (rows 0 and W among them; about one row in 16-32 at the
// 0.25 B a row size), can start a bucket. bucket_of is the costly step
// (m symbol lookups), and a warp that ran it on each lane's own change
// rows would run it, divergent, for almost every row slot, so the warp
// finds its change rows by ballots, numbers them in row order and
// computes their buckets together, one a lane: item 0 is the key before
// change 0, item y the key of change y - 1 (the key before change t has
// change t - 1's first symbols), and change t writes (item t, item t +
// 1]. Each lane finds the change it serves by a binary search over the
// ballots' counts and reads its key by shuffles; a round of 32 items
// serves 31 changes. At bits <= 20 (W under 2^25 + 16 rows: the 32 M-row
// windows and slices) a bucket is computed in one 32-bit word, every
// digit at once (bucket_narrow). The check of order and range is a
// compare a row.
// A short run of buckets is written by its row's thread, a long one (the
// head and tail of a shard's keys, which cover part of the key space,
// take 2^bits words in all) by the whole warp, 32 consecutive words at a
// time. A bucket is the digits of the key's first m symbols, looked up a
// symbol at a time in 32-bit words, with the fill after the first '$', N,
// 6 or 7 found at once from the symbols' bits. It flags a key outside
// [0, 2^(3k)) or below its predecessor in `bad` (zeroed by the entry
// point), which the wrapper hands on unread: the engine reads it with the
// join's totals, the one host read it makes after KH
// (kernels/merge_join.py). Its bound: 8 B a key read once and 4 B a
// directory word written (0.078 ms at W = 32 M); bucket_of's instructions,
// not the bytes, set its time.
// Search: a lane reads its mask and probe key, then the two directory
// words of its bucket, then descends its bucket for the lower bound; the
// key at the lower bound is the last one the descent read at or above the
// probe, so where it differs (or the bucket is passed) the upper bound is
// the lower one with no further read, else a gallop forward from it
// (asgart::run_end, bounded by the bucket's end). A probe key below 0 or
// at or past 2^(3k) compares below or above every window key (the
// directory build checked them) and takes (0, 0) or (W, W) unread. The
// counting instance (kCount, a non-null `counts`) adds the keys each
// thread read and the directory words to counts[0] and counts[1], one
// atomic add each a thread: the bound's data-dependent bytes, read from
// the kernel itself.
//
// Bound on the H100: the bytes are 8 B per probe key, 1 B per mask and
// 8 B of (lo, hi) per lane, plus the keys and directory words the search
// reads, each counted at most once (at most the window's 8 W and the
// directory's words: chip_smoke.kh_checks); each lane's directory read and its bucket's first key are
// dependent reads at random addresses (the directory, 4 MB at W = 32 M,
// stays in L2; the key in DRAM), the rest of its descent and gallop
// mostly hits the same sector or line, so latency, not the bytes, sets the
// time. Without a directory each lane ran ~log2(W) dependent reads.
// One thread per lane, grid-stride, consecutive lanes on consecutive
// threads so the lane reads and writes coalesce; the totals reduce a
// warp's lanes with shuffles when the warp lies inside one chunk, with
// atomics only at chunk edges (as KC does).
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
// 2-bit digits of the symbol ranks 0..7: 0, 0, 1, 2, 2, 3, 3, 3
// (kernels/merge_join.py DIGITS, FILL)
constexpr unsigned kDigits = 0xFE90u;

// Bit 0 of every 3-bit symbol field of a word.
constexpr unsigned long long kLowBits = 0x1249249249249249ULL;

// The bucket of a flag-free key v of k symbols (0 <= v < 2^(3k)): the top
// `bits` bits of the digits of its first m = ceil(bits / 2) symbols, every
// digit after a '$' 0 and after an N (or rank 6, 7) 3.
__device__ __forceinline__ int bucket_of(long long v, int k, int bits) {
  const int m = (bits + 1) >> 1;
  const unsigned long long x = (unsigned long long)v >> (3 * (k - m));
  unsigned d = 0;
  for (int j = m - 1; j >= 0; --j) {
    const unsigned r = (unsigned)(x >> (3 * j)) & 7u;
    d = (d << 2) | ((kDigits >> (2 * r)) & 3u);
  }
  // the symbols of rank 0 or 4 (bits 1 and 0 clear) or 6, 7 (bits 2, 1
  // set), one bit a field; the first of them (the highest) fills the
  // digits of the j symbols after it
  const unsigned long long ones = kLowBits & ((1ULL << (3 * m)) - 1);
  const unsigned long long special =
      (~x & ~(x >> 1) & ones) | ((x >> 2) & (x >> 1) & ones);
  if (special) {
    const int j = (63 - __clzll(special)) / 3;
    const unsigned below = (1u << (2 * j)) - 1;
    const bool dollar = ((x >> (3 * j)) & 7u) == 0;
    d = dollar ? d & ~below : d | below;
  }
  return (int)(d >> (2 * m - bits));
}

// The fields j of 10 3-bit symbol fields (j < 10) with bit s of j set, at
// bits 3j - (j mod s) of a 32-bit word, two bits each: the 2-bit digits
// that bucket_narrow moves down by s.
constexpr unsigned move_mask(int s) {
  unsigned mask = 0;
  for (int j = 0; j < 10; ++j) {
    if (j & s) mask |= 3u << (3 * j - (j & (s - 1)));
  }
  return mask;
}
constexpr unsigned kMove1 = move_mask(1), kMove2 = move_mask(2),
                   kMove4 = move_mask(4), kMove8 = move_mask(8);

// bucket_of for m <= 10 (bits <= 20: the first m symbols in one 32-bit
// word), every digit at once: a symbol rank r (bits r2 r1 r0) has the
// digit [r >= 2] + [r >= 3] + [r >= 5] (kDigits), whose high bit is
// r2 | (r1 & r0) and low bit (a ^ high) | (r2 & (r1 | r0)), a = r2 | r1;
// then field j's two digit bits move from bit 3j down to bit 2j, by 1, 2,
// 4 and 8 for the bits of j. The fill after the first '$', N, 6 or 7 as
// in bucket_of.
__device__ __forceinline__ int bucket_narrow(long long v, int k, int bits) {
  constexpr unsigned kOnes = 0x09249249u;  // bit 0 of each of 10 fields
  const int m = (bits + 1) >> 1;
  const unsigned x = (unsigned)((unsigned long long)v >> (3 * (k - m)));
  const unsigned r0 = x & kOnes, r1 = (x >> 1) & kOnes,
                 r2 = (x >> 2) & kOnes;
  const unsigned hi = r2 | (r1 & r0);
  unsigned d = (hi << 1) | (((r2 | r1) ^ hi) | (r2 & (r1 | r0)));
  d = (d & ~kMove1) | ((d & kMove1) >> 1);
  d = (d & ~kMove2) | ((d & kMove2) >> 2);
  d = (d & ~kMove4) | ((d & kMove4) >> 4);
  d = (d & ~kMove8) | ((d & kMove8) >> 8);
  const unsigned ones = kOnes & ((1u << (3 * m)) - 1);
  const unsigned special =
      (~x & ~(x >> 1) & ones) | ((x >> 2) & (x >> 1) & ones);
  if (special) {
    const int j = (31 - __clz(special)) / 3;
    const unsigned below = (1u << (2 * j)) - 1;
    const bool dollar = ((x >> (3 * j)) & 7u) == 0;
    d = dollar ? d & ~below : d | below;
  }
  return (int)(d >> (2 * m - bits));
}

constexpr int kDirRows = 4;  // rows a thread of the directory build

template <bool kVec>
__global__ void __launch_bounds__(asgart::kThreads)
mj_directory_kernel(const long long* __restrict__ skey, long long W, int k,
                    int bits, int* __restrict__ dir, int* __restrict__ bad) {
  constexpr int R = kDirRows;
  constexpr long long kTile = 32LL * R;  // rows a warp
  const long long top = 1LL << (3 * k);
  const int shift = 3 * (k - ((bits + 1) >> 1));  // v >> shift: m symbols
  const int ln = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  bool wrong = false;
  // the loop bound is uniform over the warp, so every warp stays
  // converged for the shuffles and ballots
  for (long long base = warp * kTile; base <= W; base += warps * kTile) {
    const long long i0 = base + (long long)ln * R;
    long long v[R];  // flag-free keys; row W and past it: top
    if (kVec && i0 + R <= W) {
#pragma unroll
      for (int j = 0; j < R; j += 2) {
        const longlong2 a =
            __ldg(reinterpret_cast<const longlong2*>(skey + i0 + j));
        v[j] = a.x >> 1;
        v[j + 1] = a.y >> 1;
      }
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        v[j] = i0 + j < W ? __ldg(skey + i0 + j) >> 1 : top;
      }
    }
    // the key before row i0 (-1 before row 0)
    long long p = __shfl_up_sync(kFull, v[R - 1], 1);
    if (ln == 0) p = base > 0 ? __ldg(skey + base - 1) >> 1 : -1;
    // row i0 + j is a change row (bit j) where its first m symbols differ
    // from its predecessor's: row 0 (after -1), row W (top) and where the
    // bucket may change; rows past W (top after top) are none
    unsigned mine = 0;
    long long q = p;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      // (v < 0 or v >= top: v outside [0, top) as an unsigned number)
      if (i0 + j < W && ((unsigned long long)v[j] >= (unsigned long long)top
                         || q > v[j])) {
        wrong = true;
      }
      if ((q ^ v[j]) >> shift) mine |= 1u << j;
      q = v[j];
    }
    unsigned M[R];
    int T = 0;  // the warp's change rows, in row order (lane, then j)
#pragma unroll
    for (int j = 0; j < R; ++j) {
      M[j] = __ballot_sync(kFull, (mine >> j) & 1u);
      T += __popc(M[j]);
    }
    if (T == 0) continue;  // (uniform) no bucket starts in the tile
    int before = 0;  // the change rows of the lanes before this one
#pragma unroll
    for (int j = 0; j < R; ++j) before += __popc(M[j] & ((1u << ln) - 1u));
    int b_lo[R], b_hi[R];  // the buckets that start at row i0 + j
#pragma unroll
    for (int j = 0; j < R; ++j) {
      b_lo[j] = 1;
      b_hi[j] = 0;
    }
    // Change row t writes the buckets (bucket(key before it), bucket(its
    // key)]; the key before change t + 1 has change t's first symbols, so
    // item y = 0 is the key before change 0, item y >= 1 change y - 1's
    // key, and change t takes items t and t + 1. A round computes 32 items
    // on the 32 lanes, one bucket_of each, for changes [r0, r0 + 31).
    for (int r0 = 0; r0 < T; r0 += 31) {
      const int y = r0 + ln;
      const int z = y == 0 ? 0 : min(y - 1, T - 1);
      int L = 0;  // the lane that holds change z: the last with
      for (int step = 16; step > 0; step >>= 1) {  // before <= z
        if (__shfl_sync(kFull, before, L + step) <= z) L += step;
      }
      unsigned f = __shfl_sync(kFull, mine, L);  // lane L's change rows
      for (int c = z - __shfl_sync(kFull, before, L); c > 0; --c) {
        f &= f - 1;
      }
      const int jz = __ffs(f) - 1;
      long long w[R + 1];  // lane L's key before its rows, then its keys
      w[0] = __shfl_sync(kFull, p, L);
#pragma unroll
      for (int j = 0; j < R; ++j) w[j + 1] = __shfl_sync(kFull, v[j], L);
      long long key = w[0];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (jz == j) key = y == 0 ? w[j] : w[j + 1];
      }
      const int res = key < 0      ? -1
                      : key >= top ? 1 << bits
                      : bits <= 20 ? bucket_narrow(key, k, bits)
                                   : bucket_of(key, k, bits);
      int t = before;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const bool here = (mine >> j) & 1u;
        const bool now = here && t >= r0 && t < r0 + 31;
        const int src = now ? t - r0 : 0;
        const int lo = __shfl_sync(kFull, res, src);
        const int hi = __shfl_sync(kFull, res, src + 1);
        if (now) {
          b_lo[j] = lo + 1;
          b_hi[j] = hi;
        }
        t += here;
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const long long i = i0 + j;
      // a short run of buckets by its row's thread, a long one by the
      // whole warp, 32 consecutive words at a time
      const bool alone = b_hi[j] - b_lo[j] < 32;
      if (alone) {
        for (int b = b_lo[j]; b <= b_hi[j]; ++b) dir[b] = (int)i;
      }
      for (unsigned wide = __ballot_sync(kFull, !alone); wide;
           wide &= wide - 1) {
        const int src = __ffs(wide) - 1;
        const int lo = __shfl_sync(kFull, b_lo[j], src);
        const int hi = __shfl_sync(kFull, b_hi[j], src);
        const int row = (int)__shfl_sync(kFull, i, src);
        for (int b = lo + ln; b <= hi; b += 32) dir[b] = row;
      }
    }
  }
  if (wrong) *bad = 1;
}

template <bool kCount>
__global__ void mj_ranges_kernel(const long long* __restrict__ skey,
                                 long long W,
                                 const long long* __restrict__ pkey,
                                 const uint8_t* __restrict__ lane_mask,
                                 long long total,
                                 const long long* __restrict__ lane_off,
                                 int n_chunks,
                                 const int* __restrict__ dir, int bits, int k,
                                 int* __restrict__ lane_lo,
                                 int* __restrict__ lane_hi,
                                 unsigned long long* __restrict__ totals,
                                 unsigned long long* __restrict__ counts) {
  const long long n_live = n_chunks > 0 ? lane_off[n_chunks] : 0;
  const long long top = bits > 0 ? 1LL << (3 * k) : 0;
  unsigned long long key_reads = 0, dir_reads = 0;  // kCount alone
  // the loop bound is uniform over the block, so every warp stays
  // converged for the shuffles
  for (long long base = (long long)blockIdx.x * blockDim.x; base < total;
       base += (long long)gridDim.x * blockDim.x) {
    const long long lane = base + threadIdx.x;
    int c = -1;
    unsigned long long v = 0;
    if (lane < total) {
      // both loads in flight before the mask is tested
      const bool live = lane_mask[lane];
      const long long p = __ldg(pkey + lane) >> 1;
      long long lo = 0, hi = 0;
      if (live) {
        long long s = 0, e = W;  // the probe's bucket
        if (bits > 0) {
          if (p < 0) {
            e = 0;
          } else if (p >= top) {
            s = W;
          } else {
            const long long b = bucket_of(p, k, bits);
            s = __ldg(dir + b);
            e = __ldg(dir + b + 1);
            if (kCount) dir_reads += 2;
          }
        }
        long long l = s, h = e, key_at = 0;  // key_at: skey[l] once l < e
        while (l < h) {
          const long long mid = (l + h) >> 1;
          const long long key = __ldg(skey + mid) >> 1;
          if (kCount) ++key_reads;
          if (key < p) {
            l = mid + 1;
          } else {
            h = mid;
            key_at = key;
          }
        }
        lo = l;
        hi = l < e && key_at == p
                 ? asgart::run_end(l, e, [&](long long r) {
                     if (kCount) ++key_reads;
                     return (__ldg(skey + r) >> 1) == p;
                   })
                 : l;
      }
      lane_lo[lane] = (int)lo;
      lane_hi[lane] = (int)hi;
      if (lane < n_live) {
        c = asgart::chunk_of(lane_off, n_chunks, lane);
        v = (unsigned long long)(hi - lo);
      }
    }
    const int c0 = __shfl_sync(kFull, c, 0);
    if (__all_sync(kFull, c == c0)) {
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
      if ((threadIdx.x & 31) == 0 && c0 >= 0 && v) atomicAdd(totals + c0, v);
    } else if (c >= 0 && v) {
      atomicAdd(totals + c, v);
    }
  }
  if (kCount) {
    atomicAdd(counts, key_reads);
    atomicAdd(counts + 1, dir_reads);
  }
}

bool bad_bits(int bits, int k) {
  return bits < 0 || bits > 30 || (bits > 0 && (k < 1 || k > 20 ||
                                                bits > 2 * k));
}

}  // namespace

// skey: int64 [W] sorted; dir: int32 [2^bits + 1] (1 <= bits <= 2k,
// k <= 20); bad: int32 [1], set to 1 when a flag-free key lies outside
// [0, 2^(3k)) or below its predecessor (zeroed here first).
ASGART_API int asgart_mj_directory(const void* skey, long long W, int k,
                                   int bits, void* dir, void* bad,
                                   void* stream) {
  if (bits < 1 || bad_bits(bits, k)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t rc = cudaMemsetAsync(bad, 0, sizeof(int), s);
  if (rc != cudaSuccess) return (int)rc;
  auto kernel = ((uintptr_t)skey & 15) == 0 ? mj_directory_kernel<true>
                                             : mj_directory_kernel<false>;
  kernel<<<asgart::grid_for((W + kDirRows) / kDirRows), asgart::kThreads, 0,
           s>>>((const long long*)skey, W, k, bits, (int*)dir, (int*)bad);
  return (int)cudaGetLastError();
}

// lane_off: n_chunks + 1 int64 offsets on the card; dir: null with
// bits = 0 (no directory), else mj_directory's table of k-symbol keys;
// counts: null, or int64 [2] that the counting instance adds its key
// reads and its directory reads to (not zeroed here).
ASGART_API int asgart_mj_ranges(const void* skey, long long W,
                                const void* pkey, const void* lane_mask,
                                long long total, const void* lane_off,
                                int n_chunks, const void* dir,
                                int bits, int k, void* lane_lo,
                                void* lane_hi, void* totals, void* counts,
                                void* stream) {
  if (bad_bits(bits, k) || (bits > 0 && dir == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (n_chunks > 0) {
    cudaError_t rc = cudaMemsetAsync(
        totals, 0, sizeof(unsigned long long) * n_chunks, s);
    if (rc != cudaSuccess) return (int)rc;
  }
  if (total <= 0) return (int)cudaGetLastError();
  auto kernel = counts ? mj_ranges_kernel<true> : mj_ranges_kernel<false>;
  kernel<<<asgart::grid_for(total), asgart::kThreads, 0, s>>>(
      (const long long*)skey, W, (const long long*)pkey,
      (const uint8_t*)lane_mask, total, (const long long*)lane_off, n_chunks,
      (const int*)dir, bits, k, (int*)lane_lo, (int*)lane_hi,
      (unsigned long long*)totals, (unsigned long long*)counts);
  return (int)cudaGetLastError();
}
