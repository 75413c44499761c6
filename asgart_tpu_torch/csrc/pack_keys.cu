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
//   for the table engine (`doubled` mode): device_index.py:244
//     _build_text_codes + :269 _pack_planes_all / :283 _pack_planes3_all
//     over the doubled text, and :317 _flagged_sort's / :341
//     _flagged_sort3's flag (positions >= n1 are 1), as DeviceIndex.build
//     (:1140) runs them
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
// last symbol codes[n1 - 1] is its own '$'. In `doubled` mode (ws = 0,
// W = 2 n1 - 1, no probe rows) the direct text is the table engine's
// doubled text: codes[0, n1) ('$' last), then the appended half T(genome)
// read through the transform (q - n1 in it), 0 past W; rows r >= n1 carry
// the flag. Row
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
// and must read one code byte per row. A thread that builds its row from
// scratch (k byte loads and k 64-bit fold steps: ~200 instructions a row
// at k = 20) is instruction-bound at 8-10x the store time. Design: a block
// takes a tile of consecutive direct rows, or of consecutive lanes of one
// chunk (a host tile table per chunk, kernels/pack_keys.py probe_tiles:
// the chunk is found once a tile), and
//   1. stages the tile's codes in shared memory with 16-byte loads: each
//      tile position is read from at most two affine segments of the codes
//      (the direct text; or the doubled text's genome half and its
//      appended half, read backwards for -R), every per-position rule
//      applied once per byte as it lands: the zeros past W - 1 or W and
//      past the probe source, the byte order of a reversed read, and the
//      complement, four bytes at a time by one byte permute over the
//      table kComp = {0, 5, 3, 2, 4, 1, 0, 0};
//   2. rolls the keys: a thread takes kDirectPer consecutive rows (or
//      kProbePer lanes), folds the first k-mer from k shared symbols and
//      shifts one new symbol in a row (step = k/2 a lane): a 3k-bit word
//      for k <= 20, a (hi, lo) pair of 30-bit words past it;
//   3. stages the keys in shared memory (slots swizzled so that neither
//      the thread's writes nor the warp's reads conflict) and writes them
//      out in order, 16 bytes a store where the output is aligned.
// Two kernels behind the one entry: the direct tiles, then the probe tiles
// and the pad rows.
#include "common.cuh"

namespace {

constexpr long long kPlaneMax = 0x7FFFFFFF;       // JAX sentinel plane
constexpr long long kLoClamp = (1LL << 30) - 1;   // the lo clamp
constexpr int kPackThreads = 256;
// rows (lanes) a thread rolls; kernels/pack_keys.py KA_DIRECT_TILE and
// KA_PROBE_TILE are the tiles
constexpr int kDirectPer = 8;
constexpr int kProbePer = 4;
constexpr int kDirectRows = kPackThreads * kDirectPer;
constexpr int kProbeLanes = kPackThreads * kProbePer;
constexpr int kMaxK = 30;
constexpr int kMaxStep = kMaxK / 2;
// staged codes: a tile's positions plus, for each of its (at most two)
// segments, the partial lines at its ends
constexpr int kDirectBuf = (kDirectRows + kMaxK + 64 + 15) / 16 * 16;
constexpr int kProbeBuf =
    ((kProbeLanes - 1) * kMaxStep + kMaxK + 32 + 15) / 16 * 16;

// Tile positions [pb, pe) read the codes at a + (i - pb), or a - (i - pb)
// when rev; complemented when comp; positions from ve on are 0.
struct Seg {
  long long pb, pe, ve, a;
  int rev, comp;
};

__device__ __forceinline__ unsigned bswap4(unsigned x) {
  return __byte_perm(x, 0, 0x0123);
}

// kComp of each byte of x (codes 0..5; selector nibble = the code)
__device__ __forceinline__ unsigned comp4(unsigned x) {
  const unsigned sel = (x & 0x7u) | ((x >> 4) & 0x70u) |
                       ((x >> 8) & 0x700u) | ((x >> 12) & 0x7000u);
  return __byte_perm(0x02030500u, 0x00000104u, sel);
}

// bytes [lo, hi) of the 16 kept, the rest 0
__device__ __forceinline__ uint4 keep_bytes(uint4 v, long long lo,
                                            long long hi) {
  unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    if (b < lo || b >= hi) w[b >> 2] &= ~(0xFFu << (8 * (b & 3)));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Stages segment s into buf from slot `base` (16-aligned): slot i + off
// holds position i. Sets *used to the slots it takes (a multiple of 16).
__device__ __forceinline__ int stage(const uint8_t* __restrict__ codes,
                                     long long n1, const Seg& s,
                                     uint8_t* buf, int base, int* used) {
  if (s.pe <= s.pb) {
    *used = 0;
    return 0;
  }
  // the line of 16 bytes (aligned in the address space) holding a
  const int mis = (int)(((unsigned long long)codes + s.a) & 15);
  const int delta = s.rev ? 15 - mis : mis;
  const long long A0 = s.a - mis;
  const int lines = (int)((delta + (s.pe - s.pb) + 15) >> 4);
  const int off = base + delta - (int)s.pb;
  for (int l = threadIdx.x; l < lines; l += kPackThreads) {
    const long long A = s.rev ? A0 - 16LL * l : A0 + 16LL * l;
    uint4 v;
    if (A >= 0 && A + 16 <= n1) {
      v = __ldg(reinterpret_cast<const uint4*>(codes + A));
    } else {
      unsigned w[4] = {0, 0, 0, 0};
      for (int b = 0; b < 16; ++b) {
        if (A + b >= 0 && A + b < n1) {
          w[b >> 2] |= (unsigned)__ldg(codes + A + b) << (8 * (b & 3));
        }
      }
      v = make_uint4(w[0], w[1], w[2], w[3]);
    }
    if (s.rev) v = make_uint4(bswap4(v.w), bswap4(v.z), bswap4(v.y),
                              bswap4(v.x));
    if (s.comp) v = make_uint4(comp4(v.x), comp4(v.y), comp4(v.z),
                               comp4(v.w));
    // the position the line's first slot holds
    const long long p0 = (long long)base + 16 * l - off;
    if (p0 < s.pb || p0 + 16 > s.ve) v = keep_bytes(v, s.pb - p0, s.ve - p0);
    *reinterpret_cast<uint4*>(buf + base + 16 * l) = v;
  }
  *used = lines * 16;
  return off;
}

// Staging slots of tile row m: the thread of rows [kPer t, kPer (t + 1))
// writes one row of each of its kPer steps while a warp reads 32
// consecutive rows, both without bank conflicts (the XOR stays inside an
// aligned group of 8, so the slots of a tile are a permutation of it).
template <int kPer>
__device__ __forceinline__ int slot8(int m) {
  return m ^ ((m >> 4) & (kPer - 1));
}
template <int kPer>
__device__ __forceinline__ int slot4(int m) {
  return m ^ ((m >> 5) & (kPer - 1));
}

// The staged keys of rows [0, cnt) out to out[0, cnt) in order.
template <int kPer>
__device__ __forceinline__ void write_keys(long long* out,
                                           const long long* st, int cnt) {
  if ((reinterpret_cast<unsigned long long>(out) & 15) == 0) {
    for (int p = threadIdx.x; 2 * p + 1 < cnt; p += kPackThreads) {
      longlong2 v;
      v.x = st[slot8<kPer>(2 * p)];
      v.y = st[slot8<kPer>(2 * p + 1)];
      reinterpret_cast<longlong2*>(out)[p] = v;
    }
    if ((cnt & 1) && threadIdx.x == 0) out[cnt - 1] = st[slot8<kPer>(cnt - 1)];
  } else {
    for (int m = threadIdx.x; m < cnt; m += kPackThreads) {
      out[m] = st[slot8<kPer>(m)];
    }
  }
}

template <int kPer>
__device__ __forceinline__ void write_lo(int* out, const int* st, int cnt) {
  for (int m = threadIdx.x; m < cnt; m += kPackThreads) {
    out[m] = st[slot4<kPer>(m)];
  }
}

// A rolling k-mer: one 3k-bit word (kWords 1), or the last 10 symbols in
// lo and the k - 10 before them in hi (kWords 2).
template <int kWords>
struct Roll {
  unsigned long long hi, lo;
  unsigned long long mask;  // 3k bits (kWords 1) or 3(k - 10) bits of hi
  __device__ __forceinline__ explicit Roll(int k)
      : hi(0), lo(0),
        mask((1ULL << (3 * (kWords == 1 ? k : k - 10))) - 1) {}
  __device__ __forceinline__ void push(unsigned s) {
    if constexpr (kWords == 1) {
      lo = ((lo << 3) | s) & mask;
    } else {
      hi = ((hi << 3) | (lo >> 27)) & mask;
      lo = ((lo << 3) | s) & (unsigned long long)kLoClamp;
    }
  }
  // the tile's staged key words of this k-mer (flag in w0's bit 0)
  template <int kPer>
  __device__ __forceinline__ void emit(int m, int flag, long long* st_key,
                                       int* st_lo) const {
    if constexpr (kWords == 1) {
      const long long h = (long long)(lo >> 30);
      const long long l = (long long)(lo & (unsigned long long)kLoClamp);
      st_key[slot8<kPer>(m)] = (h << 31) | (l << 1) | flag;
    } else {
      st_key[slot8<kPer>(m)] =
          (long long)(((hi >> 30) << 31) | (hi & (unsigned long long)kLoClamp));
      st_lo[slot4<kPer>(m)] = (int)((lo << 1) | (unsigned long long)flag);
    }
  }
};

template <int kWords>
__global__ void __launch_bounds__(kPackThreads)
pack_direct_kernel(const uint8_t* __restrict__ codes, long long n1,
                   long long W, long long ws, int k, int reverse,
                   int complement, int doubled, long long* __restrict__ key,
                   int* __restrict__ key_lo) {
  __shared__ __align__(16) uint8_t buf[kDirectBuf];
  __shared__ __align__(16) long long st_key[kDirectRows];
  __shared__ __align__(16) int st_lo[kWords == 2 ? kDirectRows : 1];
  const long long r0 = (long long)blockIdx.x * kDirectRows;
  const int cnt = (int)(W - r0 < kDirectRows ? W - r0 : kDirectRows);
  const long long L = cnt + k - 1;
  auto clampL = [&](long long x) { return x < 0 ? 0 : (x > L ? L : x); };
  Seg s1, s2;
  if (!doubled) {  // the window text, '$' and zeros from row W - 1
    s1 = Seg{0, L, clampL(W - 1 - r0), ws + r0, 0, 0};
    s2 = Seg{L, L, L, 0, 0, 0};
  } else {  // the genome half, then T(genome) from n1, zeros from W
    const long long p1 = clampL(n1 - r0);
    s1 = Seg{0, p1, p1, r0, 0, 0};
    const long long a = r0 + p1 - n1;  // in the appended half at p1
    s2 = Seg{p1, L, clampL(W - r0), reverse ? n1 - 2 - a : a, reverse,
             complement};
  }
  int used1, used2;
  const int off1 = stage(codes, n1, s1, buf, 0, &used1);
  const int off2 = stage(codes, n1, s2, buf, used1, &used2);
  __syncthreads();
  const int p1 = (int)s1.pe;
  auto sym = [&](int i) -> unsigned {
    return buf[i + (i < p1 ? off1 : off2)];
  };
  const int m0 = threadIdx.x * kDirectPer;
  if (m0 < cnt) {
    Roll<kWords> roll(k);
    for (int t = 0; t < k - 1; ++t) roll.push(sym(m0 + t));
#pragma unroll
    for (int i = 0; i < kDirectPer; ++i) {
      const int m = m0 + i;
      if (m < cnt) {
        roll.push(sym(m + k - 1));
        roll.template emit<kDirectPer>(m, doubled && r0 + m >= n1, st_key,
                                       st_lo);
      }
    }
  }
  __syncthreads();
  write_keys<kDirectPer>(key + r0, st_key, cnt);
  if constexpr (kWords == 2) write_lo<kDirectPer>(key_lo + r0, st_lo, cnt);
}

// Probe tiles: tile_off[c] is chunk c's first tile (n_chunks + 1
// entries); tiles from live_tiles on hold the pad rows.
template <int kWords>
__global__ void __launch_bounds__(kPackThreads)
pack_probe_kernel(const uint8_t* __restrict__ codes, long long n1,
                  const long long* __restrict__ lane_off,
                  const long long* __restrict__ tile_off,
                  const long long* __restrict__ x0cl, int n_chunks,
                  long long live_tiles, long long n_live, long long W,
                  long long total, int k, int reverse, int complement,
                  long long* __restrict__ key, int* __restrict__ key_lo,
                  uint8_t* __restrict__ lane_mask) {
  __shared__ __align__(16) uint8_t buf[kProbeBuf];
  __shared__ __align__(16) long long st_key[kProbeLanes];
  __shared__ __align__(16) int st_lo[kWords == 2 ? kProbeLanes : 1];
  __shared__ uint8_t st_mask[kProbeLanes];
  const long long tile = blockIdx.x;
  if (tile >= live_tiles) {  // pad rows: the JAX sentinel, masked out
    const long long l0 = n_live + (tile - live_tiles) * kProbeLanes;
    const int cnt =
        (int)(total - l0 < kProbeLanes ? total - l0 : kProbeLanes);
    for (int m = threadIdx.x; m < cnt; m += kPackThreads) {
      if constexpr (kWords == 1) {
        key[W + l0 + m] = (kPlaneMax << 31) | (kLoClamp << 1) | 1;
      } else {
        key[W + l0 + m] = (kPlaneMax << 31) | kPlaneMax;
        key_lo[W + l0 + m] = (int)((kLoClamp << 1) | 1);
      }
      lane_mask[l0 + m] = 0;
    }
    return;
  }
  const int c = asgart::chunk_of(tile_off, n_chunks, tile);
  const long long j0 = (tile - tile_off[c]) * kProbeLanes;
  const long long lane0 = lane_off[c] + j0;
  const long long nc = lane_off[c + 1] - lane_off[c];
  const int cnt = (int)(nc - j0 < kProbeLanes ? nc - j0 : kProbeLanes);
  const long long x0 = x0cl[2 * c], cl = x0cl[2 * c + 1];
  const int step = k / 2;
  const long long L = (long long)(cnt - 1) * step + k;
  const long long qb = x0 + j0 * step;  // the tile's first position
  const bool transformed = reverse || complement;
  // the probe source: the transformed half T(codes[0, n1 - 1)) (reversed
  // index n1 - 2 - q), or the direct text codes[0, n1); zeros past it
  const long long qmax = transformed ? n1 - 1 : n1;
  const long long ve = qmax - qb < 0 ? 0 : (qmax - qb > L ? L : qmax - qb);
  const Seg s{0, L, ve, reverse ? n1 - 2 - qb : qb, reverse, complement};
  int used;
  const int off = stage(codes, n1, s, buf, 0, &used);
  __syncthreads();
  const int m0 = threadIdx.x * kProbePer;
  if (m0 < cnt) {
    Roll<kWords> roll(k);
    for (int t = 0; t < k; ++t) roll.push(buf[m0 * step + t + off]);
#pragma unroll
    for (int i = 0; i < kProbePer; ++i) {
      const int m = m0 + i;
      if (m < cnt) {
        if (i > 0) {
          const int p = m * step + k - step + off;
          for (int t = 0; t < step; ++t) roll.push(buf[p + t]);
        }
        // lo < 2^30 by construction: the JAX clamp of lo holds
        roll.template emit<kProbePer>(m, 1, st_key, st_lo);
        const int first = buf[m * step + off];
        st_mask[m] = first != 4 && (j0 + m) * step < cl - k - step;
      }
    }
  }
  __syncthreads();
  write_keys<kProbePer>(key + W + lane0, st_key, cnt);
  if constexpr (kWords == 2) write_lo<kProbePer>(key_lo + W + lane0, st_lo, cnt);
  for (int m = threadIdx.x; m < cnt; m += kPackThreads) {
    lane_mask[lane0 + m] = st_mask[m];
  }
}

template <int kWords>
cudaError_t launch(const uint8_t* codes, long long n1,
                   const long long* lane_off, const long long* tile_off,
                   const long long* x0cl, int n_chunks, long long live_tiles,
                   long long n_live, long long W, long long ws,
                   long long total, int k, int reverse, int complement,
                   int doubled, long long* key, int* key_lo,
                   uint8_t* lane_mask, cudaStream_t s) {
  if (W > 0) {
    pack_direct_kernel<kWords>
        <<<(unsigned)((W + kDirectRows - 1) / kDirectRows), kPackThreads, 0,
           s>>>(codes, n1, W, ws, k, reverse, complement, doubled, key,
                key_lo);
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return rc;
  }
  if (total > 0) {
    const long long tiles =
        live_tiles + (total - n_live + kProbeLanes - 1) / kProbeLanes;
    pack_probe_kernel<kWords><<<(unsigned)tiles, kPackThreads, 0, s>>>(
        codes, n1, lane_off, tile_off, x0cl, n_chunks, live_tiles, n_live, W,
        total, k, reverse, complement, key, key_lo, lane_mask);
  }
  return cudaGetLastError();
}

}  // namespace

// key_lo == nullptr: one int64 word per row into `key` (k <= 20);
// otherwise w1 into `key` (int64) and w0 into `key_lo` (int32). lane_off
// and tile_off: n_chunks + 1 int64 each on the card (each chunk's first
// lane and first probe tile; live_tiles = tile_off[n_chunks], n_live =
// lane_off[n_chunks]), x0cl: n_chunks (x0, cl) pairs.
ASGART_API int asgart_pack_keys(const void* codes, long long n1,
                                const void* lane_off, const void* tile_off,
                                const void* x0cl, int n_chunks,
                                long long live_tiles, long long n_live,
                                long long W, long long ws, long long total,
                                int k, int reverse, int complement,
                                int doubled, void* key, void* key_lo,
                                void* lane_mask, void* stream) {
  if (k < 2 || k > kMaxK || n_live > total) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const auto* c = (const uint8_t*)codes;
  const auto* off = (const long long*)lane_off;
  const auto* toff = (const long long*)tile_off;
  const auto* xc = (const long long*)x0cl;
  if (key_lo == nullptr) {
    return (int)launch<1>(c, n1, off, toff, xc, n_chunks, live_tiles, n_live,
                          W, ws, total, k, reverse, complement, doubled,
                          (long long*)key, nullptr, (uint8_t*)lane_mask, s);
  }
  return (int)launch<2>(c, n1, off, toff, xc, n_chunks, live_tiles, n_live,
                        W, ws, total, k, reverse, complement, doubled,
                        (long long*)key, (int*)key_lo, (uint8_t*)lane_mask,
                        s);
}

ASGART_API const char* asgart_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}
