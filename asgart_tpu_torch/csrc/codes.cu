// KI unpack_codes: the strand's symbol codes from its 2-bit planar packing
// plus its exception list.
//
// Replaces (JAX reference): asgart_tpu/device_index.py:98 _unpack_codes,
// called by DeviceIndex.upload_codes (:1124) and upload_codes_cached (:960)
// on every device path. The host packs A, C, G, T as 0..3 in a planar
// layout (codes.pack_codes, the layout of pack_codes_host, :67): packed
// byte j holds strand positions j, n4 + j, 2*n4 + j and 3*n4 + j (n4 =
// ceil(n1 / 4)) in its bit pairs 0-1, 2-3, 4-5 and 6-7. Every other byte
// ('$', N, IUPAC) is an exception: its position (int64, so strands past
// 2^31 bytes pack too) and its code.
//
// Two launches on one stream: the unpack writes every position through the
// ranks [1, 2, 3, 5] (A, C, G, T); then one thread per exception writes its
// code over it. Positions are unique, so the scatter has no races, and
// stream order puts it after the unpack.
//
// Bound on the H100: bytes. It reads n1 / 4 packed bytes and writes n1
// codes once, plus 9 B read and 1 B written per exception, with no reuse.
//
// Design: a block takes a tile of kTile packed bytes whose start is 16-byte
// aligned in the address space (the first tile begins at byte 0, the last
// ends at n4), one 16-byte load a thread. Each quarter q's span of the
// tile, positions [q * n4 + j0, q * n4 + j0 + kTile), is aligned in the
// codes' address space by its own shift, which depends on n4, q and the
// two pointers but not on the tile. So each thread takes the 16 packed
// bytes under one 16-byte-aligned word of codes from its own load and its
// neighbour's (a shuffle; a warp's last thread takes the next warp's first
// load from shared memory), turns them into 16 codes four to a 32-bit word
// (SWAR: t = (w >> 2q) & 0x03030303 gives t + 0x01010101 + (t & (t >> 1) &
// 0x01010101)), and writes them with one aligned 16-byte store. Byte stores
// are left for the words at the span's two edges, whatever n4 % 16 and
// the pointers' alignments are. Positions at or past n1 (the last
// quarter's padding) are not written.
#include "common.cuh"

namespace {

constexpr int kTile = 16 * asgart::kThreads;  // packed bytes a tile
constexpr int kWarps = asgart::kThreads / 32;

// the symbol ranks of the four bit pairs q of a 32-bit word's bytes
__device__ __forceinline__ unsigned ranks4(unsigned w, int q) {
  const unsigned t = (w >> (2 * q)) & 0x03030303u;
  return t + 0x01010101u + (t & (t >> 1) & 0x01010101u);
}

// bytes [4 D + r, 4 D + r + 16) of the 32 bytes x (r8 = 8 r, r < 4)
template <int D>
__device__ __forceinline__ uint4 window16(const unsigned (&x)[8], int r8) {
  return make_uint4(__funnelshift_r(x[D], x[D + 1], r8),
                    __funnelshift_r(x[D + 1], x[D + 2], r8),
                    __funnelshift_r(x[D + 2], x[D + 3], r8),
                    __funnelshift_r(x[D + 3], x[D + 4], r8));
}

__device__ __forceinline__ uint8_t byte_of(const uint4& w, int m) {
  const unsigned v = m < 4 ? w.x : m < 8 ? w.y : m < 12 ? w.z : w.w;
  return (uint8_t)(v >> (8 * (m & 3)));
}

// the 16 packed bytes from index jw (16-byte aligned in the address
// space): one load inside [0, n4), else the valid bytes and zeros
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ packed,
                                        long long jw, long long n4) {
  if (jw >= 0 && jw + 16 <= n4) {
    return *reinterpret_cast<const uint4*>(packed + jw);
  }
  uint4 u = make_uint4(0, 0, 0, 0);  // the first and the last tile's edges
#pragma unroll 1
  for (int m = 0; m < 16; ++m) {
    if (jw + m >= 0 && jw + m < n4) {
      const unsigned v = (unsigned)packed[jw + m] << (8 * (m & 3));
      if (m < 4) u.x |= v; else if (m < 8) u.y |= v;
      else if (m < 12) u.z |= v; else u.w |= v;
    }
  }
  return u;
}

// the bytes m of the codes word w whose local index s + m lies in [lo, hi)
__device__ __forceinline__ void store_bytes(uint8_t* __restrict__ out,
                                            const uint4& w, int s,
                                            long long lo, long long hi) {
#pragma unroll 1
  for (int m = 0; m < 16; ++m) {
    if (s + m >= lo && s + m < hi) out[s + m] = byte_of(w, m);
  }
}

__global__ void __launch_bounds__(asgart::kThreads)
unpack_kernel(const uint8_t* __restrict__ packed, long long n4, long long n1,
              uint8_t* __restrict__ codes, long long n_tiles) {
  const unsigned kFull = 0xFFFFFFFFu;
  // each warp's first load, by tile parity (one barrier a tile)
  __shared__ uint4 first[2][kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int a = (int)((uintptr_t)packed & 15);
  const long long cmis = (long long)((uintptr_t)codes & 15);
  int parity = 0;
  long long tile = blockIdx.x;
  uint4 u = load16(packed, tile * kTile - a + 16 * tid, n4);
  for (; tile < n_tiles; tile += gridDim.x) {
    const long long j0 = tile * kTile - a;  // packed index of local byte 0
    // the next tile's load, in flight while this tile's codes are stored
    const long long next = tile + gridDim.x;
    const uint4 u_next = next < n_tiles
        ? load16(packed, next * kTile - a + 16 * tid, n4)
        : make_uint4(0, 0, 0, 0);
    if (lane == 0) first[parity][warp] = u;
    __syncthreads();
    uint4 v = make_uint4(__shfl_down_sync(kFull, u.x, 1),
                         __shfl_down_sync(kFull, u.y, 1),
                         __shfl_down_sync(kFull, u.z, 1),
                         __shfl_down_sync(kFull, u.w, 1));
    if (lane == 31) {  // the block's last word reaches past the tile: unused
      v = warp + 1 < kWarps ? first[parity][warp + 1]
                            : make_uint4(0, 0, 0, 0);
    }
    parity ^= 1;
    const unsigned x[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
    // the tile's valid local bytes [i_lo, i_hi)
    const int i_lo = j0 < 0 ? (int)-j0 : 0;
    const long long i_hi = n4 - j0 < kTile ? n4 - j0 : kTile;
#pragma unroll 1
    for (int q = 0; q < 4; ++q) {
      const long long base = q * n4 + j0;  // position of local byte 0
      const long long i_end = n1 - base < i_hi ? n1 - base : i_hi;
      if (i_end <= i_lo) continue;
      // local index of the first 16-byte-aligned codes address
      const int sh = (int)((a - cmis - q * n4) & 15);
      const int r8 = 8 * (sh & 3);
      uint4 w;
      switch (sh >> 2) {
        case 0: w = window16<0>(x, r8); break;
        case 1: w = window16<1>(x, r8); break;
        case 2: w = window16<2>(x, r8); break;
        default: w = window16<3>(x, r8); break;
      }
      const uint4 out = make_uint4(ranks4(w.x, q), ranks4(w.y, q),
                                   ranks4(w.z, q), ranks4(w.w, q));
      const int s = 16 * tid + sh;  // this thread's word, local bytes
      if (s >= i_lo && s + 16 <= i_end) {
        *reinterpret_cast<uint4*>(codes + base + s) = out;
      } else if (s + 16 > i_lo && s < i_end) {  // an edge word
        store_bytes(codes + base, out, s, i_lo, i_end);
      }
      if (tid == 0 && sh > i_lo) {  // the head before the first word
        const uint4 h = make_uint4(ranks4(u.x, q), ranks4(u.y, q),
                                   ranks4(u.z, q), ranks4(u.w, q));
        store_bytes(codes + base, h, 0, i_lo, sh < i_end ? sh : i_end);
      }
    }
    u = u_next;
  }
}

__global__ void scatter_kernel(const long long* __restrict__ exc_pos,
                               const uint8_t* __restrict__ exc_code,
                               long long n_exc, uint8_t* __restrict__ codes) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < n_exc; e += stride) {
    codes[exc_pos[e]] = exc_code[e];
  }
}

}  // namespace

// packed: uint8 [n4]; exc_pos: int64 [n_exc], unique, each < n1; exc_code:
// uint8 [n_exc]; codes: uint8 [n1] out (n1 <= 4 * n4).
ASGART_API int asgart_unpack_codes(const void* packed, long long n4,
                                   long long n1, const void* exc_pos,
                                   const void* exc_code, long long n_exc,
                                   void* codes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n4 > 0) {
    const long long n_tiles =
        (n4 + (long long)((uintptr_t)packed & 15) + kTile - 1) / kTile;
    const long long blocks = n_tiles < 132LL * 32 ? n_tiles : 132LL * 32;
    unpack_kernel<<<(unsigned)blocks, asgart::kThreads, 0, s>>>(
        (const uint8_t*)packed, n4, n1, (uint8_t*)codes, n_tiles);
    cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
  }
  if (n_exc > 0) {
    scatter_kernel<<<asgart::grid_for(n_exc), asgart::kThreads, 0, s>>>(
        (const long long*)exc_pos, (const uint8_t*)exc_code, n_exc,
        (uint8_t*)codes);
  }
  return (int)cudaGetLastError();
}
