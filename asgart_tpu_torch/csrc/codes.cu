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
// LUT [1, 2, 3, 5] (A, C, G, T ranks); then one thread per exception
// writes its code over it. Positions are unique, so the scatter has no
// races, and stream order puts it after the unpack.
//
// Bound on the H100: bytes. It reads n1 / 4 packed bytes and writes n1
// codes once, plus 9 B read and 1 B written per exception, with no reuse.
// Design: a thread takes 4 consecutive packed bytes (one 32-bit load) and
// writes 4 codes into each quarter (one 32-bit store per quarter), so a
// warp's loads and each quarter's stores are contiguous; this needs n4 to
// be a multiple of 4 and both pointers 4-byte aligned, else every thread
// takes one byte. Positions at or past n1 (the last quarter's padding) are
// not written.
#include "common.cuh"

namespace {

// 2-bit value -> symbol rank: A = 1, C = 2, G = 3, T = 5
__device__ __forceinline__ uint8_t rank_of(unsigned v) {
  return (uint8_t)(v + 1 + (v == 3));
}

__global__ void unpack_kernel(const uint8_t* __restrict__ packed,
                              long long n4, long long n1,
                              uint8_t* __restrict__ codes, int vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (vec) {
    const long long n_vec = n4 / 4;
    for (long long t = tid; t < n_vec; t += stride) {
      const unsigned word = reinterpret_cast<const unsigned*>(packed)[t];
      const long long j = 4 * t;
      for (int q = 0; q < 4; ++q) {
        const long long pos = q * n4 + j;
        unsigned out = 0;
        for (int b = 0; b < 4; ++b) {
          out |= (unsigned)rank_of((word >> (8 * b + 2 * q)) & 3) << (8 * b);
        }
        if (pos + 3 < n1) {
          reinterpret_cast<unsigned*>(codes + pos)[0] = out;
        } else {
          for (int b = 0; b < 4 && pos + b < n1; ++b) {
            codes[pos + b] = (uint8_t)(out >> (8 * b));
          }
        }
      }
    }
    return;
  }
  for (long long j = tid; j < n4; j += stride) {
    const unsigned byte = packed[j];
    for (int q = 0; q < 4; ++q) {
      const long long pos = q * n4 + j;
      if (pos < n1) codes[pos] = rank_of((byte >> (2 * q)) & 3);
    }
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
    const int vec = n4 % 4 == 0 && ((uintptr_t)packed & 3) == 0 &&
                    ((uintptr_t)codes & 3) == 0;
    unpack_kernel<<<asgart::grid_for(vec ? n4 / 4 : n4), asgart::kThreads, 0,
                    s>>>((const uint8_t*)packed, n4, n1, (uint8_t*)codes,
                         vec);
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
