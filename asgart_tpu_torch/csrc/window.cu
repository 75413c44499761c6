// KG offset_slots: shift every slot of a trim window's suffix order by the
// window start, in place, so direct slots hold genome positions.
//
// Replaces (JAX reference): asgart_tpu/device_index.py:1505 _offset_i32,
// called at :1771-1774 after tie resolution. Like it, the probe slots
// (W + lane) shift too: they are never read as positions, and shifting
// them keeps sa equal to the JAX array slot for slot.
//
// Bound on the H100: memory. It reads and writes 4 B per slot once
// (8 B per slot of traffic, no reuse). Design: one grid-stride launch;
// each thread adds to 16-byte int4 vectors (one load and one store
// instruction per 4 slots, coalesced), then the grid's first threads take
// the ragged tail; an unaligned start takes the scalar loop throughout.
#include "common.cuh"

namespace {

__global__ void offset_kernel(int* __restrict__ sa, long long n, int ws,
                              int vec) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long head = 0;
  if (vec) {
    int4* v = reinterpret_cast<int4*>(sa);
    const long long n_vec = n / 4;
    for (long long i = tid; i < n_vec; i += stride) {
      int4 x = v[i];
      x.x += ws;
      x.y += ws;
      x.z += ws;
      x.w += ws;
      v[i] = x;
    }
    head = 4 * n_vec;
  }
  for (long long i = head + tid; i < n; i += stride) sa[i] += ws;
}

}  // namespace

// sa: int32 [n], updated in place (sa[i] += ws).
ASGART_API int asgart_offset_slots(void* sa, long long n, int ws,
                                   void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int vec = ((uintptr_t)sa & 15) == 0;
  offset_kernel<<<asgart::grid_for(vec ? (n + 3) / 4 : n), asgart::kThreads,
                  0, (cudaStream_t)stream>>>((int*)sa, n, ws, vec);
  return (int)cudaGetLastError();
}
