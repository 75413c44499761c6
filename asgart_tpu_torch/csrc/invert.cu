// KC invert_fused: slot-indexed run bounds -> position-indexed rank and
// lane-ordered probe windows, plus per-chunk raw-match totals.
//
// Replaces (JAX reference): asgart_tpu/device_index.py:1519 _invert_fused
// (with _assemble_dec :447, _dec_of :441, _fused_lane_totals :1545).
//
// Every row of the sorted fused index has a unique destination: a direct
// row (sa < W) writes rank[sa] = run_lo, a probe row writes
// lane_lo/hi[sa - W] = run_lo/hi. The JAX package did this with one more
// full sort (scatters were slow on the TPU) into a decimated layout; here
// it is a permutation scatter, and rank stays in plain position layout.
// The totals are exact int64 sums of (lane_hi - lane_lo) over masked
// lanes per chunk (the JAX float32 sums are exact only below 2^24).
//
// Bound on the H100: memory. The scatter reads 12 B per row in order and
// writes 4-8 B to a random-ish address (sa is a permutation), so its
// stores are uncoalesced 32-byte sectors; the totals pass streams 9 B per
// lane. Design: one thread per row; the totals reduce a warp's lanes with
// shuffles when the warp lies inside one chunk (the common case: chunks
// are contiguous lane ranges) and fall back to per-lane atomics at chunk
// edges.
#include "common.cuh"

namespace {

__global__ void invert_scatter_kernel(const int* __restrict__ sa,
                                      const int* __restrict__ run_lo,
                                      const int* __restrict__ run_hi,
                                      long long M, long long W,
                                      int* __restrict__ rank,
                                      int* __restrict__ lane_lo,
                                      int* __restrict__ lane_hi) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < M; i += (long long)gridDim.x * blockDim.x) {
    const long long p = sa[i];
    if (p < W) {
      rank[p] = run_lo[i];
    } else {
      lane_lo[p - W] = run_lo[i];
      lane_hi[p - W] = run_hi[i];
    }
  }
}

__global__ void lane_totals_kernel(const int* __restrict__ lane_lo,
                                   const int* __restrict__ lane_hi,
                                   const uint8_t* __restrict__ lane_mask,
                                   const long long* __restrict__ lane_off,
                                   int n_chunks,
                                   unsigned long long* __restrict__ totals) {
  const unsigned kFull = 0xFFFFFFFFu;
  const long long n_live = lane_off[n_chunks];
  // the loop bound is uniform over the block, so every warp stays
  // converged for the shuffles
  for (long long base = (long long)blockIdx.x * blockDim.x; base < n_live;
       base += (long long)gridDim.x * blockDim.x) {
    const long long lane = base + threadIdx.x;
    int c = -1;
    unsigned long long v = 0;
    if (lane < n_live) {
      c = asgart::chunk_of(lane_off, n_chunks, lane);
      if (lane_mask[lane]) v = (unsigned long long)(lane_hi[lane] -
                                                    lane_lo[lane]);
    }
    const int c0 = __shfl_sync(kFull, c, 0);
    if (__all_sync(kFull, c == c0)) {
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
      if ((threadIdx.x & 31) == 0 && c0 >= 0 && v) atomicAdd(totals + c0, v);
    } else if (c >= 0 && v) {
      atomicAdd(totals + c, v);
    }
  }
}

}  // namespace

ASGART_API int asgart_invert_fused(const void* sa, const void* run_lo,
                                   const void* run_hi, const void* lane_mask,
                                   long long M, long long W,
                                   const void* lane_off, int n_chunks,
                                   void* rank, void* lane_lo, void* lane_hi,
                                   void* totals, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  invert_scatter_kernel<<<asgart::grid_for(M), asgart::kThreads, 0, s>>>(
      (const int*)sa, (const int*)run_lo, (const int*)run_hi, M, W,
      (int*)rank, (int*)lane_lo, (int*)lane_hi);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess || n_chunks == 0) return (int)rc;
  rc = cudaMemsetAsync(totals, 0, sizeof(unsigned long long) * n_chunks, s);
  if (rc != cudaSuccess) return (int)rc;
  lane_totals_kernel<<<asgart::grid_for(M - W), asgart::kThreads, 0, s>>>(
      (const int*)lane_lo, (const int*)lane_hi, (const uint8_t*)lane_mask,
      (const long long*)lane_off, n_chunks, (unsigned long long*)totals);
  return (int)cudaGetLastError();
}
