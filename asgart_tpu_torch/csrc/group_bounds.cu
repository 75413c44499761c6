// KB group_bounds: equal-key run boundaries over the sorted fused keys.
//
// Replaces (JAX reference): asgart_tpu/device_index.py:352
// _group_bounds_impl in flagged mode (jitted as _group_bounds, :421; with
// the third plane `sktop` as _group_bounds3, :429, for k = 21..30).
//
//   run_lo[i]  start of row i's true-key run (flag bit dropped)
//   run_hi[i]  run_lo[i] for direct rows (sa < W); for probe rows the
//              start of the full-key run, i.e. the end of the group's
//              direct entries
//   tied[i]    direct row whose full-key run has length > 1
//
// The key is one int64 word (k <= 20, flag in bit 0) or two words (k =
// 21..30: w1 int64, w0 int32 with the flag in bit 0), one template each.
//
// Two options serve the table build (the JAX _group_bounds with flag_n_k
// = k, :352-420): n_shift >= 0 sets run_lo's sign bit where the row's
// first symbol, (first word >> n_shift) & 7, is N (rank 4), the N-probe
// flag that KJ carries into position space; run_end gives direct rows
// their run end (exclusive) in run_hi, as the JAX unflagged mode's
// reverse cummin does for a text without an appended half.
// The JAX package finds run starts with a cummax scan, which on a GPU
// needs a cross-block pass. Here every row finds its own run start by a
// galloping search backwards over the sorted keys (asgart::run_start): no
// cross-block dependency, and O(log run length) reads per row. Bound on
// the H100: memory — each row reads its own key and its neighbours'
// (shared through L1 by adjacent threads) and writes 9 B; only rows
// inside long runs (repeat k-mers) pay extra, cached, reads.
#include "common.cuh"

namespace {

// One int64 word: (key >> shift) is the flag-free key for shift 1.
struct Word1 {
  const long long* key;
  struct V {
    long long a;
    __device__ bool operator==(const V& o) const { return a == o.a; }
  };
  __device__ V at(long long i, int shift) const {
    return {__ldg(key + i) >> shift};
  }
};

// Two words, ordered (w1, w0): the flag is bit 0 of w0.
struct Word2 {
  const long long* w1;
  const int* w0;
  struct V {
    long long a;
    int b;
    __device__ bool operator==(const V& o) const {
      return a == o.a && b == o.b;
    }
  };
  __device__ V at(long long i, int shift) const {
    return {__ldg(w1 + i), __ldg(w0 + i) >> shift};
  }
};

template <class Keys>
__global__ void group_bounds_kernel(Keys keys, const int* __restrict__ sa,
                                    long long M, long long W,
                                    int n_shift, int run_end,
                                    int* __restrict__ run_lo,
                                    int* __restrict__ run_hi,
                                    uint8_t* __restrict__ tied) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < M; i += (long long)gridDim.x * blockDim.x) {
    const auto full = keys.at(i, 0);
    const auto flagless = keys.at(i, 1);
    const bool direct = sa[i] < W;
    const auto same_full = [&](long long j) { return keys.at(j, 0) == full; };
    const long long lo = asgart::run_start(
        i, [&](long long j) { return keys.at(j, 1) == flagless; });
    const bool n_probe = n_shift >= 0 && ((full.a >> n_shift) & 7) == 4;
    run_lo[i] = (int)lo | (n_probe ? (int)0x80000000u : 0);
    run_hi[i] = (int)(!direct ? asgart::run_start(i, same_full)
                      : run_end ? asgart::run_end(i, M, same_full) : lo);
    const bool starts = i == 0 || !(keys.at(i - 1, 0) == full);
    const bool ends = i == M - 1 || !(keys.at(i + 1, 0) == full);
    tied[i] = direct && !(starts && ends);
  }
}

}  // namespace

// skey_lo == nullptr: one int64 word `skey`; otherwise the two words
// (skey, skey_lo).
ASGART_API int asgart_group_bounds(const void* skey, const void* skey_lo,
                                   const void* sa, long long M, long long W,
                                   int n_shift, int run_end, void* run_lo,
                                   void* run_hi, void* tied, void* stream) {
  const unsigned grid = asgart::grid_for(M);
  cudaStream_t s = (cudaStream_t)stream;
  if (skey_lo == nullptr) {
    group_bounds_kernel<<<grid, asgart::kThreads, 0, s>>>(
        Word1{(const long long*)skey}, (const int*)sa, M, W, n_shift,
        run_end, (int*)run_lo, (int*)run_hi, (uint8_t*)tied);
  } else {
    group_bounds_kernel<<<grid, asgart::kThreads, 0, s>>>(
        Word2{(const long long*)skey, (const int*)skey_lo}, (const int*)sa,
        M, W, n_shift, run_end, (int*)run_lo, (int*)run_hi,
        (uint8_t*)tied);
  }
  return (int)cudaGetLastError();
}
