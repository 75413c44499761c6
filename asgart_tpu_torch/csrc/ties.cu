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
//       skey; sa[slots[r]] = p, rank[p] = slots[s]; outputs p, slots[s]
//       and still[r] = the sub-run is longer than one.
//
// Bound on the H100: KE reads 12 B per entry in order plus one random
// 4-byte rank gather and writes 8 B; KF reads 8 B of keys and 8 B of
// order in order, gathers ps, and scatters 4 B into sa (slots ascending,
// so nearly coalesced) and 4 B into rank (random). Both are memory-bound
// with a random access per entry. The JAX cummax scan over sub-run starts
// is a cross-block dependency on a GPU; KF finds each entry's sub-run
// start by galloping back over the sorted keys (asgart::run_start), so
// entries deep in long runs (the repeat-dense case) pay O(log run) cached
// reads and nothing crosses blocks. One thread per entry, grid-stride.
//
// KK and KL replace asgart_tpu/device_index.py:769 _full_round, which the
// JAX package's _resolve_ties (:807) runs while the tied count exceeds
// tied_cap (the table build of a repeat-dense text; default n // 8), with
// the undecimated rank of the port's tables (dec_step = 0).
//   KK  row i of the current order, p = sa[i]: key[i] = (rank[p] << 32) |
//       ((p >= direct_bound) << 31) | (sec + 1), sec = rank[p + h] when
//       p < n - h, else -1 (past the text, the JAX clamp). rank < 2^31 and
//       sec + 1 < 2^31, so the 63-bit key orders as the JAX (prim, flag,
//       sec) sort keys.
//   (the caller sorts key stably: skey, order)
//   KL  per sorted row r: p = sa[order[r]] into the new order; the run
//       start s of r in skey; rank[p] = s (a permutation scatter: every
//       position is written once); tied[r] = the run is longer than one
//       and p is direct (p < direct_bound).
// Bound on the H100: KK reads sa in order and two random 4-byte ranks and
// writes 8 B per row; KL reads 16 B per row in order, gathers 4 B of sa and
// scatters 4 B of rank, and writes 5 B. Both memory-bound, each random
// access its own sector. Run starts by galloping back (asgart::run_start),
// as KF finds them. KL's random store, one DRAM sector a row into a plane
// larger than the L2, is most of its time, so KL is two steps
// (kernels/ties.py): here its in-order pass, which writes new_sa, the run
// start s[r] and tied[r], all coalesced (the gather sa[order[r]] reads near
// r: the sort is stable and KK's primary key is a run start of the current
// order); then rank[new_sa] = s through KC's partitioned scatter with no
// lanes (csrc/invert.cu, asgart_invert_fused with M = W = n), whose random
// stores all land in shared memory.
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

__global__ void tie_refine_kernel(const long long* __restrict__ skey,
                                  const long long* __restrict__ order,
                                  const int* __restrict__ slots,
                                  const int* __restrict__ ps, long long n,
                                  int* __restrict__ sa,
                                  int* __restrict__ rank,
                                  int* __restrict__ p_sorted,
                                  int* __restrict__ rs_out,
                                  uint8_t* __restrict__ still) {
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < n; r += (long long)gridDim.x * blockDim.x) {
    const long long v = skey[r];
    const int p = __ldg(ps + order[r]);
    const long long s = asgart::run_start(
        r, [&](long long j) { return __ldg(skey + j) == v; });
    const int rs = __ldg(slots + s);
    sa[__ldg(slots + r)] = p;
    rank[p] = rs;
    p_sorted[r] = p;
    rs_out[r] = rs;
    still[r] = s < r || (r + 1 < n && __ldg(skey + r + 1) == v);
  }
}

__global__ void full_round_keys_kernel(const int* __restrict__ sa,
                                       const int* __restrict__ rank,
                                       long long n, long long h,
                                       long long direct_bound,
                                       long long* __restrict__ key) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    const long long p = sa[i];
    const long long prim = __ldg(rank + p);
    const long long sec = p < n - h ? (long long)__ldg(rank + p + h) : -1;
    key[i] = (prim << 32) | ((long long)(p >= direct_bound) << 31) |
             (sec + 1);
  }
}

__global__ void full_round_refine_kernel(const long long* __restrict__ skey,
                                         const long long* __restrict__ order,
                                         const int* __restrict__ sa,
                                         long long n, long long direct_bound,
                                         int* __restrict__ new_sa,
                                         int* __restrict__ run_start,
                                         uint8_t* __restrict__ tied) {
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < n; r += (long long)gridDim.x * blockDim.x) {
    const long long v = skey[r];
    const int p = __ldg(sa + order[r]);
    const long long s = asgart::run_start(
        r, [&](long long j) { return __ldg(skey + j) == v; });
    new_sa[r] = p;
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

ASGART_API int asgart_tie_refine(const void* skey, const void* order,
                                 const void* slots, const void* ps,
                                 long long n, void* sa, void* rank,
                                 void* p_sorted, void* rs, void* still,
                                 void* stream) {
  tie_refine_kernel<<<asgart::grid_for(n), asgart::kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const long long*)skey, (const long long*)order, (const int*)slots,
      (const int*)ps, n, (int*)sa, (int*)rank, (int*)p_sorted, (int*)rs,
      (uint8_t*)still);
  return (int)cudaGetLastError();
}

ASGART_API int asgart_full_round_keys(const void* sa, const void* rank,
                                      long long n, long long h,
                                      long long direct_bound, void* key,
                                      void* stream) {
  full_round_keys_kernel<<<asgart::grid_for(n), asgart::kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const int*)sa, (const int*)rank, n, h, direct_bound, (long long*)key);
  return (int)cudaGetLastError();
}

// KL's in-order pass (its scatter is KC's: kernels/ties.py).
ASGART_API int asgart_full_round_refine(const void* skey, const void* order,
                                        const void* sa, long long n,
                                        long long direct_bound, void* new_sa,
                                        void* run_start, void* tied,
                                        void* stream) {
  full_round_refine_kernel<<<asgart::grid_for(n), asgart::kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const long long*)skey, (const long long*)order, (const int*)sa, n,
      direct_bound, (int*)new_sa, (int*)run_start, (uint8_t*)tied);
  return (int)cudaGetLastError();
}
