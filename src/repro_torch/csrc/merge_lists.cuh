// The last pass of sq8_topk.cu, pq_topk.cu and ivf_topk.cu: the global
// top-k of a query's L sorted candidate lists, launched by the same C entry
// point right after the scan, so a search costs the host one call.
//
// Each list holds k (score, id, order) entries in descending score, equal
// scores by ascending order, padded with (NEG, -1). A candidate ranks by
// one 64-bit key, the score's order-preserving bits (-0.0 as +0.0) above
// the complement of `order` (distinct per query), so no two real
// candidates tie: equal scores keep the lower order, the tie order of
// lax.top_k over the whole score matrix (sq8_topk: order = row; pq_topk
// and ivf_topk: order = probe rank * cap_b + row, the probe-major order of
// merge_candidates). One warp per query merges the lists by their heads:
// lane l watches lists l, l + 32, ...; each of the k rounds takes the
// largest head key over the warp and advances that list. Scores at or
// below NEG/2 come out as (NEG, -1) padding.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_list.cuh"

namespace merge {

constexpr int WARPS = 8;   // queries per block

__device__ __forceinline__ unsigned long long key_of(float s, int order) {
  int b = s == 0.f ? 0 : __float_as_int(s);
  b ^= (b >> 31) & 0x7FFFFFFF;   // signed int order = float order
  const unsigned hi = static_cast<unsigned>(b) ^ 0x80000000u;
  const unsigned lo = 0x7FFFFFFFu - static_cast<unsigned>(order);
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

// cs/ci/co: [nq, L, k] lists' scores, ids and orders (co may be ci);
// top_s/top_i: [nq, k]. Dynamic shared memory: WARPS * L ints.
__global__ void __launch_bounds__(32 * WARPS)
merge_kernel(const float* __restrict__ cs, const int* __restrict__ ci,
             const int* __restrict__ co, float* __restrict__ top_s,
             int* __restrict__ top_i, int nq, int L, int k) {
  extern __shared__ int heads[];   // [WARPS][L]: each list's next entry
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = blockIdx.x * WARPS + warp;
  if (q >= nq) return;   // the whole warp
  int* h = heads + warp * L;
  for (int l = lane; l < L; l += 32) h[l] = 0;
  __syncwarp();
  const size_t base = static_cast<size_t>(q) * L * k;
  for (int r = 0; r < k; ++r) {
    unsigned long long key = 0;
    int at = -1;   // list of the best head; -1: none
    for (int l = lane; l < L; l += 32) {
      const int e = h[l];
      if (e < k) {
        const size_t p = base + static_cast<size_t>(l) * k + e;
        const unsigned long long kl = key_of(cs[p], co[p]);
        if (at < 0 || kl > key) {
          key = kl;
          at = l;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long k2 = __shfl_xor_sync(FULL_MASK, key, off);
      const int a2 = __shfl_xor_sync(FULL_MASK, at, off);
      if (a2 >= 0 && (at < 0 || k2 > key)) {
        key = k2;
        at = a2;
      }
    }
    if (lane == 0) {
      const size_t p =
          at < 0 ? 0 : base + static_cast<size_t>(at) * k + h[at];
      const bool real = at >= 0 && cs[p] > TOPK_NEG / 2;
      top_s[static_cast<size_t>(q) * k + r] = real ? cs[p] : TOPK_NEG;
      top_i[static_cast<size_t>(q) * k + r] = real ? ci[p] : -1;
    }
    __syncwarp();
    if (at >= 0 && lane == at % 32) ++h[at];
    __syncwarp();
  }
}

inline cudaError_t launch_merge(const float* cs, const int* ci, const int* co,
                                float* top_s, int* top_i, int nq, int L,
                                int k, cudaStream_t stream) {
  const size_t smem = sizeof(int) * WARPS * L;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  merge_kernel<<<(nq + WARPS - 1) / WARPS, 32 * WARPS, smem, stream>>>(
      cs, ci, co, top_s, top_i, nq, L, k);
  return cudaGetLastError();
}

}  // namespace merge
