// Warp-cooperative running top-k shared by the retrieval kernels.
//
// A list holds k (score, id) pairs in shared memory, sorted by score
// descending. A new entry goes after every entry with an equal or higher
// score, so when candidates arrive in increasing id order, equal scores
// keep the lower id first: the tie order of lax.top_k in the JAX package.
// Candidates enter one at a time (warp_list_insert) or in batches from a
// buffer (merge_buffer), ranked by (score, id).
#pragma once

#include <cuda_runtime.h>

constexpr float TOPK_NEG = -3.0e38f;   // the JAX package's NEG sentinel
constexpr int TOPK_MAX_K = 128;        // four list entries per lane
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

// Fill a list with (TOPK_NEG, -1): the padding of a row with fewer than k
// live candidates.
__device__ __forceinline__ void list_clear(float* ls, int* li, int n,
                                           int tid, int nthreads) {
  for (int e = tid; e < n; e += nthreads) {
    ls[e] = TOPK_NEG;
    li[e] = -1;
  }
}

// Insert (s, id) into the list (ls, li) of length k. All 32 lanes of the
// warp call it with the same (s, id), and the caller has checked that
// s > ls[k - 1], so the entry lands at a position below k.
__device__ __forceinline__ void warp_list_insert(float* ls, int* li, int k,
                                                 float s, int id, int lane) {
  int cnt = 0;
  for (int e = lane; e < k; e += 32) cnt += (ls[e] >= s);
  cnt = warp_sum(cnt);
  float ts[4] = {0.f, 0.f, 0.f, 0.f};
  int ti[4] = {0, 0, 0, 0};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int e = lane + 32 * t;
    if (e >= cnt && e < k - 1) {
      ts[t] = ls[e];
      ti[t] = li[e];
    }
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int e = lane + 32 * t;
    if (e >= cnt && e < k - 1) {
      ls[e + 1] = ts[t];
      li[e + 1] = ti[t];
    }
  }
  if (lane == 0) {
    ls[cnt] = s;
    li[cnt] = id;
  }
  __syncwarp();
}

// (as, ar) comes before (bs, br) in a list: higher score, or the lower
// row on equal scores; padding (TOPK_NEG, -1) comes after every candidate
__device__ __forceinline__ bool before(float as, int ar, float bs, int br) {
  return as > bs || (as == bs && ar < br);
}

// Merge the nb <= 32 E unordered candidates of a buffer (bs, bi) into the
// list (ls, li) of length k <= TOPK_MAX_K, sorted by `before`: the whole
// warp computes each entry's rank in the union (a list entry's index plus
// the buffer candidates before it; a buffer candidate's place in the list,
// found by binary search, plus the buffer candidates before it) and
// scatters the entries of rank below k. Ids are distinct, so the ranks
// are. Returns the list's new k-th score.
template <int E>
__device__ __forceinline__ float merge_buffer(float* ls, int* li, int k,
                                              const float* bs, const int* bi,
                                              int nb, int lane) {
  __syncwarp();   // the buffer's candidates, stored by any lane
  float ys[E];
  int yi[E], ry[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {   // lane + 32 e; padding past nb
    const bool has = lane + 32 * e < nb;
    ys[e] = has ? bs[lane + 32 * e] : TOPK_NEG;
    yi[e] = has ? bi[lane + 32 * e] : -1;
    int lo = 0, hi = k;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (before(ls[mid], li[mid], ys[e], yi[e]))
        lo = mid + 1;
      else
        hi = mid;
    }
    ry[e] = lo;
  }
  float xs[4];
  int xi[4], rx[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int e = lane + 32 * t;
    xs[t] = e < k ? ls[e] : TOPK_NEG;
    xi[t] = e < k ? li[e] : -1;
    rx[t] = e;
  }
  // every lane's candidates against this lane's: padding comes before
  // nothing, so all 32 lanes go through
#pragma unroll 4
  for (int l = 0; l < 32; ++l) {
#pragma unroll
    for (int e2 = 0; e2 < E; ++e2) {
      const float s = __shfl_sync(FULL_MASK, ys[e2], l);
      const int r = __shfl_sync(FULL_MASK, yi[e2], l);
#pragma unroll
      for (int e = 0; e < E; ++e) ry[e] += before(s, r, ys[e], yi[e]);
#pragma unroll
      for (int t = 0; t < 4; ++t) rx[t] += before(s, r, xs[t], xi[t]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < 4; ++t)
    if (lane + 32 * t < k && rx[t] < k) {
      ls[rx[t]] = xs[t];
      li[rx[t]] = xi[t];
    }
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (lane + 32 * e < nb && ry[e] < k) {
      ls[ry[e]] = ys[e];
      li[ry[e]] = yi[e];
    }
  __syncwarp();
  return ls[k - 1];
}
