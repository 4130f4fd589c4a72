// Warp-cooperative running top-k shared by the retrieval kernels.
//
// A list holds k (score, id) pairs in shared memory, sorted by score
// descending. A new entry goes after every entry with an equal or higher
// score, so when candidates arrive in increasing id order, equal scores
// keep the lower id first: the tie order of lax.top_k in the JAX package.
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
