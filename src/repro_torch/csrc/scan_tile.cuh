// Pieces shared by the corpus-tile scans (topk_search.cu over fp32 rows,
// sq8_topk.cu over int8 codes, quant_score.cu): the register-blocked FMA
// loop, the tile's liveness prologue and the fold of a finished score tile
// into the per-query running top-k lists.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "topk_list.cuh"

// acc[i][j] += qb[ty*4+i, :] . cb[tx+16*j, :] over one depth chunk of DK
// floats, both operands in shared memory with row pitch DKP: the 4 x 8
// register block of a 256-thread (16 x 16) block, 8 FMAs per float4 read.
template <int DK, int DKP>
__device__ __forceinline__ void fma_chunk(float (&acc)[4][8], const float* qb,
                                          const float* cb, int tx, int ty) {
#pragma unroll
  for (int kk = 0; kk < DK; kk += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(qb + (ty * 4 + i) * DKP + kk);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 b =
          *reinterpret_cast<const float4*>(cb + (tx + 16 * j) * DKP + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
      }
    }
  }
}

// Called by the whole block. rowok[r] = 1 for each live row of the
// TILE_N-row tile at tile_base; subs[0] = the number of BN-row sub-tiles
// holding a live row, subs[1..] = their indices in order. The caller may
// fill shared memory of its own before the call: the first barrier here
// covers it.
template <int TILE_N, int BN, int THREADS>
__device__ __forceinline__ void live_subtiles(const uint8_t* __restrict__ live,
                                              long long tile_base, int n,
                                              uint8_t* rowok, int* subs,
                                              int tid) {
  constexpr int NSUB = TILE_N / BN;
  for (int r = tid; r < TILE_N; r += THREADS) {
    const long long g = tile_base + r;
    rowok[r] = (g < n && live[g] != 0) ? 1 : 0;
  }
  __syncthreads();
  if (tid < NSUB) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(rowok + tid * BN);
    uint32_t any = 0;
    for (int r = 0; r < BN / 4; ++r) any |= w[r];
    subs[1 + tid] = any != 0;
  }
  __syncthreads();
  if (tid == 0) {   // compact to the list of sub-tiles holding a live row
    int m = 0;
    for (int s = 0; s < NSUB; ++s)
      if (subs[1 + s]) subs[1 + m++] = s;
    subs[0] = m;
  }
  __syncthreads();
}

// Fold the finished score tile sc [BQ][BNP] (dead rows already NEG) of
// rows row0.. into the lists (lsb, lib) [BQ][k], one warp per query row:
// only scores above the list's k-th enter, in row order, so equal scores
// keep the lower row.
template <int BQ, int BN, int BNP, int WARPS>
__device__ __forceinline__ void fold_tile(const float* sc, float* lsb,
                                          int* lib, int k, int q0, int nq,
                                          int row0, int warp, int lane) {
  for (int qq = warp; qq < BQ && q0 + qq < nq; qq += WARPS) {
    float* ls = lsb + qq * k;
    int* li = lib + qq * k;
    float thr = ls[k - 1];
#pragma unroll
    for (int c = 0; c < BN / 32; ++c) {
      const float s = sc[qq * BNP + c * 32 + lane];
      unsigned m = __ballot_sync(FULL_MASK, s > thr);
      while (m) {
        const int src = __ffs(m) - 1;
        const float cs = __shfl_sync(FULL_MASK, s, src);
        warp_list_insert(ls, li, k, cs, row0 + c * 32 + src, lane);
        thr = ls[k - 1];
        m &= m - 1;
        m &= __ballot_sync(FULL_MASK, s > thr);
      }
    }
  }
}

// Write each query row's list to out [nq, n_tiles, k] at tile `tile`.
template <int BQ, int WARPS>
__device__ __forceinline__ void write_lists(const float* lsb, const int* lib,
                                            float* __restrict__ out_s,
                                            int* __restrict__ out_i, int k,
                                            int q0, int nq, int tile,
                                            int n_tiles, int warp,
                                            int lane) {
  for (int qq = warp; qq < BQ && q0 + qq < nq; qq += WARPS) {
    const size_t o = (static_cast<size_t>(q0 + qq) * n_tiles + tile) * k;
    for (int e = lane; e < k; e += 32) {
      out_s[o + e] = lsb[qq * k + e];
      out_i[o + e] = lib[qq * k + e];
    }
  }
}
