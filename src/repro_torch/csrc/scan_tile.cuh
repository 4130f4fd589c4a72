// Pieces shared by the corpus-tile scans on the FMA units (topk_search.cu
// over fp32 rows, quant_score.cu over int8 codes): the register-blocked FMA
// loop and the tile's liveness prologue.
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
