// The int8 score tile shared by quant_score.cu and sq8_topk.cu: a block of
// BQ prescaled fp32 query rows against BN int8 code rows, depth chunk by
// depth chunk, each thread holding a 4 x 8 block of fp32 scores in
// registers (scan_tile.cuh's fma_chunk, as in topk_search.cu).
//
// A chunk's codes come from device memory as 4-byte words (d % 4 == 0) into
// registers, one chunk ahead of the FMAs that use them, and are upcast to
// fp32 once when they are stored to shared memory: every query row of the
// block then reads them as float4, so the converts are 1/64 of the FMAs.
// The query chunk goes to shared memory with 16-byte cp.async loads, double
// buffered like the codes.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_tile.cuh"

namespace sq8 {

constexpr int BQ = 64;           // query rows per block
constexpr int BN = 128;          // code rows per tile
constexpr int DK = 32;           // depth chunk (elements)
constexpr int DKP = DK + 4;      // row pitch: conflict-free 16-byte reads
constexpr int THREADS = 256;     // 16 x 16: 4 queries x 8 rows per thread
constexpr int Q_LOADS = (BQ * DK / 4) / THREADS;    // float4 per thread
constexpr int C_LOADS = (BN * DK / 4) / THREADS;    // code words per thread

// Query rows q0.. of qs [nq, d], columns col0..col0+DK, into qd [BQ][DKP];
// rows past nq and columns past d are zero.
__device__ __forceinline__ void load_q(float* qd, const float* qs, int q0,
                                       int nq, int d, int col0, int tid) {
#pragma unroll
  for (int t = 0; t < Q_LOADS; ++t) {
    const int idx = tid + t * THREADS;
    const int row = idx >> 3, col = col0 + (idx & 7) * 4;
    const bool ok = q0 + row < nq && col < d;
    const float* src = ok ? qs + static_cast<size_t>(q0 + row) * d + col : qs;
    cp_async16(qd + row * DKP + (idx & 7) * 4, src, ok);
  }
}

// Code words of rows row0 + r (r < nrows, and rowok[r] != 0 when rowok is
// given), columns col0..col0+DK, into registers; other words are zero.
__device__ __forceinline__ void load_codes(uint32_t (&w)[C_LOADS],
                                           const int8_t* codes,
                                           long long row0, int nrows,
                                           const uint8_t* rowok, int d,
                                           int col0, int tid) {
#pragma unroll
  for (int t = 0; t < C_LOADS; ++t) {
    const int idx = tid + t * THREADS;
    const int r = idx >> 3, col = col0 + (idx & 7) * 4;
    const bool ok = r < nrows && col < d && (rowok == nullptr || rowok[r]);
    w[t] = ok ? __ldg(reinterpret_cast<const uint32_t*>(
                    codes + (row0 + r) * d + col))
              : 0u;
  }
}

// Upcast the words of load_codes to fp32 into cd [BN][DKP].
__device__ __forceinline__ void store_codes(float* cd,
                                            const uint32_t (&w)[C_LOADS],
                                            int tid) {
#pragma unroll
  for (int t = 0; t < C_LOADS; ++t) {
    const int idx = tid + t * THREADS;
    const int x = static_cast<int>(w[t]);
    // sign-extend each byte (little endian: byte 0 is column col)
    const float4 f = make_float4(static_cast<float>((x << 24) >> 24),
                                 static_cast<float>((x << 16) >> 24),
                                 static_cast<float>((x << 8) >> 24),
                                 static_cast<float>(x >> 24));
    *reinterpret_cast<float4*>(cd + (idx >> 3) * DKP + (idx & 7) * 4) = f;
  }
}

}  // namespace sq8
