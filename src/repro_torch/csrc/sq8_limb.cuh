// The exact int8 limb product of sq8_topk.cu and quant_score.cu: the
// scores qs . codes[j] of a block of 64 prescaled query rows against
// 64-row int8 code tiles, on the int8 tensor cores.
//
// The caller splits each prescaled query row qs = q * scale into LIMBS = 4
// int8 limbs (repro_torch.kernels.fused_retrieve.sq8_limbs): with 2^e the
// least power of two >= max_j |qs_j|, limb 0 = round(qs 2^(6 - e)) and each
// further limb = round(residue 2^7), every limb in [-64, 64] and every step
// exact in fp32; it passes the limbs [LIMBS, nq, d] and e [nq]. Each limb's
// dot product a_l with a code row is an exact int32 sum (wgmma m64n64k32
// .s32.s8.s8), |a_l| <= 64 * 127 * d, which fits int32 for d <= 264,208 and
// converts to fp32 exactly for d <= 2,064 (wider, it rounds to nearest as
// the torch model's conversion does). The score is
// ((a_0 w_0 + a_1 w_1) + a_2 w_2) + a_3 w_3 with w_l = 2^(e - 6 - 7 l)
// built from its bits, each product exact, rounded add by add in that
// order (fused_retrieve.sq8_limb_scores computes the same bits in torch).
// Besides the fp32 rounding of the adds, the only error is the split:
// |score - qs . c| <= sum_j |c_j| 2^(e - 28). For unit queries and rows
// (|qs_j| <= scale_j <= 1/127, so e <= -6; |c_j| <= 127) that is at most
// 127 d 2^-34: 2.8e-6 at d = 384 and 7.6e-6 at d = 1024, under the port's
// 1e-5 parity rule. Where qs are multiples of 2^(e - 27) (the tie inputs:
// multiples of 1/8) the split is exact and the scores equal the fp32
// product's bit for bit.
//
// Operands, both K-major in the 128-byte swizzle, in 128-column chunks of
// [64 rows][128 bytes] (CHUNK_BYTES): A, the limbs of the block's 64 query
// rows (zero past d and past nq, so whatever a code tile holds past d adds
// nothing), and B, a 64-row code tile as it lies in device memory. At
// d <= 384 (RESIDENT_CH chunks) the four limbs stay resident in shared
// memory (96 KB at d = 384), written once by every thread, and a ring
// stage holds a whole code tile. Above that they do not fit beside a ring
// (192 KB at d = 768, 256 KB at 1,024), so they stream: a ring stage holds
// one 128-column chunk of the code tile and the same chunk of the four
// limbs (40 KB), and a tile takes ceil(d / 128) stages, at any width. The
// int32 sums are exact in any order, so both give the same bits. A stage's loads are
// issued by a producer warp: TMA (128-column boxes in the 128-byte swizzle)
// when d % 16 == 0, the row stride TMA needs; else 4-byte cp.async into the
// same swizzled layout (the contract's d % 4 == 0).
//
// Each thread of the consumer warpgroup ends a tile holding the four int32
// sums of its 2 query rows x 16 code rows at the same accumulator
// positions (acc[l][4j + 2i + c]: query row 16 warp + lane / 4 + 8 i of the
// block, code row 8 j + 2 (lane % 4) + c of the tile) and combines them in
// registers (score). Below d = 516, |a_l| < 2^22, so a_l converts to fp32
// by adding its bits to those of 1.5 * 2^23 (an integer add, where the
// converter runs at a quarter of the rate) and fma(that, w_l,
// -1.5 * 2^23 w_l) is a_l w_l exactly; wider rows take the converter.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "sm90.cuh"

namespace limb {

constexpr int LIMBS = 4;
constexpr int BQ = 64;                  // query rows per block: wgmma's M
constexpr int BN = 64;                  // code rows per tile: wgmma's N
constexpr int CHUNK_BYTES = 64 * 128;   // 64 rows of one 128-column chunk
constexpr int RESIDENT_CH = 3;          // d <= 384: the limbs stay resident
constexpr int EXACT_ADD_D = 512;        // the integer-add conversion's limit
// a streaming stage: the code chunk, then the limbs' chunks
constexpr int STREAM_STAGE_BYTES = (1 + LIMBS) * CHUNK_BYTES;

// Byte offset of (row, column byte) of a 64-row tile of 128-column chunks
// in the 128-byte swizzle: the 16-byte unit u of row r sits at u ^ (r % 8).
__device__ __forceinline__ int swz(int row, int col) {
  return (col >> 7) * CHUNK_BYTES + row * 128 +
         ((((col >> 4) & 7) ^ (row & 7)) << 4) + (col & 15);
}

// The block's four limbs, resident: a_s [LIMBS][CH][64][128] from limbs
// [LIMBS, nq, d] as 4-byte words, zero past nq and d. Called by every
// thread of the block; the caller fences for the async proxy.
template <int CH>
__device__ __forceinline__ void load_resident(unsigned char* a_s,
                                              const int8_t* __restrict__ limbs,
                                              int nq, int d, int q0, int tid,
                                              int nthreads) {
  constexpr int words = CH * 32;   // words per row of a limb
  for (int e = tid; e < LIMBS * BQ * words; e += nthreads) {
    const int w = e % words, r = (e / words) % BQ, l = e / (words * BQ);
    const int col = 4 * w;
    uint32_t v = 0;
    if (q0 + r < nq && col < d)
      v = *reinterpret_cast<const uint32_t*>(
          limbs + (static_cast<size_t>(l) * nq + q0 + r) * d + col);
    *reinterpret_cast<uint32_t*>(a_s + l * CH * CHUNK_BYTES + swz(r, col)) = v;
  }
}

// One ring stage's loads, by the producer warp (all 32 lanes call it; the
// stage's full barrier counts 32 arrivals): columns [128 c0, 128 (c0 + nc))
// of code tile `tile` (rows past n and, by TMA, columns past d read as
// zeros; by cp.async they keep what they held: their rows are dead, or A
// is zero there) into `dst`, and where `a_dst` is given (streaming, nc ==
// 1) the same columns of the four limbs of query rows q0.. into
// a_dst[l * CHUNK_BYTES], zero past d and nq.
__device__ __forceinline__ void load_stage(
    const CUtensorMap* codes_map, const CUtensorMap* limbs_map,
    const int8_t* __restrict__ codes, const int8_t* __restrict__ limbs,
    int n, int nq, int d, int tile, int c0, int nc, int q0, bool tma,
    unsigned char* dst, unsigned char* a_dst, uint64_t* full, int lane) {
  if (tma) {
    if (lane == 0) {
      sm90::mbar_expect_tx(full, (nc + (a_dst ? LIMBS : 0)) * CHUNK_BYTES);
      for (int c = 0; c < nc; ++c)
        sm90::tma_load_2d(dst + c * CHUNK_BYTES, codes_map, full,
                          (c0 + c) * 128, tile * BN);
      if (a_dst)
        for (int l = 0; l < LIMBS; ++l)
          sm90::tma_load_3d(a_dst + l * CHUNK_BYTES, limbs_map, full,
                            c0 * 128, q0, l);
    } else {
      sm90::mbar_arrive(full);
    }
    return;
  }
  const int lo = 128 * c0, hi = min(d, 128 * (c0 + nc));
  const int rw = (hi - lo) / 4;   // words of a row in these columns
  const long long base = static_cast<long long>(tile) * BN;
  for (int e = lane; e < BN * rw; e += 32) {
    const int r = e / rw, col = lo + 4 * (e % rw);
    if (base + r < n)
      cp_async4(dst + swz(r, col - lo), codes + (base + r) * d + col);
  }
  if (a_dst)
    for (int e = lane; e < LIMBS * BQ * 32; e += 32) {
      const int w = e & 31, r = (e >> 5) % BQ, l = e / (32 * BQ);
      const int col = lo + 4 * w;
      const bool in = q0 + r < nq && col < d;
      cp_async4z(a_dst + l * CHUNK_BYTES + swz(r, 4 * w),
                 in ? limbs + (static_cast<size_t>(l) * nq + q0 + r) * d + col
                    : limbs,
                 in);
    }
  cp_async_commit();
  cp_async_wait_0();
  sm90::fence_proxy_async();
  sm90::mbar_arrive(full);
}

// acc[l] (+)= A_l B over one 128-column chunk: four k32 steps, one wgmma
// per limb each; A_l at a + l * a_step, B at b. `accumulate` false starts
// the sums (the tile's first chunk).
__device__ __forceinline__ void chunk_products(int (&acc)[LIMBS][32],
                                               const unsigned char* a,
                                               int a_step,
                                               const unsigned char* b,
                                               bool accumulate) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = sm90::desc_sw128(b + 32 * kk);
#pragma unroll
    for (int l = 0; l < LIMBS; ++l)
      sm90::wgmma_m64n64k32_s8_ss(
          acc[l], sm90::desc_sw128(a + l * a_step + 32 * kk), db,
          accumulate || kk > 0);
  }
}

// A whole tile against the resident limbs a_s [LIMBS][CH][64][128]; the
// tile b [CH][64][128].
template <int CH>
__device__ __forceinline__ void tile_products(int (&acc)[LIMBS][32],
                                              const unsigned char* a_s,
                                              const unsigned char* b) {
#pragma unroll
  for (int c = 0; c < CH; ++c)
    chunk_products(acc, a_s + c * CHUNK_BYTES, CH * CHUNK_BYTES,
                   b + c * CHUNK_BYTES, c > 0);
}

// The limbs' weights w_l = 2^(e - 6 - 7 l) for exponent e, built from their
// bits, and -1.5 * 2^23 times each (the integer-add conversion's offset).
__device__ __forceinline__ void weights(int e, float (&w)[LIMBS],
                                        float (&wm)[LIMBS]) {
#pragma unroll
  for (int l = 0; l < LIMBS; ++l) {
    w[l] = __int_as_float((e - 6 - 7 * l + 127) << 23);
    wm[l] = -12582912.f * w[l];
  }
}

// The score at accumulator position p: the four exact sums combined in
// sq8_limb_scores' order. WIDE (d > EXACT_ADD_D) converts with the
// converter, else by the integer add.
template <bool WIDE>
__device__ __forceinline__ float score(const int (&acc)[LIMBS][32], int p,
                                       const float (&w)[LIMBS],
                                       const float (&wm)[LIMBS]) {
  if constexpr (WIDE) {
    float v = __fmul_rn(__int2float_rn(acc[0][p]), w[0]);
#pragma unroll
    for (int l = 1; l < LIMBS; ++l)
      v = __fadd_rn(v, __fmul_rn(__int2float_rn(acc[l][p]), w[l]));
    return v;
  } else {
    float v = __fmaf_rn(__int_as_float(acc[0][p] + 0x4B400000), w[0], wm[0]);
#pragma unroll
    for (int l = 1; l < LIMBS; ++l)
      v = __fadd_rn(v, __fmaf_rn(__int_as_float(acc[l][p] + 0x4B400000),
                                 w[l], wm[l]));
    return v;
  }
}

// codes [n, d] int8 as a 2-d uint8 map (d, n) read in boxes of 128 columns x
// 64 rows in the 128-byte swizzle; columns past d and rows past n read as
// zeros. TMA needs the row stride, d bytes, to be a multiple of 16.
inline bool encode_codes(CUtensorMap* map, const int8_t* codes, int n,
                         int d) {
  const sm90::EncodeTiled enc = sm90::encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d)};
  const cuuint32_t box[2] = {128, BN};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
             const_cast<int8_t*>(codes), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// limbs [LIMBS, nq, d] int8 as a 3-d uint8 map (d, nq, LIMBS) read in boxes
// of 128 columns x 64 query rows x 1 limb in the 128-byte swizzle; columns
// past d and rows past nq read as zeros.
inline bool encode_limbs(CUtensorMap* map, const int8_t* limbs, int nq,
                         int d) {
  const sm90::EncodeTiled enc = sm90::encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(nq),
                              static_cast<cuuint64_t>(LIMBS)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d),
                                 static_cast<cuuint64_t>(d) * nq};
  const cuuint32_t box[3] = {128, BQ, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
             const_cast<int8_t*>(limbs), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The ring's code and limb maps for codes [n, d] and limbs [LIMBS, nq, d],
// where d % 16 == 0 (tma); the limbs' map only where they stream.
inline bool encode_maps(CUtensorMap* codes_map, CUtensorMap* limbs_map,
                        const int8_t* codes, const int8_t* limbs, int n,
                        int nq, int d, bool tma, bool stream) {
  if (!tma) return true;
  return encode_codes(codes_map, codes, n, d) &&
         (!stream || encode_limbs(limbs_map, limbs, nq, d));
}

}  // namespace limb
