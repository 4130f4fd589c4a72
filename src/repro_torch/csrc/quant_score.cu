// SQ-int8 score matrix: scores[i, j] = qs[i, :] . float(codes[j, :]), with
// qs = q * scale prescaled by the caller. The `op` rung of the vector DB's
// flat sq8 search; the caller masks it and takes the top-k.
//
// Replaces: src/repro/kernels/quant_score.py, quant_score_pallas with
// _quant_score_kernel, the TPU kernel that upcasts a (1024 x d) int8 code
// tile in VMEM and contracts it with the (128 x d) query block on the MXU,
// writing the (128 x 1024) score tile out.
//
// What bounds it on an H100: each code row (d bytes) feeds one d-long dot
// product per query, 2 * nq FLOP per byte; at 64 queries that is 128 FLOP
// per byte of codes, far above the card's 20 (67 TFLOP/s fp32 FMA over
// 3.35 TB/s). The [nq, N] fp32 output adds 4 bytes per 2 * d FLOP, still
// below the FMA time. So a full batch is bound by the FMA units. Scores
// must be exact fp32, so no tensor cores.
//
// What the design does about it:
//  * Grid (code tiles of BN rows, query tiles of BQ rows), 256 threads, a
//    4 x 8 register block of scores per thread (scan_tile.cuh), so each
//    shared-memory float4 read feeds 8 FMAs.
//  * The codes are upcast to fp32 once per tile while being stored to
//    shared memory, never once per query; their 4-byte loads for the next
//    depth chunk are in flight while this chunk's FMAs run.
//  * The block writes its (BQ x BN) scores straight from registers: there
//    is no live mask and no selection.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sq8_tile.cuh"

namespace {

using namespace sq8;

size_t smem_bytes() { return sizeof(float) * (2 * BQ * DKP + 2 * BN * DKP); }

__global__ void __launch_bounds__(THREADS, 2)
quant_score_kernel(const float* __restrict__ qs,
                   const int8_t* __restrict__ codes,
                   float* __restrict__ out, int nq, int n, int d) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qsm = reinterpret_cast<float*>(smem);   // [2][BQ][DKP]
  float* csm = qsm + 2 * BQ * DKP;               // [2][BN][DKP]

  const int tid = threadIdx.x, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.y * BQ;
  const long long n0 = static_cast<long long>(blockIdx.x) * BN;
  const int nrows = static_cast<int>(n - n0 < BN ? n - n0 : BN);
  const int nchunk = (d + DK - 1) / DK;
  const bool active = q0 + 8 * warp < nq;   // this warp's 8 query rows

  uint32_t w[C_LOADS];
  load_q(qsm, qs, q0, nq, d, 0, tid);
  cp_async_commit();
  load_codes(w, codes, n0, nrows, nullptr, d, 0, tid);
  store_codes(csm, w, tid);

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int c = 0; c < nchunk; ++c) {
    const int buf = c & 1;
    const bool more = c + 1 < nchunk;
    if (more) {
      load_q(qsm + (buf ^ 1) * BQ * DKP, qs, q0, nq, d, (c + 1) * DK, tid);
      cp_async_commit();
      load_codes(w, codes, n0, nrows, nullptr, d, (c + 1) * DK, tid);
      cp_async_wait_1();
    } else {
      cp_async_wait_0();
    }
    __syncthreads();
    if (active)
      fma_chunk<DK, DKP>(acc, qsm + buf * BQ * DKP, csm + buf * BN * DKP,
                         tx, ty);
    if (more) store_codes(csm + (buf ^ 1) * BN * DKP, w, tid);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qrow = q0 + ty * 4 + i;
    if (qrow >= nq) continue;
    float* o = out + static_cast<size_t>(qrow) * n + n0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = tx + 16 * j;
      if (r < nrows) o[r] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" const char* quant_score_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// qs:[nq,d] fp32 (q * scale), 16-byte aligned; codes:[n,d] int8 row-major,
// 4-byte aligned, d % 4 == 0; out:[nq,n] fp32. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int quant_score_f32(const float* qs, const int8_t* codes,
                               float* out, int nq, int n, int d,
                               void* stream) {
  if (nq < 1 || n < 1 || d < 4 || d % 4 != 0 || (nq + BQ - 1) / BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      quant_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BN - 1) / BN, (nq + BQ - 1) / BQ);
  quant_score_kernel<<<grid, THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(qs, codes, out,
                                                            nq, n, d);
  return static_cast<int>(cudaGetLastError());
}
