// SQ-int8 exact top-k: the vector DB's flat sq8 index on the `fused` rung.
// Scores are qs . float(codes[j]) with qs = q * scale prescaled by the
// caller, masked by `live`, reduced to each corpus tile's top-k.
//
// Replaces: src/repro/kernels/fused_retrieve.py, sq8_topk_pallas with
// _sq8_tile_kernel, the TPU kernel that upcasts one (1024 x d) int8 code
// tile in VMEM, scores it against a (128 x d) query block on the MXU and
// reduces it to the tile's top-k by k rounds of max/argmax.
//
// What bounds it on an H100: a live code row (d bytes) feeds one d-long
// dot product per query, 2 * nq FLOP per byte; at 64 queries 128 FLOP per
// byte, far above the card's 20 (67 TFLOP/s fp32 FMA over 3.35 TB/s), so a
// full batch is bound by the FMA units. The scores must be exact fp32, so
// no tensor cores.
//
// What the design does about it:
//  * topk_search.cu's design over int8 rows, sharing its liveness
//    prologue and selection (scan_tile.cuh). Grid (corpus tiles of TILE_N
//    rows, query tiles of BQ rows), 256 threads. The block reads its
//    tile's liveness bytes first, skips every BN-row sub-tile without a
//    live row and never loads a dead row's codes.
//  * The score tile is sq8_tile.cuh's: codes arrive as 4-byte words one
//    depth chunk ahead, are upcast to fp32 once per tile into shared
//    memory, and feed a 4 x 8 register block per thread (8 FMAs per
//    shared-memory float4 read).
//  * A finished BQ x BN score tile goes to shared memory, dead rows set to
//    NEG, and one warp per query row folds it into that row's running
//    top-k (scan_tile.cuh, topk_list.cuh) in row order, so equal scores
//    keep the lower row. Only [nq, n_tiles, k] candidates leave the
//    block; the caller merges them with a stable sort, as the JAX package
//    merges with lax.top_k. The [nq, N] score matrix is never written.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sq8_tile.cuh"

namespace {

using namespace sq8;

constexpr int BNP = BN + 4;      // score tile row pitch
constexpr int TILE_N = 1024;     // corpus rows per block
constexpr int NSUB = TILE_N / BN;
constexpr int WARPS = THREADS / 32;

size_t smem_bytes(int k) {
  return sizeof(float) * (2 * BQ * DKP + 2 * BN * DKP + BQ * BNP) +
         (sizeof(float) + sizeof(int)) * BQ * k + TILE_N +
         sizeof(int) * (NSUB + 1);
}

__global__ void __launch_bounds__(THREADS, 2)
sq8_tile_kernel(const float* __restrict__ qs,
                const int8_t* __restrict__ codes,
                const uint8_t* __restrict__ live, float* __restrict__ out_s,
                int* __restrict__ out_i, int nq, int n, int d, int k,
                int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qsm = reinterpret_cast<float*>(smem);   // [2][BQ][DKP]
  float* csm = qsm + 2 * BQ * DKP;               // [2][BN][DKP]
  float* sc = csm + 2 * BN * DKP;                // [BQ][BNP]
  float* lsb = sc + BQ * BNP;                    // [BQ][k] list scores
  int* lib = reinterpret_cast<int*>(lsb + BQ * k);   // [BQ][k] list rows
  uint8_t* rowok = reinterpret_cast<uint8_t*>(lib + BQ * k);  // [TILE_N]
  int* subs = reinterpret_cast<int*>(rowok + TILE_N);  // count, live sub-tiles

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int tile = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const long long tile_base = static_cast<long long>(tile) * TILE_N;

  list_clear(lsb, lib, BQ * k, tid, THREADS);
  live_subtiles<TILE_N, BN, THREADS>(live, tile_base, n, rowok, subs, tid);

  const int nchunk = (d + DK - 1) / DK;
  const int nsteps = subs[0] * nchunk;
  const bool active = q0 + 8 * warp < nq;   // this warp's 8 query rows

  // step = (live sub-tile, depth chunk): the query chunk goes to shared
  // memory by cp.async, the code words to registers
  uint32_t w[C_LOADS];
  auto issue = [&](int step, int buf) {
    const int st = subs[1 + step / nchunk];
    const int col0 = (step % nchunk) * DK;
    load_q(qsm + buf * BQ * DKP, qs, q0, nq, d, col0, tid);
    cp_async_commit();
    load_codes(w, codes, tile_base + st * BN, BN, rowok + st * BN, d, col0,
               tid);
  };

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if (nsteps > 0) {
    issue(0, 0);
    store_codes(csm, w, tid);
  }
  for (int step = 0; step < nsteps; ++step) {
    const int buf = step & 1;
    const bool more = step + 1 < nsteps;
    if (more) {
      issue(step + 1, buf ^ 1);
      cp_async_wait_1();
    } else {
      cp_async_wait_0();
    }
    __syncthreads();
    if (active)
      fma_chunk<DK, DKP>(acc, qsm + buf * BQ * DKP, csm + buf * BN * DKP,
                         tx, ty);
    if (more) store_codes(csm + (buf ^ 1) * BN * DKP, w, tid);
    if (step % nchunk == nchunk - 1) {   // sub-tile finished: select
      const int st = subs[1 + step / nchunk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int row = tx + 16 * j;
          sc[(ty * 4 + i) * BNP + row] =
              rowok[st * BN + row] ? acc[i][j] : TOPK_NEG;
          acc[i][j] = 0.f;
        }
      __syncthreads();
      fold_tile<BQ, BN, BNP, WARPS>(sc, lsb, lib, k, q0, nq,
                                    static_cast<int>(tile_base) + st * BN,
                                    warp, lane);
    }
    __syncthreads();
  }
  write_lists<BQ, WARPS>(lsb, lib, out_s, out_i, k, q0, nq, tile, n_tiles,
                         warp, lane);
}

}  // namespace

extern "C" int sq8_topk_tile_rows() { return TILE_N; }

// Dynamic shared memory per block the launcher requests for lists of k (d unused).
extern "C" int sq8_topk_smem_bytes(int, int k) {
  return static_cast<int>(smem_bytes(k));
}

extern "C" const char* sq8_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// qs:[nq,d] fp32 (q * scale), 16-byte aligned; codes:[n,d] int8 row-major,
// 4-byte aligned, d % 4 == 0; live:[n] bytes; out_s/out_i:
// [nq, ceil(n / TILE_N), k]. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int sq8_topk_f32(const float* qs, const int8_t* codes,
                            const uint8_t* live, float* out_s, int* out_i,
                            int nq, int n, int d, int k, void* stream) {
  if (nq < 1 || n < 1 || d < 4 || d % 4 != 0 || k < 1 || k > TOPK_MAX_K ||
      (nq + BQ - 1) / BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      sq8_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (n + TILE_N - 1) / TILE_N;
  const dim3 grid(n_tiles, (nq + BQ - 1) / BQ);
  sq8_tile_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      qs, codes, live, out_s, out_i, nq, n, d, k, n_tiles);
  return static_cast<int>(cudaGetLastError());
}
