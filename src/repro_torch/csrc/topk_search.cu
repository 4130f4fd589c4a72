// Exact inner-product top-k over a row-major fp32 corpus: the vector DB's
// flat index, its cold-start scan and its freshness-buffer scan.
//
// Replaces: src/repro/kernels/topk_search.py, topk_search_pallas with
// _topk_tile_kernel, the TPU kernel that scores one (128 x 1024) tile on
// the MXU and reduces it to the tile's top-k by k rounds of max/argmax.
//
// What bounds it on an H100: each live corpus row (4*d bytes) feeds one
// d-long dot product per query. With 64 queries that is 32 FLOP per byte
// of corpus, above the card's 20 (67 TFLOP/s fp32 FMA over 3.35 TB/s), so
// a full batch is bound by the FMA units and a batch of a few queries by
// the corpus bytes. The scores must be exact fp32, so no tensor cores.
//
// What the design does about it:
//  * Grid (corpus tiles of TILE_N rows, query tiles of BQ rows), 256
//    threads. The block reads its tile's liveness bytes first, skips every
//    BN-row sub-tile without a live row and never loads a dead row's
//    vector (cp.async with source size 0 writes zeros): a freshness scan
//    over a mostly dead capacity reads the fresh rows only.
//  * Depth chunks of DK floats of the query block and of the sub-tile are
//    copied to shared memory with 16-byte cp.async loads, double buffered
//    so the next chunk's loads overlap this chunk's FMAs. Each thread
//    keeps a 4 x 8 block of scores in registers and reads its operands as
//    float4 (8 FMAs per shared-memory load). Warps whose query rows are
//    all past nq skip the FMAs, so a small batch costs only its bytes.
//  * A finished BQ x BN score tile goes to shared memory, dead rows set to
//    NEG, and one warp per query row folds it into that row's running
//    top-k (scan_tile.cuh, topk_list.cuh): only scores above the list's
//    k-th enter, in row order, so equal scores keep the lower row.
//  * Output [nq, n_tiles, k] candidates; the caller merges them with a
//    stable sort, as the JAX package merges with lax.top_k.
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_tile.cuh"

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BN = 128;          // corpus rows per sub-tile
constexpr int DK = 32;           // depth chunk (floats)
constexpr int DKP = DK + 4;      // chunk row pitch: 16-byte reads stay conflict free
constexpr int BNP = BN + 4;      // score tile row pitch
constexpr int TILE_N = 1024;     // corpus rows per block
constexpr int NSUB = TILE_N / BN;
constexpr int THREADS = 256;     // 16 x 16: 4 queries x 8 rows per thread
constexpr int WARPS = THREADS / 32;

size_t smem_bytes(int k) {
  return sizeof(float) * (2 * BQ * DKP + 2 * BN * DKP + BQ * BNP) +
         (sizeof(float) + sizeof(int)) * BQ * k + TILE_N +
         sizeof(int) * (NSUB + 1);
}

__global__ void __launch_bounds__(THREADS, 2)
topk_tile_kernel(const float* __restrict__ q, const float* __restrict__ vecs,
                 const uint8_t* __restrict__ live, float* __restrict__ out_s,
                 int* __restrict__ out_i, int nq, int n, int d, int k,
                 int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);   // [2][BQ][DKP]
  float* vs = qs + 2 * BQ * DKP;                 // [2][BN][DKP]
  float* sc = vs + 2 * BN * DKP;                 // [BQ][BNP]
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

  // step = (live sub-tile, depth chunk); copies its operands into `buf`
  auto load_step = [&](int step, int buf) {
    const int st = subs[1 + step / nchunk];
    const int col0 = (step % nchunk) * DK;
    float* qd = qs + buf * BQ * DKP;
    float* vd = vs + buf * BN * DKP;
#pragma unroll
    for (int t = 0; t < (BQ * DK / 4) / THREADS; ++t) {
      const int idx = tid + t * THREADS;
      const int row = idx >> 3, col = col0 + (idx & 7) * 4;
      const bool ok = q0 + row < nq && col < d;
      const float* src = ok ? q + static_cast<size_t>(q0 + row) * d + col : q;
      cp_async16(qd + row * DKP + (idx & 7) * 4, src, ok);
    }
#pragma unroll
    for (int t = 0; t < (BN * DK / 4) / THREADS; ++t) {
      const int idx = tid + t * THREADS;
      const int row = idx >> 3, col = col0 + (idx & 7) * 4;
      const bool ok = rowok[st * BN + row] && col < d;
      const float* src =
          ok ? vecs + static_cast<size_t>(tile_base + st * BN + row) * d + col
             : vecs;
      cp_async16(vd + row * DKP + (idx & 7) * 4, src, ok);
    }
  };

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if (nsteps > 0) {
    load_step(0, 0);
    cp_async_commit();
  }
  for (int step = 0; step < nsteps; ++step) {
    const int buf = step & 1;
    if (step + 1 < nsteps) {
      load_step(step + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait_1();
    } else {
      cp_async_wait_0();
    }
    __syncthreads();
    if (active)
      fma_chunk<DK, DKP>(acc, qs + buf * BQ * DKP, vs + buf * BN * DKP, tx,
                         ty);
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

extern "C" int topk_search_tile_rows() { return TILE_N; }

extern "C" const char* topk_search_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q:[nq,d] vecs:[n,d] fp32 row-major, 16-byte aligned, d % 4 == 0;
// live:[n] bytes; out_s/out_i:[nq, ceil(n / TILE_N), k]. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int topk_search_f32(const float* q, const float* vecs,
                               const uint8_t* live, float* out_s, int* out_i,
                               int nq, int n, int d, int k, void* stream) {
  if (nq < 1 || n < 1 || d < 4 || d % 4 != 0 || k < 1 || k > TOPK_MAX_K ||
      (nq + BQ - 1) / BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      topk_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (n + TILE_N - 1) / TILE_N;
  const dim3 grid(n_tiles, (nq + BQ - 1) / BQ);
  topk_tile_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      q, vecs, live, out_s, out_i, nq, n, d, k, n_tiles);
  return static_cast<int>(cudaGetLastError());
}
