// SQ-int8 score matrix: scores[i, j] = qs[i, :] . codes[j, :], with
// qs = q * scale prescaled by the caller. The `op` rung of the vector DB's
// flat sq8 search; the caller masks it and takes the top-k.
//
// Replaces: src/repro/kernels/quant_score.py, quant_score_pallas with
// _quant_score_kernel, the TPU kernel that upcasts a (1024 x d) int8 code
// tile in VMEM and contracts it with the (128 x d) query block on the MXU,
// writing the (128 x 1024) score tile out.
//
// What bounds it on an H100: each code row (d bytes) feeds one d-long dot
// product per query and four output bytes per query, 2 d operations per
// 1 + 4 nq / d bytes. At 64 queries and d = 384 the codes (0.40 GB at
// N = 1,048,576) and the [nq, N] fp32 output (0.27 GB) bound it: 0.20 ms at
// 3.35 TB/s, against 0.77 ms for the products on the fp32 FMA units and
// 0.10 ms for the four limbs' products on the int8 tensor cores.
//
// Exact on int8 tensor cores: the caller splits qs into four int8 limbs
// (fused_retrieve.sq8_limbs) and the kernel scores them with sq8_limb.cuh's
// product, shared with sq8_topk.cu (its header states the arithmetic and
// the split's error, at most 127 d 2^-34 for unit rows: 2.8e-6 at d = 384
// and 7.6e-6 at d = 1,024). The scores equal fused_retrieve.sq8_limb_scores
// bit for bit.
//
// The design:
//  * Block (b, y) takes query rows 64y .. 64y + 63 and walks code tiles
//    b, b + G, b + 2G, ... (G = gridDim.x, one block per SM) of 64 rows.
//    Two consumer warpgroups take the block's tiles in turns, so one
//    warpgroup's scores and stores overlap the other's products, and a
//    producer warp keeps the tiles in flight through a ring of stages per
//    warpgroup (full/empty mbarriers, each stage waited on by one
//    warpgroup in order; sq8_limb.cuh's loads: a whole tile a stage with
//    the limbs resident at d <= 384, else a 128-column chunk of the tile
//    and of the limbs a stage).
//  * Per tile the consuming warpgroup runs one wgmma m64n64k32 .s32.s8.s8
//    per limb and k32 step, then combines each thread's four exact int32
//    sums in registers (limb::score): its 2 query rows x 16 code rows.
//  * Stores: the four lanes of a quad hold a query row's 64 scores of the
//    tile, two at a time; two exchanges over the quad (shfl_xor 2, then 1)
//    give each lane 4 consecutive ones, so a warp writes each of its 8
//    query rows 64 contiguous bytes at a time with 16-byte stores. Where
//    N % 4 != 0 (rows not 16-byte aligned) or the tile is the ragged last
//    one, each score is stored on its own. There is no mask and no
//    selection.
//  * Registers: every consumer thread holds the four limbs' 32 int32 sums
//    (128 registers) and its rows' limb weights; ptxas caps the kernel at
//    168 a thread. Only quant_score_kernel<0, false> (limbs streamed,
//    integer-add conversion: 384 < d <= 512, a width no spec or benchmark
//    of the repo uses) spills, 12 bytes; the instantiations at d <= 384
//    and above 512 have no stack frame.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"
#include "sq8_limb.cuh"

namespace {

using limb::BN;
using limb::BQ;
using limb::CHUNK_BYTES;
using limb::LIMBS;
constexpr int WARPGROUPS = 2;
constexpr int CONSUMERS = 128 * WARPGROUPS;
constexpr int THREADS = CONSUMERS + 32;   // and the producer warp
constexpr int MAX_STAGES = 4;
constexpr int SMEM_MAX = 232448;          // shared memory a block may use

// Shared memory, from a 1,024-byte boundary: A [LIMBS][ch][64][128]
// (resident limbs only), the rings [WARPGROUPS][stages / WARPGROUPS][stage
// bytes], the full and empty barriers [stages] each.
struct Layout {
  int ch, stages, stage_bytes;
  bool stream;
  int b_off, bar_off, bytes;
};

__host__ __device__ inline Layout layout(int d) {
  Layout L;
  L.ch = (d + 127) / 128;
  L.stream = L.ch > limb::RESIDENT_CH;
  const int a_bytes = L.stream ? 0 : LIMBS * L.ch * CHUNK_BYTES;
  L.stage_bytes = L.stream ? limb::STREAM_STAGE_BYTES : L.ch * CHUNK_BYTES;
  L.stages = (SMEM_MAX - 1024 - a_bytes) / (L.stage_bytes + 16);
  if (L.stages > MAX_STAGES) L.stages = MAX_STAGES;
  L.stages -= L.stages % WARPGROUPS;   // a ring per warpgroup
  L.b_off = a_bytes;
  L.bar_off = L.b_off + L.stages * L.stage_bytes;
  L.bytes = 1024 + L.bar_off + 16 * L.stages;
  return L;
}

// Pairs (x, y) of two floats moved as one over the quad.
__device__ __forceinline__ float2 shfl_xor2(float2 v, int m) {
  return make_float2(__shfl_xor_sync(0xffffffffu, v.x, m),
                     __shfl_xor_sync(0xffffffffu, v.y, m));
}

// CH > 0: the limbs resident, a tile a stage; CH == 0: the limbs stream, a
// chunk a stage. WIDE: d > limb::EXACT_ADD_D.
template <int CH, bool WIDE>
__global__ void __launch_bounds__(THREADS, 1)
quant_score_kernel(const __grid_constant__ CUtensorMap codes_map,
                   const __grid_constant__ CUtensorMap limbs_map,
                   const int8_t* __restrict__ codes,
                   const int8_t* __restrict__ limbs,
                   const int* __restrict__ expo, float* __restrict__ out,
                   int nq, int n, int d, int tma) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  const Layout L = layout(d);   // L.ch == CH where CH > 0
  unsigned char* a_s = smem;                 // [LIMBS][ch][64][128]
  unsigned char* b_s = smem + L.b_off;       // [stages][stage bytes]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar_off);
  uint64_t* empty = full + L.stages;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int G = gridDim.x;
  const int n_tiles = (n + BN - 1) / BN;
  const int per_tile = CH > 0 ? 1 : L.ch;   // ring stages a tile takes
  const int sw = L.stages / WARPGROUPS;     // stages of a warpgroup's ring

  if constexpr (CH > 0) {
    limb::load_resident<CH>(a_s, limbs, nq, d, q0, tid, blockDim.x);
    sm90::fence_proxy_async();   // A is read by wgmma (the async proxy)
  }
  if (tid == 0) {
    for (int s = 0; s < L.stages; ++s) {
      sm90::mbar_init(&full[s], 32);     // the producer warp's lanes
      sm90::mbar_init(&empty[s], 128);   // the warpgroup whose tile it is
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {   // the producer warp
    const int lane = tid - CONSUMERS;
    if (tma && lane == 0) {
      sm90::tma_prefetch_desc(&codes_map);
      if (CH == 0) sm90::tma_prefetch_desc(&limbs_map);
    }
    for (int it = 0;; ++it) {
      const int t = blockIdx.x + it * G;
      if (t >= n_tiles) break;
      for (int c = 0; c < per_tile; ++c) {
        // the ring of warpgroup it % 2: its (it / 2 * per_tile + c)-th use
        const int u = it / WARPGROUPS * per_tile + c;
        const int s = it % WARPGROUPS * sw + u % sw;
        sm90::mbar_wait(&empty[s], ((u / sw) & 1) ^ 1);
        unsigned char* dst = b_s + s * L.stage_bytes;
        if constexpr (CH > 0)
          limb::load_stage(&codes_map, &limbs_map, codes, limbs, n, nq, d, t,
                           0, CH, q0, tma, dst, nullptr, &full[s], lane);
        else
          limb::load_stage(&codes_map, &limbs_map, codes, limbs, n, nq, d, t,
                           c, 1, q0, tma, dst, dst + CHUNK_BYTES, &full[s],
                           lane);
      }
    }
    return;
  }

  // the consumer warpgroups: wg takes the block's tiles wg, wg + 2, ...
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2,
            t4 = lane & 3;
  // this thread's queries: rows 16 warp + g + 8 i of the block
  float w[2][LIMBS], wm[2][LIMBS];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = q0 + 16 * warp + g + 8 * i;
    limb::weights(q < nq ? expo[q] : 0, w[i], wm[i]);
  }
  // defined before the first wgmma: an undefined accumulator register makes
  // ptxas serialize every wgmma of the kernel
  int acc[LIMBS][32];
#pragma unroll
  for (int l = 0; l < LIMBS; ++l)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[l][e] = 0;
  const bool aligned = n % 4 == 0;   // every query row 16-byte aligned

  for (int it = wg;; it += WARPGROUPS) {
    const int t = blockIdx.x + it * G;
    if (t >= n_tiles) break;
    for (int c = 0; c < per_tile; ++c) {
      const int u = it / WARPGROUPS * per_tile + c, s = wg * sw + u % sw;
      sm90::mbar_wait(&full[s], (u / sw) & 1);
      const unsigned char* bs = b_s + s * L.stage_bytes;
#pragma unroll
      for (int l = 0; l < LIMBS; ++l) sm90::reg_fence(acc[l]);
      sm90::wgmma_fence();
      if constexpr (CH > 0)
        limb::tile_products<CH>(acc, a_s, bs);
      else
        limb::chunk_products(acc, bs + CHUNK_BYTES, CHUNK_BYTES, bs, c > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int l = 0; l < LIMBS; ++l) sm90::reg_fence(acc[l]);
      sm90::mbar_arrive(&empty[s]);   // the stage is free for the producer
    }

    const long long row0 = static_cast<long long>(t) * BN;
    const bool whole = aligned && row0 + BN <= n;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = q0 + 16 * warp + g + 8 * i;
      float* o = out + static_cast<size_t>(q < nq ? q : 0) * n + row0;
      if (whole) {
        // 16 columns at a time: lane t4 holds A = columns 16m + 2 t4 + {0,1}
        // and B = 16m + 8 + 2 t4 + {0,1}, and ends with 16m + 4 t4 + {0..3}
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float2 A = make_float2(
              limb::score<WIDE>(acc, 8 * m + 2 * i, w[i], wm[i]),
              limb::score<WIDE>(acc, 8 * m + 2 * i + 1, w[i], wm[i]));
          const float2 B = make_float2(
              limb::score<WIDE>(acc, 8 * m + 4 + 2 * i, w[i], wm[i]),
              limb::score<WIDE>(acc, 8 * m + 4 + 2 * i + 1, w[i], wm[i]));
          // lanes 0, 1 keep their A and take lane + 2's A; lanes 2, 3 keep
          // their B and take lane - 2's B: X the lower columns, Y the higher
          const bool hi = t4 & 2;
          const float2 r1 = shfl_xor2(hi ? A : B, 2);
          const float2 X = hi ? r1 : A, Y = hi ? B : r1;
          // even lanes keep X and take the odd lane's X; odd lanes keep Y
          // and take the even lane's Y
          const bool odd = t4 & 1;
          const float2 r2 = shfl_xor2(odd ? X : Y, 1);
          const float4 v = odd ? make_float4(r2.x, r2.y, Y.x, Y.y)
                               : make_float4(X.x, X.y, r2.x, r2.y);
          if (q < nq)
            *reinterpret_cast<float4*>(o + 16 * m + 4 * t4) = v;
        }
      } else if (q < nq) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int r = 8 * j + 2 * t4 + c;
            if (row0 + r < n)
              o[r] = limb::score<WIDE>(acc, 4 * j + 2 * i + c, w[i], wm[i]);
          }
      }
    }
  }
}

template <int CH, bool WIDE>
int launch(dim3 grid, int smem, cudaStream_t stream, const CUtensorMap& map,
           const CUtensorMap& lmap, const int8_t* codes, const int8_t* limbs,
           const int* expo, float* out, int nq, int n, int d, int tma) {
  const cudaError_t err = cudaFuncSetAttribute(
      quant_score_kernel<CH, WIDE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  quant_score_kernel<CH, WIDE><<<grid, THREADS, smem, stream>>>(
      map, lmap, codes, limbs, expo, out, nq, n, d, tma);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int quant_score_tile_rows() { return BN; }

// Dynamic shared memory per block the launcher requests for rows of width
// d (k unused).
extern "C" int quant_score_smem_bytes(int d, int) {
  return layout(d).bytes;
}

extern "C" const char* quant_score_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// limbs:[4, nq, d] int8 and expo:[nq] int32 in [-96, 120] (sq8_limbs of
// q * scale); codes:[n, d] int8 row-major, 16-byte aligned, d % 4 == 0;
// out:[nq, n] fp32, 16-byte aligned; 1 <= blocks <= ceil(n /
// 64) blocks per 64 queries. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int quant_score_s8(const int8_t* limbs, const int* expo,
                              const int8_t* codes, float* out, int nq, int n,
                              int d, int blocks, void* stream) {
  if (nq < 1 || n < 1 || d < 4 || d % 4 != 0 || blocks < 1 ||
      blocks > (n + BN - 1) / BN || (nq + BQ - 1) / BQ > 65535 ||
      reinterpret_cast<uintptr_t>(codes) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = layout(d);
  const int tma = d % 16 == 0;
  CUtensorMap map = {}, lmap = {};
  if (!limb::encode_maps(&map, &lmap, codes, limbs, n, nq, d, tma, L.stream))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(blocks, (nq + BQ - 1) / BQ);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define QS_ARGS grid, L.bytes, st, map, lmap, codes, limbs, expo, out, nq, n, \
                d, tma
  switch (L.stream ? 0 : L.ch) {
    case 1: return launch<1, false>(QS_ARGS);
    case 2: return launch<2, false>(QS_ARGS);
    case 3: return launch<3, false>(QS_ARGS);
    default:
      return d > limb::EXACT_ADD_D ? launch<0, true>(QS_ARGS)
                                   : launch<0, false>(QS_ARGS);
  }
#undef QS_ARGS
}
