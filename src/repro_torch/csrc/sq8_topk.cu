// SQ-int8 top-k: the vector DB's flat sq8 index on the `fused` rung. Scores
// are qs . codes[j] with qs = q * scale, masked by `live`, reduced to each
// block's top-k lists.
//
// Replaces: src/repro/kernels/fused_retrieve.py, sq8_topk_pallas with
// _sq8_tile_kernel, the TPU kernel that upcasts one (1024 x d) int8 code
// tile in VMEM, scores it against a (128 x d) query block on the MXU and
// reduces it to the tile's top-k by k rounds of max/argmax.
//
// What bounds it on an H100: each code row (d bytes) feeds one d-long dot
// product per query, 2 * nq operations per byte: 128 at 64 queries, below
// the 590 operations per byte of the int8 tensor cores (1,979 TOP/s over
// 3.35 TB/s), so on the tensor cores the code bytes bound it (0.40 GB, 0.12
// ms at N = 1,048,576 x 384). On the fp32 FMA units (67 TFLOP/s, 20 per
// byte) the same work takes 0.77 ms.
//
// Exact on int8 tensor cores (wgmma ... .s32.s8.s8): the caller splits each
// prescaled query row qs into four int8 limbs and the kernel scores them
// against the codes with the product of sq8_limb.cuh (shared with
// quant_score.cu), whose header states the arithmetic and its error bound
// (at most 127 d 2^-34 for unit rows: 2.8e-6 at d = 384, 7.6e-6 at
// d = 1,024). The scores equal fused_retrieve.sq8_limb_scores bit for bit.
//
// The design:
//  * A block of one consumer warpgroup (four warps) and one producer warp,
//    one block per SM; block (b, y) takes query rows 64y .. 64y + 63 and
//    walks code tiles b, b + G, b + 2G, ... (G = gridDim.x) of BN = 64 rows
//    with one top-k list per query: G lists per query to merge.
//  * A, the four limbs of the 64 query rows, stays resident in shared
//    memory at d <= 384 (96 KB at d = 384; sq8_limb.cuh), written once by
//    every thread. B, a [64 x d] code tile, is K-major as it lies in device
//    memory. The producer warp keeps tiles in flight through a ring of
//    STAGES stages (full/empty mbarriers; STAGES from the shared memory
//    left after A, the lists and the buffers: 3 at k = 16, 1 at k = 128,
//    d = 384) with the tile's 64 liveness bytes, loaded one tile ahead.
//    Wider rows do not leave room for resident limbs, so a
//    stage holds one 128-column chunk of the tile and the same chunk of the
//    four limbs, ceil(d / 128) stages a tile (3 at k = 128, 4 at k = 16);
//    every tile then reads the block's limbs again, from L2: four times
//    its own code bytes. Loads by TMA when d % 16 == 0, else by 4-byte cp.async; the load path
//    is chosen by d alone.
//  * Per tile and k32 step the warpgroup issues one wgmma m64n64k32 per
//    limb; each thread then holds the four int32 sums of its 2 queries x 16
//    rows at the same accumulator positions and combines them in
//    registers (limb::score).
//  * Selection from registers, in batches: warp w owns queries 16w ..
//    16w + 15, the four lanes of a quad share one, and each thread keeps
//    the thresholds of its two queries (their lists' k-th scores). A
//    thread marks its live (score, row) pairs above them and writes them to
//    its query's buffer of BUF = 64 in shared memory, after those of the
//    quad's lower lanes (a scan over the quad; no ballot). A buffer that
//    this tile could overflow, and every buffer at the end, is merged into
//    its list by the warp (merge_buffer, topk_list.cuh): each entry's rank
//    in the union by (score descending, row ascending) is a list entry's
//    index plus the buffer candidates ahead of it, or a buffer candidate's
//    place in the list (binary search) plus the buffer candidates ahead of
//    it; the entries of rank below k are scattered and the quad's
//    thresholds rise to the new k-th score. One warp per scheduler cannot
//    hide the latency of inserting candidates one at a time (topk_search's
//    way, with 16 warps an SM there), and one merge site keeps the tile
//    loop's code small: a copy of the merge in each row group's path made
//    the whole loop, products and scores included, slower. No score tile
//    passes through shared memory and no block barrier is taken. Rows are
//    distinct, so the order is total: equal scores keep the lower row, the
//    tie order of lax.top_k over the whole score matrix.
//  * Output [nq, G, k] lists, each in descending score with the lower row
//    first on ties, (NEG, -1) padded, and their merge, the [nq, k]
//    result, by a second kernel launched from the same entry point
//    (merge_lists.cuh).
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "merge_lists.cuh"
#include "sm90.cuh"
#include "sq8_limb.cuh"
#include "topk_list.cuh"

namespace {

using limb::BN;
using limb::BQ;
using limb::CHUNK_BYTES;
using limb::LIMBS;
constexpr int CONSUMERS = 128;      // one warpgroup
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr int MAX_STAGES = 4;
constexpr int BUF = 64;             // candidates a query's buffer holds:
                                    // a whole tile's
constexpr int SMEM_MAX = 232448;    // shared memory a block may use (bytes)

// Shared memory, from a 1,024-byte boundary (the swizzle's period): A
// [LIMBS][ch][64][128] (resident limbs only), the ring [stages][stage
// bytes], the ring's liveness bytes [stages][64], the lists' scores and
// rows [64][k] each, the buffers' scores and rows [64][BUF] each, the full
// and empty barriers [stages] each. With resident limbs a row is ch whole
// 128-column chunks, zero past d in A, so the k32 steps are 4 ch, known at
// compile time (the kernel is instantiated per ch); a stage is a whole
// tile. Streaming, a stage is one chunk of the tile and of the limbs.
struct Layout {
  int ch, stages, stage_bytes;
  bool stream;
  int b_off, live_off, ls_off, li_off, bs_off, bi_off, bar_off, bytes;
};

__host__ __device__ inline Layout layout(int d, int k) {
  Layout L;
  L.ch = (d + 127) / 128;
  L.stream = L.ch > limb::RESIDENT_CH;
  const int a_bytes = L.stream ? 0 : LIMBS * L.ch * CHUNK_BYTES;
  L.stage_bytes = L.stream ? limb::STREAM_STAGE_BYTES : L.ch * CHUNK_BYTES;
  const int stage = L.stage_bytes + BN + 16;   // tile, live, barriers
  const int fixed = 1024 + a_bytes + 8 * BQ * (k + BUF);
  L.stages = (SMEM_MAX - fixed) / stage;
  if (L.stages > MAX_STAGES) L.stages = MAX_STAGES;
  const int lists = BQ * k, bufs = BQ * BUF;
  L.b_off = a_bytes;
  L.live_off = L.b_off + L.stages * L.stage_bytes;
  L.ls_off = L.live_off + L.stages * BN;
  L.li_off = L.ls_off + 4 * lists;
  L.bs_off = L.li_off + 4 * lists;
  L.bi_off = L.bs_off + 4 * bufs;
  L.bar_off = L.bi_off + 4 * bufs;
  L.bytes = 1024 + L.bar_off + 16 * L.stages;
  return L;
}

// Over the four lanes of a quad (t4 = lane % 4): the sum of v over the
// lanes below this one, and over all four.
__device__ __forceinline__ void quad_scan(int v, int t4, int& below,
                                          int& total) {
  int x = v;
  const int y1 = __shfl_up_sync(FULL_MASK, x, 1, 4);
  if (t4 >= 1) x += y1;
  const int y2 = __shfl_up_sync(FULL_MASK, x, 2, 4);
  if (t4 >= 2) x += y2;
  below = x - v;
  total = __shfl_sync(FULL_MASK, x, 3, 4);
}

// Merge the buffers of the quads in need0 (query slot 0) and need1 (slot
// 1), ballots that set a quad's four lanes together, into their lists, one
// query at a time (query 16 warp + 8 i + the quad); the quads' lanes take
// the new k-th score as their threshold and empty their buffers. One merge
// site for both slots keeps the tile loop's code small.
__device__ __forceinline__ void flush(unsigned need0, unsigned need1,
                                      int warp, int lane, int k, float* lsb,
                                      int* lib, const float* bsb,
                                      const int* bib, int (&nb)[2],
                                      float (&thr)[2]) {
  while (need0 | need1) {
    const int i = need0 ? 0 : 1;
    const int gq = (__ffs(i ? need1 : need0) - 1) >> 2;
    const int qq = 16 * warp + gq + 8 * i;
    const int n = __shfl_sync(FULL_MASK, i ? nb[1] : nb[0], 4 * gq);
    const float kth = merge_buffer<BUF / 32>(lsb + qq * k, lib + qq * k, k,
                                             bsb + qq * BUF, bib + qq * BUF,
                                             n, lane);
    if ((lane >> 2) == gq) {
      if (i) {
        nb[1] = 0;
        thr[1] = kth;
      } else {
        nb[0] = 0;
        thr[0] = kth;
      }
    }
    if (i)
      need1 &= ~(0xFu << (4 * gq));
    else
      need0 &= ~(0xFu << (4 * gq));
  }
}

// Liveness of this thread's rows 8j + 2 t4 + c of a tile: bit 2j + c.
__device__ __forceinline__ uint32_t live_bits(const uint8_t* live_t, int t4) {
  uint32_t okm = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t v =
        *reinterpret_cast<const uint16_t*>(live_t + 8 * j + 2 * t4);
    okm |= ((v & 1u) | ((v >> 7) & 2u)) << (2 * j);
  }
  return okm;
}

// CH > 0: the limbs resident, a tile of CH chunks a stage; CH == 0: the
// limbs stream, a chunk a stage. WIDE: d > limb::EXACT_ADD_D.
template <int CH, bool WIDE>
__global__ void __launch_bounds__(THREADS, 1)
sq8_wgmma_kernel(const __grid_constant__ CUtensorMap codes_map,
                 const __grid_constant__ CUtensorMap limbs_map,
                 const int8_t* __restrict__ codes,
                 const int8_t* __restrict__ limbs,
                 const int* __restrict__ expo,
                 const uint8_t* __restrict__ live, float* __restrict__ out_s,
                 int* __restrict__ out_i, int nq, int n, int d, int k,
                 int tma) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  const Layout L = layout(d, k);   // L.ch == CH where CH > 0
  unsigned char* a_s = smem;                 // [LIMBS][ch][64][128]
  unsigned char* b_s = smem + L.b_off;       // [stages][stage bytes]
  uint8_t* live_s = smem + L.live_off;       // [stages][64]
  float* lsb = reinterpret_cast<float*>(smem + L.ls_off);   // [64][k]
  int* lib = reinterpret_cast<int*>(smem + L.li_off);
  float* bsb = reinterpret_cast<float*>(smem + L.bs_off);   // [64][BUF]
  int* bib = reinterpret_cast<int*>(smem + L.bi_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar_off);
  uint64_t* empty = full + L.stages;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int G = gridDim.x;
  const int n_tiles = (n + BN - 1) / BN;
  // ring stages a tile takes
  const int per_tile = CH > 0 ? 1 : L.ch;

  if constexpr (CH > 0) {
    limb::load_resident<CH>(a_s, limbs, nq, d, q0, tid, blockDim.x);
    sm90::fence_proxy_async();   // A is read by wgmma (the async proxy)
  }
  if (tid == 0) {
    for (int s = 0; s < L.stages; ++s) {
      sm90::mbar_init(&full[s], 32);          // the producer warp's lanes
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
    // a tile's liveness bytes (rows lane and lane + 32) are loaded one tile
    // ahead, so their latency hides behind the wait for a free stage
    auto live_of = [&](int t, int r) {
      const long long g = static_cast<long long>(t) * BN + r;
      return t < n_tiles && g < n && live[g] != 0;
    };
    bool lv0 = live_of(blockIdx.x, lane), lv1 = live_of(blockIdx.x, lane + 32);
    int u = 0;   // stages filled
    for (int t = blockIdx.x; t < n_tiles; t += G) {
      for (int c = 0; c < per_tile; ++c, ++u) {
        const int s = u % L.stages;
        sm90::mbar_wait(&empty[s], ((u / L.stages) & 1) ^ 1);
        if (c == 0) {   // a tile's liveness goes with its first stage
          live_s[s * BN + lane] = lv0;
          live_s[s * BN + lane + 32] = lv1;
        }
        unsigned char* dst = b_s + s * L.stage_bytes;
        if constexpr (CH > 0)
          limb::load_stage(&codes_map, &limbs_map, codes, limbs, n, nq, d, t,
                           0, CH, q0, tma, dst, nullptr, &full[s], lane);
        else
          limb::load_stage(&codes_map, &limbs_map, codes, limbs, n, nq, d, t,
                           c, 1, q0, tma, dst, dst + CHUNK_BYTES, &full[s],
                           lane);
      }
      lv0 = live_of(t + G, lane);
      lv1 = live_of(t + G, lane + 32);
    }
    return;
  }

  // the consumer warpgroup
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  for (int qq = 16 * warp; qq < 16 * warp + 16; ++qq)
    list_clear(lsb + qq * k, lib + qq * k, k, lane, 32);
  __syncwarp();
  // this thread's queries: rows 16 warp + g + 8 i of the block, and their
  // limbs' weights
  float thr[2], w[2][LIMBS], wm[2][LIMBS];
  int nb[2] = {0, 0};   // candidates in the buffers of the two queries
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = q0 + 16 * warp + g + 8 * i;
    thr[i] = q < nq ? TOPK_NEG : INFINITY;   // a query past nq never selects
    limb::weights(q < nq ? expo[q] : 0, w[i], wm[i]);
  }
  // defined before the first wgmma: an undefined accumulator register makes
  // ptxas serialize every wgmma of the kernel
  int acc[LIMBS][32];
#pragma unroll
  for (int l = 0; l < LIMBS; ++l)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[l][e] = 0;

  int u = 0;   // stages consumed
  for (int t = blockIdx.x; t < n_tiles; t += G) {
    uint32_t okm = 0;
    for (int c = 0; c < per_tile; ++c, ++u) {
      const int s = u % L.stages;
      sm90::mbar_wait(&full[s], (u / L.stages) & 1);
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
      if (c == 0) okm = live_bits(live_s + s * BN, t4);
      sm90::mbar_arrive(&empty[s]);   // the stage is free for the producer
    }

    // the scores: four exact int32 sums, combined in a fixed order
    float sc[2][8][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          sc[i][j][c] = limb::score<WIDE>(acc, 4 * j + 2 * i + c, w[i], wm[i]);

    // selection: per query slot i, the live pairs above the thresholds
    // (pm, bit 2j + c) go to their query's buffer. A tile adds at most 64
    // (BUF) a query, so a buffer that could overflow is merged into its
    // list before the tile's candidates are placed, and the thresholds rise
    uint32_t pm[2];
    int cnt[2], lower[2];   // the quad's candidates; its lower lanes'
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      pm[i] = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          pm[i] |= static_cast<uint32_t>(((okm >> (2 * j + c)) & 1) &&
                                         sc[i][j][c] > thr[i])
                   << (2 * j + c);
      quad_scan(__popc(pm[i]), t4, lower[i], cnt[i]);
    }
    const unsigned need0 = __ballot_sync(FULL_MASK, nb[0] + cnt[0] > BUF);
    const unsigned need1 = __ballot_sync(FULL_MASK, nb[1] + cnt[1] > BUF);
    if (need0 | need1) {
      flush(need0, need1, warp, lane, k, lsb, lib, bsb, bib, nb, thr);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (!(sc[i][j][c] > thr[i])) pm[i] &= ~(1u << (2 * j + c));
        quad_scan(__popc(pm[i]), t4, lower[i], cnt[i]);
      }
    }
    // each lane places its candidates after those of the quad's lanes
    // below it (the buffer's order does not matter)
    const int row0 = t * BN;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (pm[i]) {
        float* bq = bsb + (16 * warp + g + 8 * i) * BUF;
        int* bqi = bib + (16 * warp + g + 8 * i) * BUF;
        int at = nb[i] + lower[i];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if ((pm[i] >> (2 * j + c)) & 1) {
              bq[at] = sc[i][j][c];
              bqi[at] = row0 + 8 * j + 2 * t4 + c;
              ++at;
            }
      }
      nb[i] += cnt[i];
    }
  }
  // the last candidates
  flush(__ballot_sync(FULL_MASK, nb[0] > 0),
        __ballot_sync(FULL_MASK, nb[1] > 0), warp, lane, k, lsb, lib, bsb, bib,
        nb, thr);

  // each warp writes the lists of its own queries
  __syncwarp();
  for (int qq = 16 * warp; qq < 16 * warp + 16 && q0 + qq < nq; ++qq) {
    const size_t o =
        (static_cast<size_t>(q0 + qq) * G + blockIdx.x) * k;
    for (int e = lane; e < k; e += 32) {
      out_s[o + e] = lsb[qq * k + e];
      out_i[o + e] = lib[qq * k + e];
    }
  }
}

template <int CH, bool WIDE>
int launch(dim3 grid, int smem, cudaStream_t stream, const CUtensorMap& map,
           const CUtensorMap& lmap, const int8_t* codes, const int8_t* limbs,
           const int* expo, const uint8_t* live, float* out_s, int* out_i,
           int nq, int n, int d, int k, int tma) {
  const cudaError_t err = cudaFuncSetAttribute(
      sq8_wgmma_kernel<CH, WIDE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  sq8_wgmma_kernel<CH, WIDE><<<grid, THREADS, smem, stream>>>(
      map, lmap, codes, limbs, expo, live, out_s, out_i, nq, n, d, k, tma);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sq8_topk_tile_rows() { return BN; }

// Dynamic shared memory per block the launcher requests for rows of width d
// and lists of k; 0 where not even one ring stage fits (every k <= 128
// fits at every d).
extern "C" int sq8_topk_smem_bytes(int d, int k) {
  const Layout L = layout(d, k);
  return L.stages >= 1 ? L.bytes : 0;
}

extern "C" const char* sq8_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// limbs:[4, nq, d] int8 and expo:[nq] int32 in [-96, 120] (sq8_limbs of
// q * scale); codes:[n, d] int8 row-major, 16-byte aligned, d % 4 == 0;
// live:[n] bytes; out_s/out_i:
// [nq, n_lists, k] with 1 <= n_lists <= ceil(n / 64): list b covers tiles
// b, b + n_lists, b + 2 n_lists, ...; top_s/top_i: [nq, k],
// their merge. Launches both kernels on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int sq8_topk_s8(const int8_t* limbs, const int* expo,
                           const int8_t* codes, const uint8_t* live,
                           float* out_s, int* out_i, float* top_s, int* top_i,
                           int nq, int n, int d, int k, int n_lists,
                           void* stream) {
  if (nq < 1 || n < 1 || d < 4 || d % 4 != 0 || k < 1 || k > TOPK_MAX_K ||
      n_lists < 1 || n_lists > (n + BN - 1) / BN ||
      (nq + BQ - 1) / BQ > 65535 ||
      reinterpret_cast<uintptr_t>(codes) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = layout(d, k);
  if (L.stages < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int tma = d % 16 == 0;
  CUtensorMap map = {}, lmap = {};
  if (!limb::encode_maps(&map, &lmap, codes, limbs, n, nq, d, tma, L.stream))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_lists, (nq + BQ - 1) / BQ);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SQ8_ARGS grid, L.bytes, st, map, lmap, codes, limbs, expo, live, \
                 out_s, out_i, nq, n, d, k, tma
  int err;
  switch (L.stream ? 0 : L.ch) {
    case 1: err = launch<1, false>(SQ8_ARGS); break;
    case 2: err = launch<2, false>(SQ8_ARGS); break;
    case 3: err = launch<3, false>(SQ8_ARGS); break;
    default:
      err = d > limb::EXACT_ADD_D ? launch<0, true>(SQ8_ARGS)
                                  : launch<0, false>(SQ8_ARGS);
      break;
  }
#undef SQ8_ARGS
  if (err != 0) return err;
  return static_cast<int>(merge::launch_merge(
      out_s, out_i, out_i, top_s, top_i, nq, n_lists, k, st));
}
