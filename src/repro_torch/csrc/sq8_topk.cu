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
// prescaled query row qs into LIMBS = 4 int8 limbs
// (repro_torch.kernels.fused_retrieve.sq8_limbs): with 2^e the least power
// of two >= max_j |qs_j|, limb 0 = round(qs 2^(6 - e)) and each further
// limb = round(residue 2^7), every limb in [-64, 64] and every step exact
// in fp32; it passes the limbs and e. Each limb's dot product a_l with a
// code row is an exact int32 sum, |a_l| <= 64 * 127 * d, which fits int32
// for d <= 264,208 and converts to fp32 exactly for d <= 2,064. The score
// is ((a_0 w_0 + a_1 w_1) + a_2 w_2) + a_3 w_3 with w_l = 2^(e - 6 - 7 l)
// built from its bits, each product exact, rounded add by add in that
// order (fused_retrieve.sq8_limb_scores computes the same bits in torch).
// Besides the fp32 rounding of the adds, the only error is the split:
// |score - qs . c| <= sum_j |c_j| 2^(e - 28). At the deployment width
// (d = 384, |c_j| <= 127; unit queries and rows, so |qs_j| <= scale_j <=
// 1/127 and e <= -6) that is at most 127 * 384 * 2^-34 = 2.8e-6, under the
// port's 1e-5 parity rule. Where qs are multiples of 2^(e - 27) (the tie
// inputs: multiples of 1/8) the split is exact and the scores equal the
// fp32 product's bit for bit.
//
// The design:
//  * A block of one consumer warpgroup (four warps) and one producer warp,
//    one block per SM; block (b, y) takes query rows 64y .. 64y + 63 and
//    walks code tiles b, b + G, b + 2G, ... (G = gridDim.x) of BN = 64 rows
//    with one top-k list per query: G lists per query to merge.
//  * A, the four limbs of the 64 query rows [4][64 x d_pad], stays resident
//    in shared memory in the 128-byte swizzle (96 KB at d = 384), written
//    once by every thread; columns past d and rows past nq are zero, so
//    whatever the code tile holds past d adds nothing. d_pad is d rounded
//    up to 128, at most 512; with the lists and buffers, a ring stage fits
//    at every k <= 128 for d <= 384, and at d = 512 for k <= 67.
//  * B, a [64 x d] code tile, is K-major as it lies in device memory. The
//    producer warp keeps tiles in flight through a ring of STAGES stages
//    (full/empty mbarriers; STAGES from the shared memory left after A,
//    the lists and the buffers: 3 at k = 16, 1 at k = 128, d = 384) with
//    the tile's 64 liveness bytes, loaded one tile ahead: by TMA
//    (cp.async.bulk.tensor, 128-column boxes in the 128-byte swizzle) when
//    d % 16 == 0, the row stride TMA needs; else by 4-byte cp.async into
//    the same swizzled layout (the contract's d % 4 == 0). The load path is
//    chosen by d alone.
//  * Per tile and k32 step the warpgroup issues one wgmma m64n64k32 per
//    limb; each thread then holds the four int32 sums of its 2 queries x 16
//    rows at the same accumulator positions and combines them in
//    registers. |a_l| < 2^22 (d <= 512), so a_l converts to fp32 by adding
//    its bits to those of 1.5 * 2^23 (an integer add, where the converter
//    runs at a quarter of the rate), and fma(that, w_l, -1.5 * 2^23 w_l)
//    is a_l w_l exactly.
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

#include "cp_async.cuh"
#include "merge_lists.cuh"
#include "sm90.cuh"
#include "topk_list.cuh"

namespace {

constexpr int LIMBS = 4;
constexpr int BQ = 64;              // query rows per block: wgmma's M
constexpr int BN = 64;              // code rows per tile: wgmma's N
constexpr int CHUNK_BYTES = 64 * 128;   // 64 rows of one 128-column chunk
constexpr int CONSUMERS = 128;      // one warpgroup
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr int MAX_STAGES = 4;
constexpr int MAX_CH = 4;           // d <= 512
constexpr int BUF = 64;             // candidates a query's buffer holds:
                                    // a whole tile's
constexpr int SMEM_MAX = 232448;    // shared memory a block may use (bytes)

// Shared memory, from a 1,024-byte boundary (the swizzle's period): A
// [LIMBS][ch][64][128], the ring [stages][ch][64][128], the ring's
// liveness bytes [stages][64], the lists' scores and rows [64][k] each,
// the buffers' scores and rows [64][BUF] each, the full and
// empty barriers [stages] each. A row is ch whole 128-column chunks, zero
// past d in A, so the k32 steps are 4 ch, known at compile time (the
// kernel is instantiated per ch).
struct Layout {
  int ch, stages;
  int b_off, live_off, ls_off, li_off, bs_off, bi_off, bar_off, bytes;
};

__host__ __device__ inline Layout layout(int d, int k) {
  Layout L;
  L.ch = (d + 127) / 128;
  const int a_bytes = LIMBS * L.ch * CHUNK_BYTES;
  const int stage = L.ch * CHUNK_BYTES + BN + 16;   // tile, live, barriers
  const int fixed = 1024 + a_bytes + 8 * BQ * (k + BUF);
  L.stages = (SMEM_MAX - fixed) / stage;
  if (L.stages > MAX_STAGES) L.stages = MAX_STAGES;
  const int lists = BQ * k, bufs = BQ * BUF;
  L.b_off = a_bytes;
  L.live_off = L.b_off + L.stages * L.ch * CHUNK_BYTES;
  L.ls_off = L.live_off + L.stages * BN;
  L.li_off = L.ls_off + 4 * lists;
  L.bs_off = L.li_off + 4 * lists;
  L.bi_off = L.bs_off + 4 * bufs;
  L.bar_off = L.bi_off + 4 * bufs;
  L.bytes = 1024 + L.bar_off + 16 * L.stages;
  return L;
}

// Byte offset of (row, column byte) of a 64-row tile of 128-column chunks
// in the 128-byte swizzle: the 16-byte unit u of row r sits at u ^ (r % 8).
__device__ __forceinline__ int swz(int row, int col) {
  return (col >> 7) * CHUNK_BYTES + row * 128 +
         ((((col >> 4) & 7) ^ (row & 7)) << 4) + (col & 15);
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

template <int CH>
__global__ void __launch_bounds__(THREADS, 1)
sq8_wgmma_kernel(const __grid_constant__ CUtensorMap codes_map,
                 const int8_t* __restrict__ codes,
                 const int8_t* __restrict__ limbs,
                 const int* __restrict__ expo,
                 const uint8_t* __restrict__ live, float* __restrict__ out_s,
                 int* __restrict__ out_i, int nq, int n, int d, int k,
                 int tma) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  const Layout L = layout(d, k);   // L.ch == CH
  unsigned char* a_s = smem;                 // [LIMBS][ch][64][128]
  unsigned char* b_s = smem + L.b_off;       // [stages][ch][64][128]
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

  // A: the block's limbs as 4-byte words (d % 4 == 0), zero past nq and d
  constexpr int words = CH * 32;             // words per row of a limb
  for (int e = tid; e < LIMBS * BQ * words; e += blockDim.x) {
    const int w = e % words, r = (e / words) % BQ, l = e / (words * BQ);
    const int col = 4 * w;
    uint32_t v = 0;
    if (q0 + r < nq && col < d)
      v = *reinterpret_cast<const uint32_t*>(
          limbs + (static_cast<size_t>(l) * nq + q0 + r) * d + col);
    *reinterpret_cast<uint32_t*>(a_s + l * CH * CHUNK_BYTES + swz(r, col)) = v;
  }
  sm90::fence_proxy_async();   // A is read by wgmma (the async proxy)
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
    if (tma && lane == 0) sm90::tma_prefetch_desc(&codes_map);
    // a tile's liveness bytes (rows lane and lane + 32) are loaded one tile
    // ahead, so their latency hides behind the wait for a free stage
    auto live_of = [&](int t, int r) {
      const long long g = static_cast<long long>(t) * BN + r;
      return t < n_tiles && g < n && live[g] != 0;
    };
    bool lv0 = live_of(blockIdx.x, lane), lv1 = live_of(blockIdx.x, lane + 32);
    int it = 0;
    for (int t = blockIdx.x; t < n_tiles; t += G, ++it) {
      const int s = it % L.stages;
      const uint32_t ph = (it / L.stages) & 1;
      sm90::mbar_wait(&empty[s], ph ^ 1);
      live_s[s * BN + lane] = lv0;
      live_s[s * BN + lane + 32] = lv1;
      unsigned char* dst = b_s + s * CH * CHUNK_BYTES;
      if (tma) {   // rows and columns past n and d read as zeros
        if (lane == 0) {
          sm90::mbar_expect_tx(&full[s], CH * CHUNK_BYTES);
#pragma unroll
          for (int c = 0; c < CH; ++c)
            sm90::tma_load_2d(dst + c * CHUNK_BYTES, &codes_map, &full[s],
                              c * 128, t * BN);
        } else {
          sm90::mbar_arrive(&full[s]);
        }
      } else {     // rows past n keep what they held: their rows are dead
        const long long base = static_cast<long long>(t) * BN;
        const int rw = d / 4;
        for (int e = lane; e < BN * rw; e += 32) {
          const int r = e / rw, col = 4 * (e % rw);
          if (base + r < n)
            cp_async4(dst + swz(r, col), codes + (base + r) * d + col);
        }
        cp_async_commit();
        cp_async_wait_0();
        sm90::fence_proxy_async();
        sm90::mbar_arrive(&full[s]);
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
  // this thread's queries: rows 16 warp + g + 8 i of the block
  // and the limbs' weights 2^(e - 6 - 7 l), built from their bits, with
  // -1.5 * 2^23 times each (the conversion's offset)
  float thr[2], w[2][LIMBS], wm[2][LIMBS];
  int nb[2] = {0, 0};   // candidates in the buffers of the two queries
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = q0 + 16 * warp + g + 8 * i;
    thr[i] = q < nq ? TOPK_NEG : INFINITY;   // a query past nq never selects
    const int e = q < nq ? expo[q] : 0;
#pragma unroll
    for (int l = 0; l < LIMBS; ++l) {
      w[i][l] = __int_as_float((e - 6 - 7 * l + 127) << 23);
      wm[i][l] = -12582912.f * w[i][l];
    }
  }
  // defined before the first wgmma: an undefined accumulator register makes
  // ptxas serialize every wgmma of the kernel
  int acc[LIMBS][32];
#pragma unroll
  for (int l = 0; l < LIMBS; ++l)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[l][e] = 0;

  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += G, ++it) {
    const int s = it % L.stages;
    sm90::mbar_wait(&full[s], (it / L.stages) & 1);
    const unsigned char* bs = b_s + s * CH * CHUNK_BYTES;
#pragma unroll
    for (int l = 0; l < LIMBS; ++l) sm90::reg_fence(acc[l]);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * CH; ++kk) {
      const int off = (kk >> 2) * CHUNK_BYTES + (kk & 3) * 32;
      const uint64_t db = sm90::desc_sw128(bs + off);
#pragma unroll
      for (int l = 0; l < LIMBS; ++l)
        sm90::wgmma_m64n64k32_s8_ss(
            acc[l], sm90::desc_sw128(a_s + l * CH * CHUNK_BYTES + off), db,
            kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int l = 0; l < LIMBS; ++l) sm90::reg_fence(acc[l]);
    // liveness of this thread's rows 8j + 2 t4 + c: bit 2j + c
    uint32_t okm = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t v = *reinterpret_cast<const uint16_t*>(
          live_s + s * BN + 8 * j + 2 * t4);
      okm |= ((v & 1u) | ((v >> 7) & 2u)) << (2 * j);
    }
    sm90::mbar_arrive(&empty[s]);   // the tile is free for the producer

    // the scores: four exact int32 sums, combined in a fixed order
    float sc[2][8][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * i + c;
          float v = __fmaf_rn(__int_as_float(acc[0][e] + 0x4B400000), w[i][0],
                              wm[i][0]);
#pragma unroll
          for (int l = 1; l < LIMBS; ++l)
            v = __fadd_rn(v, __fmaf_rn(__int_as_float(acc[l][e] + 0x4B400000),
                                       w[i][l], wm[i][l]));
          sc[i][j][c] = v;
        }

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

// codes [n, d] int8 as a 2-d uint8 map (d, n) read in boxes of 128 columns x
// 64 rows in the 128-byte swizzle; columns past d and rows past n read as
// zeros. TMA needs the row stride, d bytes, to be a multiple of 16.
bool encode_codes(CUtensorMap* map, const int8_t* codes, int n, int d) {
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

template <int CH>
int launch(dim3 grid, int smem, cudaStream_t stream, const CUtensorMap& map,
           const int8_t* codes, const int8_t* limbs, const int* expo,
           const uint8_t* live, float* out_s, int* out_i, int nq, int n,
           int d, int k, int tma) {
  const cudaError_t err = cudaFuncSetAttribute(
      sq8_wgmma_kernel<CH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  sq8_wgmma_kernel<CH><<<grid, THREADS, smem, stream>>>(
      map, codes, limbs, expo, live, out_s, out_i, nq, n, d, k, tma);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sq8_topk_tile_rows() { return BN; }

// Dynamic shared memory per block the launcher requests for rows of width d
// and lists of k; 0 where not even one ring stage fits.
extern "C" int sq8_topk_smem_bytes(int d, int k) {
  const Layout L = layout(d, k);
  return L.stages >= 1 && L.ch <= MAX_CH ? L.bytes : 0;
}

extern "C" const char* sq8_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// limbs:[4, nq, d] int8 and expo:[nq] int32 in [-96, 120] (sq8_limbs of
// q * scale); codes:[n, d] int8 row-major, 16-byte aligned, d % 4 == 0,
// sq8_topk_smem_bytes(d, k) > 0; live:[n] bytes; out_s/out_i:
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
  if (L.stages < 1 || L.ch > MAX_CH)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tma = d % 16 == 0;
  CUtensorMap map = {};
  if (tma && !encode_codes(&map, codes, n, d))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_lists, (nq + BQ - 1) / BQ);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  switch (L.ch) {
    case 1: err = launch<1>(grid, L.bytes, st, map, codes, limbs, expo, live,
                            out_s, out_i, nq, n, d, k, tma); break;
    case 2: err = launch<2>(grid, L.bytes, st, map, codes, limbs, expo, live,
                            out_s, out_i, nq, n, d, k, tma); break;
    case 3: err = launch<3>(grid, L.bytes, st, map, codes, limbs, expo, live,
                            out_s, out_i, nq, n, d, k, tma); break;
    default: err = launch<4>(grid, L.bytes, st, map, codes, limbs, expo,
                             live, out_s, out_i, nq, n, d, k, tma); break;
  }
  if (err != 0) return err;
  return static_cast<int>(merge::launch_merge(
      out_s, out_i, out_i, top_s, top_i, nq, n_lists, k, st));
}
