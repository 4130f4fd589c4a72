// Attention with an online softmax, causal or not, with grouped-query heads:
// o = softmax(q k^T / sqrt(dh)) v for q:[B,H,S,dh], k/v:[B,Hkv,S,dh]
// (query head h reads KV head h / (H / Hkv)), output in q's dtype, and with
// a runtime sliding window (window > 0; 0 is none) the keys j <= i - window
// of query i masked on top of causality, as the reference model's
// attention_scores_mask. The prefill of every layer of the generator
// (causal; Zamba2's shared block with its 4,096-key window), Whisper's
// encoder (not causal) and decoder, and the forward of the embedder and
// the cross-encoder (not causal).
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_pallas with
// _flash_kernel, the TPU kernel whose grid walks (batch*head, q block) and
// sweeps the whole K/V sequence in VMEM with a fori_loop, keeping the
// running max, the normaliser and the output accumulator in fp32 scratch,
// with the loop bounded at the q block's last row when causal.
//
// What bounds it on an H100: at the generator's prefill shape (B=8, H=32,
// Hkv=8, S=512, dh=128, bf16, causal) the function must move q, k, v and o
// once, about 84 MB, which takes 25 us at 3.35 TB/s, and does about
// 17 GFLOP (4*B*H*S^2*dh, halved by causality), 17 us at the 989 TFLOP/s
// bf16 tensor peak: so bytes, as long as the products run at the tensor
// cores' rate, which on Hopper only wgmma reaches. In fp32 scalar FMAs the
// same work would take 0.26 ms. A window bounds the work by the keys each
// row sees: at most 4*B*H*S*min(S, window)*dh FLOP (exactly 4*B*H*dh times
// the visible (i, j) pairs), while the bytes stay those of q, k, v and o.
//
// Which design runs where (picked by dtype and dh alone):
//  * bf16, dh 64 or 128 (every deployment shape): the Hopper kernel below
//    (namespace wg), sm_90a only.
//  * bf16, dh 16, 32 or 256: mma.sync.
//  * fp32, dh 16, 32, 64, 128 or 256: scalar fp32 FMAs, exact fp32 as the
//    TPU kernel computes.
// Other head dims arrive zero-padded to the next of these by the wrapper,
// with the true dh as an argument: the softmax scale is 1/sqrt(true dh),
// and zero columns add nothing to q.k or to the output's true columns.
// On request (a non-null lse pointer: the training forward), each of the
// three also writes every row's natural log-sum-exp of its scaled logits,
// fp32 [B,H,S], from the running max and normaliser it already holds, in
// its epilogue only; flash_attention_bwd.cu recomputes P from it. A null
// pointer (serving) leaves the schedule as it was.
//
// What the Hopper design does about the bound:
//  * A block of three warpgroups per 128-row q tile: one producer thread
//    issues every load as a TMA tile copy (cp.async.bulk.tensor) into the
//    128-byte swizzle, so the consumers spend no instructions or registers
//    on addresses; setmaxnreg moves registers from the producer warpgroup
//    to the two consumer warpgroups (64 query rows each). Q is double
//    buffered, so the next tile's Q loads during this one; K and V run
//    through a 2-stage ring of 128-key tiles with a full and an empty
//    barrier per operand and stage: a K tile is released as soon as
//    S = Q K^T has landed, a V tile once O += P V has. At dh=128: 2 x Q
//    32 KB + 2 x (K 32 KB + V 32 KB) = 192 KB of shared memory.
//  * S = Q K^T runs as wgmma m64n128k16 with both operands read from
//    shared memory; the online softmax runs in base 2 on the fp32
//    accumulator fragment in registers; P is rounded to bf16 in registers
//    (as the reference rounds its probabilities) and fed as wgmma's A
//    operand from registers for O += P V, V read from shared memory as an
//    MN-major (transposed) B operand, 64 output columns per instruction.
//    The two consumers take turns to issue their products (named
//    barriers), so one's softmax runs while the other's products do.
//  * The tensor maps carry the callers' strides (unit stride in dh,
//    16-byte multiples elsewhere), so a [B,S,H,dh] activation read as
//    [B,H,S,dh] needs no copy, and the KV head h / (H / Hkv) is a TMA
//    coordinate: K and V are never repeated in memory. The output is
//    stored in q's layout. The maps are encoded on the host with
//    cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint
//    (ByVersion): the library links the runtime only.
//  * Causal: K/V tiles past the q tile's last row are never loaded; only
//    the diagonal tile and the ragged last tile are masked; q tiles are
//    walked heaviest first (tile t = q tile n_qt-1-t/BH) by a persistent
//    grid of one block per SM that strides over that order (faster than
//    one block per tile at the prefill shapes; PERF.md). Rows past S read
//    as zeros
//    (TMA) and are not stored; the running max starts finite, so a fully
//    masked tile adds nothing and no NaN appears; causal row 0 is v[0].
//  * Window (all three kernels): the key-tile loop starts at the tile that
//    holds q_first - window + 1, q_first the block's (or wgmma tile's)
//    first row, so tiles wholly before every row's window are never
//    loaded; a tile that reaches below some row's window is masked with
//    the same -inf rule as the causal diagonal. Every row sees at least
//    its own key (window >= 1), so no row is left empty. At window 0 the
//    loop bounds and the tile schedule are those without a window, and
//    the window's masking pass is skipped.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "cp_async.cuh"
#include "mma_sync.cuh"
#include "sm90.cuh"

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // key/value rows per tile
constexpr int THREADS = 128;    // 4 warps, 16 query rows each
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float M_INIT = -1.0e30f;   // running max before any key

using bf16 = __nv_bfloat16;

// Rows row0 .. row0+63 of a [S, DH] bf16 head into shared memory with row
// pitch DH + 8; rows past S are zero-filled.
template <int DH>
__device__ __forceinline__ void load_tile(bf16* sm, const bf16* g, int row0,
                                          int S, int tid) {
  constexpr int CPR = DH / 8;   // 16-byte chunks per row
#pragma unroll
  for (int c = tid; c < BK * CPR; c += THREADS) {
    const int r = c / CPR, col = (c % CPR) * 8;
    const bool ok = row0 + r < S;
    cp_async16(sm + r * (DH + 8) + col,
               g + static_cast<size_t>(ok ? row0 + r : 0) * DH + col, ok);
  }
}

// bf16 at dh 16 and 32: one block of 4 warps per (b*h, 64-row q tile),
// heaviest causal tiles first, each warp owning 16 query rows. Q, then each
// 64-row K and V tile, go to shared memory with cp.async (rows padded by 16
// bytes, so ldmatrix is free of bank conflicts); S = Q K^T and O += P V run
// as mma.sync.m16n8k16 with fp32 accumulators, P being the S fragment
// rounded to bf16 in registers.
template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o,
                  float* __restrict__ lse, int H, int rep, int S, int window,
                  float scale_log2) {
  constexpr int LD = DH + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);   // [BQ][LD]
  bf16* ks = qs + BQ * LD;                     // [BK][LD]
  bf16* vs = ks + BK * LD;                     // [BK][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest tiles first
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const size_t head = static_cast<size_t>(S) * DH;
  const bf16* qg = q + bh * head;
  const size_t kvh = static_cast<size_t>(b) * (H / rep) + h / rep;
  const bf16* kg = k + kvh * head;
  const bf16* vg = v + kvh * head;
  const int n_all = (S + BK - 1) / BK;
  const int n_kt = CAUSAL ? min(n_all, (q0 + BQ - 1) / BK + 1) : n_all;
  // the first key tile any row of the block sees through its window
  const int j0 = window > 0 ? max(0, q0 - window + 1) / BK : 0;

  load_tile<DH>(qs, qg, q0, S, tid);
  load_tile<DH>(ks, kg, j0 * BK, S, tid);
  cp_async_commit();
  load_tile<DH>(vs, vg, j0 * BK, S, tid);
  cp_async_commit();

  uint32_t qf[DH / 16][4];
  float oacc[DH / 8][4];
#pragma unroll
  for (int dn = 0; dn < DH / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[dn][e] = 0.f;
  float m_r[2] = {M_INIT, M_INIT}, l_r[2] = {0.f, 0.f};
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  for (int j = j0; j < n_kt; ++j) {
    cp_async_wait_1();   // K_j (and Q) landed; V_j may be in flight
    __syncthreads();
    if (j == j0) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        ldsm_x4(qf[kk], qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8)
                                 * LD + kk * 16 + (lane >> 4) * 8);
    }
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
      for (int n = 0; n < BK / 8; n += 2) {
        uint32_t kf[4];   // b0, b1 of key rows 8n.., then of 8n+8..
        ldsm_x4(kf, ks + (n * 8 + (lane & 7) + (lane >> 4) * 8) * LD +
                         kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[n], qf[kk], kf[0], kf[1]);
        mma_bf16(s[n + 1], qf[kk], kf[2], kf[3]);
      }
    __syncthreads();   // every warp is done with ks
    if (j + 1 < n_kt) load_tile<DH>(ks, kg, (j + 1) * BK, S, tid);
    cp_async_commit();

    // online softmax in base 2 over this thread's rows g and g + 8
    const int kv0 = j * BK;
    const bool masked = kv0 + BK > S || (CAUSAL && kv0 + BK - 1 > q0) ||
                        (window > 0 && kv0 <= q0 + BQ - 1 - window);
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = M_INIT;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          float x = s[n][e] * scale_log2;
          const int col = kv0 + n * 8 + 2 * t + (e & 1);
          if (masked && (col >= S || (CAUSAL && col > row[i]) ||
                         (window > 0 && col <= row[i] - window)))
            x = -INFINITY;
          s[n][e] = x;
          mx = fmaxf(mx, x);
        }
      const float m_new = fmaxf(m_r[i], quad_max(mx));
      alpha[i] = exp2f(m_r[i] - m_new);
      m_r[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          s[n][e] = exp2f(s[n][e] - m_new);
          sum += s[n][e];
        }
      l_r[i] = l_r[i] * alpha[i] + sum;   // this lane's columns only
    }
#pragma unroll
    for (int dn = 0; dn < DH / 8; ++dn) {
      oacc[dn][0] *= alpha[0];
      oacc[dn][1] *= alpha[0];
      oacc[dn][2] *= alpha[1];
      oacc[dn][3] *= alpha[1];
    }

    cp_async_wait_1();   // V_j landed; K_{j+1} may be in flight
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {   // key rows 16kk .. 16kk+15
      const uint32_t pf[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < DH / 8; dn += 2) {
        uint32_t vf[4];   // b0, b1 of columns 8dn.., then of 8dn+8..
        ldsm_x4_t(vf, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                          dn * 8 + (lane >> 4) * 8);
        mma_bf16(oacc[dn], pf, vf[0], vf[1]);
        mma_bf16(oacc[dn + 1], pf, vf[2], vf[3]);
      }
    }
    __syncthreads();   // every warp is done with vs
    if (j + 1 < n_kt) load_tile<DH>(vs, vg, (j + 1) * BK, S, tid);
    cp_async_commit();
  }

  bf16* og = o + bh * head;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l = fmaxf(quad_sum(l_r[i]), 1e-30f);
    if (row[i] >= S) continue;
    // the row's natural log-sum-exp of its scaled logits, on request (m_r
    // and the exponents are in base 2)
    if (lse != nullptr && t == 0)
      lse[static_cast<size_t>(bh) * S + row[i]] = (m_r[i] + log2f(l)) * LN2;
#pragma unroll
    for (int dn = 0; dn < DH / 8; ++dn)
      *reinterpret_cast<uint32_t*>(og + static_cast<size_t>(row[i]) * DH +
                                   dn * 8 + 2 * t) =
          pack_bf16(oacc[dn][2 * i] / l, oacc[dn][2 * i + 1] / l);
  }
}

// fp32: thread (r = tid / 2, half = tid % 2) owns query row q0 + r, the key
// columns 2i + half of each tile and the output columns 2i + half. Rows of
// Q and K are padded by one float so the two halves hit different banks.
template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int H, int rep, int S, int window,
                 float scale) {
  constexpr int LD = DH + 1, LP = BK + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);   // [BQ][LD], scaled
  float* ks = qs + BQ * LD;                      // [BK][LD]
  float* vs = ks + BK * LD;                      // [BK][DH]
  float* ps = vs + BK * DH;                      // [BQ][LP]

  const int tid = threadIdx.x, r = tid >> 1, half = tid & 1;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const size_t head = static_cast<size_t>(S) * DH;
  const size_t kvh = static_cast<size_t>(b) * (H / rep) + h / rep;
  const float* kg = k + kvh * head;
  const float* vg = v + kvh * head;
  const int n_all = (S + BK - 1) / BK;
  const int n_kt = CAUSAL ? min(n_all, (q0 + BQ - 1) / BK + 1) : n_all;
  const int j0 = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int qrow = q0 + r;

  for (int c = tid; c < BQ * DH; c += THREADS) {
    const int rr = c / DH, d = c % DH;
    qs[rr * LD + d] = q0 + rr < S ? q[bh * head + (q0 + rr) * DH + d] * scale
                                  : 0.f;
  }
  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  float m = M_INIT, l = 0.f;

  for (int j = j0; j < n_kt; ++j) {
    const int kv0 = j * BK;
    __syncthreads();   // every thread is done with the previous tile
    for (int c = tid; c < BK * DH; c += THREADS) {
      const int rr = c / DH, d = c % DH;
      const bool ok = kv0 + rr < S;
      const size_t at = static_cast<size_t>(kv0 + rr) * DH + d;
      ks[rr * LD + d] = ok ? kg[at] : 0.f;
      vs[rr * DH + d] = ok ? vg[at] : 0.f;
    }
    __syncthreads();

    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    for (int d = 0; d < DH; ++d) {
      const float qd = qs[r * LD + d];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] += qd * ks[(2 * i + half) * LD + d];
    }
    const bool masked = kv0 + BK > S || (CAUSAL && kv0 + BK - 1 > q0) ||
                        (window > 0 && kv0 <= q0 + BQ - 1 - window);
    float mx = M_INIT;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int col = kv0 + 2 * i + half;
      if (masked && (col >= S || (CAUSAL && col > qrow) ||
                     (window > 0 && col <= qrow - window)))
        s[i] = -INFINITY;
      mx = fmaxf(mx, s[i]);
    }
    const float m_new = fmaxf(m, fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1)));
    const float alpha = expf(m - m_new);
    m = m_new;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const float p = expf(s[i] - m_new);
      ps[r * LP + 2 * i + half] = p;
      sum += p;
    }
    l = l * alpha + sum + __shfl_xor_sync(0xffffffffu, sum, 1);
    __syncwarp();   // the row's other half of P is written
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] *= alpha;
    for (int c = 0; c < BK; ++c) {
      const float p = ps[r * LP + c];
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) acc[i] += p * vs[c * DH + 2 * i + half];
    }
  }
  if (qrow < S) {
    float* orow = o + bh * head + static_cast<size_t>(qrow) * DH;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) orow[2 * i + half] = acc[i] / den;
    if (lse != nullptr && half == 0)   // on request: the row's log-sum-exp
      lse[static_cast<size_t>(bh) * S + qrow] = m + logf(den);
  }
}

// -- the Hopper path: bf16, dh 64 or 128 ------------------------------------

namespace wg {

constexpr int BQ = 128;            // query rows per tile: 64 per consumer
constexpr int BK = 128;            // key/value rows per pipeline stage
constexpr int STAGES = 2;          // K/V ring depth
constexpr int THREADS = 384;       // producer warpgroup + 2 consumers
constexpr int CONSUMER_THREADS = 256;
constexpr int PRODUCER_REGS = 40;  // setmaxnreg: 128*40 + 256*232 = 64,512
constexpr int CONSUMER_REGS = 232; // = 384 threads * 168 at launch
constexpr int TURN = 1;            // named barriers 1, 2: the issue turns

// Shared memory, every tile on a 1,024-byte boundary (the swizzle's
// period): two Q buffers [DH/64][BQ][64] (the next tile's Q loads while
// this tile runs), then STAGES K tiles and STAGES V tiles of
// [DH/64][BK][64], then the barriers.
template <int DH>
struct Layout {
  static constexpr int CH = DH / 64;                  // 64-column chunks
  static constexpr int Q_CHUNK = BQ * 128;            // bytes
  static constexpr int KV_CHUNK = BK * 128;
  static constexpr int Q_BYTES = CH * Q_CHUNK;
  static constexpr int KV_BYTES = CH * KV_CHUNK;      // one K or V tile
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // full_k, full_v, empty_k, empty_v [STAGES] each, q_full[2], q_empty[2]
  static constexpr int BYTES = BAR_OFF + 8 * (4 * STAGES + 4) + 1024;
};

// The tile schedule shared by the producer and the consumers: tile t is
// (q tile, b*h) with the q tiles that read the most K/V tiles first; it
// reads key tiles j0 .. n_kt - 1 (j0 > 0 only under a window).
struct Tile {
  int qt, b, h, j0, n_kt;
};

__device__ __forceinline__ Tile tile_at(int t, int BH, int H, int n_qt,
                                        int n_all, bool causal, int window) {
  Tile r;
  r.qt = n_qt - 1 - t / BH;
  const int bh = t % BH;
  r.b = bh / H;
  r.h = bh % H;
  r.j0 = window > 0 ? max(0, r.qt * BQ - window + 1) / BK : 0;
  r.n_kt = causal ? min(n_all, (r.qt * BQ + BQ - 1) / BK + 1) : n_all;
  return r;
}

// reg_fence on the operands of O += P V: the accumulator and P's fragments
template <int CH, int KS>
__device__ __forceinline__ void fence_pv(float (&oacc)[CH][32],
                                         uint32_t (&pf)[KS][4]) {
#pragma unroll
  for (int c = 0; c < CH; ++c) sm90::reg_fence(oacc[c]);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) sm90::reg_fence(pf[kk]);
}

template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   bf16* __restrict__ o, long long o_sb, long long o_sh,
                   long long o_ss, float* __restrict__ lse, int H, int rep,
                   int S, int BH, int window, float scale_log2) {
  using L = Layout<DH>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full_k = bars;
  uint64_t* full_v = bars + STAGES;
  uint64_t* empty_k = bars + 2 * STAGES;
  uint64_t* empty_v = bars + 3 * STAGES;
  uint64_t* q_full = bars + 4 * STAGES;
  uint64_t* q_empty = q_full + 2;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full_k[s], 1);
      sm90::mbar_init(&full_v[s], 1);
      sm90::mbar_init(&empty_k[s], CONSUMER_THREADS);
      sm90::mbar_init(&empty_v[s], CONSUMER_THREADS);
    }
    for (int b = 0; b < 2; ++b) {
      sm90::mbar_init(&q_full[b], 1);
      sm90::mbar_init(&q_empty[b], CONSUMER_THREADS);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int n_qt = (S + BQ - 1) / BQ;
  const int n_all = (S + BK - 1) / BK;
  const int n_tiles = BH * n_qt;

  if (tid < 128) {   // producer warpgroup: one thread issues every load
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 0) {
      sm90::tma_prefetch_desc(&q_map);
      sm90::tma_prefetch_desc(&k_map);
      sm90::tma_prefetch_desc(&v_map);
      int stage = 0;
      uint32_t phase = 0, iter = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++iter) {
        const Tile tl = tile_at(t, BH, H, n_qt, n_all, CAUSAL, window);
        const int kvh = tl.h / rep;
        // Q buffer iter % 2, free once tile iter - 2 has used it
        const int qb = iter & 1;
        sm90::mbar_wait(&q_empty[qb], ((iter >> 1) & 1) ^ 1);
        sm90::mbar_expect_tx(&q_full[qb], L::Q_BYTES);
#pragma unroll
        for (int c = 0; c < L::CH; ++c)
          sm90::tma_load_4d(smem + qb * L::Q_BYTES + c * L::Q_CHUNK, &q_map,
                            &q_full[qb], c * 64, tl.qt * BQ, tl.h, tl.b);
        for (int j = tl.j0; j < tl.n_kt; ++j) {
          unsigned char* ks = smem + L::K_OFF + stage * L::KV_BYTES;
          unsigned char* vs = smem + L::V_OFF + stage * L::KV_BYTES;
          sm90::mbar_wait(&empty_k[stage], phase ^ 1);
          sm90::mbar_expect_tx(&full_k[stage], L::KV_BYTES);
#pragma unroll
          for (int c = 0; c < L::CH; ++c)
            sm90::tma_load_4d(ks + c * L::KV_CHUNK, &k_map, &full_k[stage],
                              c * 64, j * BK, kvh, tl.b);
          sm90::mbar_wait(&empty_v[stage], phase ^ 1);
          sm90::mbar_expect_tx(&full_v[stage], L::KV_BYTES);
#pragma unroll
          for (int c = 0; c < L::CH; ++c)
            sm90::tma_load_4d(vs + c * L::KV_CHUNK, &v_map, &full_v[stage],
                              c * 64, j * BK, kvh, tl.b);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumer warpgroups: cw owns query rows 64cw .. 64cw+63 of the tile.
  // S_j = Q K_j^T and O += P_{j-1} V_{j-1} are issued together and share
  // the tensor cores; the softmax of S_j follows once both have landed,
  // while the other consumer warpgroup's products can run. (Overlapping a
  // warpgroup's own softmax with its P V product, as FlashAttention-3 does,
  // made ptxas serialize every wgmma here and measured slower.)
  sm90::setmaxnreg_inc<CONSUMER_REGS>();
  const int ct = tid - 128, cw = ct >> 7;
  const int warp = (ct >> 5) & 3, lane = ct & 31;
  const int g = lane >> 2, t4 = lane & 3;
  int stage = 0;
  uint32_t phase = 0, iter = 0;
  // The two consumers take turns to issue their products (named barriers
  // 1 and 2), so one's softmax overlaps the other's products; consumer 0
  // goes first.
  if (cw == 1) sm90::bar_arrive(TURN, 2 * 128);

  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++iter) {
    const Tile tl = tile_at(t, BH, H, n_qt, n_all, CAUSAL, window);
    const int row0 = tl.qt * BQ + cw * 64;   // this warpgroup's first row
    const int row[2] = {row0 + warp * 16 + g, row0 + warp * 16 + g + 8};
    const int qb = iter & 1;   // this tile's Q buffer; its rows of chunk 0:
    const unsigned char* qs = smem + qb * L::Q_BYTES + cw * 64 * 128;

    float oacc[L::CH][32];
#pragma unroll
    for (int c = 0; c < L::CH; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) oacc[c][e] = 0.f;
    float m_r[2] = {M_INIT, M_INIT}, l_r[2] = {0.f, 0.f};
    // Both start defined: an undefined operand register, materialised by
    // the compiler inside a wgmma pipeline stage, makes ptxas serialize
    // every wgmma of the kernel.
    float s[BK / 2] = {};          // S_j: s[4n + e] is row g + 8 (e / 2),
                                   // key 8n + 2 t4 + (e % 2) of the warp
    uint32_t pf[BK / 16][4] = {};  // P_{j-1} in bf16: O += P V's A fragments
    int pv_stage = 0;         // the stage whose V P_{j-1} multiplies
    uint32_t pv_phase = 0;

    sm90::mbar_wait(&q_full[qb], (iter >> 1) & 1);
    for (int j = tl.j0; j < tl.n_kt; ++j) {
      const unsigned char* ks = smem + L::K_OFF + stage * L::KV_BYTES;
      sm90::mbar_wait(&full_k[stage], phase);
      sm90::bar_sync(TURN + cw, 2 * 128);   // this consumer's turn
      sm90::reg_fence(s);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const int c = kk / 4, off = (kk % 4) * 32;   // chunk, bytes into a row
        sm90::wgmma_m64n128k16_ss(
            s, sm90::desc_sw128(qs + c * L::Q_CHUNK + off),
            sm90::desc_sw128(ks + c * L::KV_CHUNK + off), kk > 0);
      }
      sm90::wgmma_commit();
      if (j > tl.j0) {   // O += P_{j-1} V_{j-1}, beside S_j on the tensor cores
        const unsigned char* vs = smem + L::V_OFF + pv_stage * L::KV_BYTES;
        sm90::mbar_wait(&full_v[pv_stage], pv_phase);
        fence_pv(oacc, pf);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int c = 0; c < L::CH; ++c)
            sm90::wgmma_m64n64k16_rs_tb(
                oacc[c], pf[kk],
                sm90::desc_sw128(vs + c * L::KV_CHUNK + kk * 16 * 128));
        sm90::wgmma_commit();
      }
      sm90::bar_arrive(TURN + (cw ^ 1), 2 * 128);   // the other's turn
      sm90::wgmma_wait<0>();
      sm90::reg_fence(s);
      fence_pv(oacc, pf);
      sm90::mbar_arrive(&empty_k[stage]);   // K_j is free for K_{j+STAGES}
      if (j == tl.n_kt - 1) sm90::mbar_arrive(&q_empty[qb]);   // Q is done
      if (j > tl.j0) sm90::mbar_arrive(&empty_v[pv_stage]);   // and V_{j-1}

      // online softmax in base 2 over rows g and g + 8 of each warp: the
      // running max m_r is kept on the raw logits, p = 2^(s*c - m*c) with
      // c = log2(e)/sqrt(dh), one FFMA and one ex2 per logit
      const int kv0 = j * BK;
      if (kv0 + BK > S || (CAUSAL && kv0 + BK - 1 > row0)) {
        // keys at or past lim[i] are masked for row i: this lane's key
        // 8n + 2 t4 + (e % 2) of the tile against lim[i] - kv0 - 2 t4
        int lim[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          lim[i] = (CAUSAL ? min(S, row[i] + 1) : S) - kv0 - 2 * t4;
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (n * 8 + (e & 1) >= lim[e >> 1]) s[4 * n + e] = -INFINITY;
      }
      // under a window, keys below lo[i] = row i - window + 1 too (a
      // separate pass, skipped by tiles that lie wholly inside every row's
      // window)
      if (window > 0 && kv0 <= row0 + 63 - window) {
        int lo[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) lo[i] = row[i] - window + 1 - kv0 - 2 * t4;
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (n * 8 + (e & 1) < lo[e >> 1]) s[4 * n + e] = -INFINITY;
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // max and sum as four interleaved partials: short dependency chains
        float mx[4] = {M_INIT, M_INIT, M_INIT, M_INIT};
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
          mx[n & 3] = fmaxf(mx[n & 3], fmaxf(s[4 * n + 2 * i],
                                             s[4 * n + 2 * i + 1]));
        const float m_new = fmaxf(
            m_r[i], quad_max(fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]))));
        const float mc = m_new * scale_log2;
        alpha[i] = m_r[i] == m_new ? 1.f : ex2(fmaf(m_r[i], scale_log2, -mc));
        m_r[i] = m_new;
        float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
          for (int e = 2 * i; e < 2 * i + 2; ++e) {
            s[4 * n + e] = ex2(fmaf(s[4 * n + e], scale_log2, -mc));
            sum[n & 3] += s[4 * n + e];
          }
        // this lane's columns only
        l_r[i] = l_r[i] * alpha[i] + ((sum[0] + sum[1]) + (sum[2] + sum[3]));
      }
#pragma unroll
      for (int c = 0; c < L::CH; ++c)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          oacc[c][4 * n + 0] *= alpha[0];
          oacc[c][4 * n + 1] *= alpha[0];
          oacc[c][4 * n + 2] *= alpha[1];
          oacc[c][4 * n + 3] *= alpha[1];
        }
      // P_j rounded to bf16 in registers: the A fragments of the k16 steps
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pf[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pf[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pf[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pf[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
      pv_stage = stage;
      pv_phase = phase;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    {   // the last O += P V
      const unsigned char* vs = smem + L::V_OFF + pv_stage * L::KV_BYTES;
      sm90::mbar_wait(&full_v[pv_stage], pv_phase);
      sm90::bar_sync(TURN + cw, 2 * 128);
      fence_pv(oacc, pf);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int c = 0; c < L::CH; ++c)
          sm90::wgmma_m64n64k16_rs_tb(
              oacc[c], pf[kk],
              sm90::desc_sw128(vs + c * L::KV_CHUNK + kk * 16 * 128));
      sm90::wgmma_commit();
      sm90::bar_arrive(TURN + (cw ^ 1), 2 * 128);
      fence_pv(oacc, pf);
      sm90::wgmma_wait<0>();
      fence_pv(oacc, pf);
      sm90::mbar_arrive(&empty_v[pv_stage]);
    }

    // epilogue: divide by the row sums, store the rows below S. A quad's
    // four lanes hold 4-byte pieces of each 8-column block; two rounds of
    // exchanges within the quad leave lane t4 with blocks t4 and t4 + 4
    // whole, so each lane stores 16 bytes at a time.
    bf16* og = o + tl.b * o_sb + tl.h * o_sh;
    const bool odd = t4 & 1, hi = t4 >> 1;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float l = fmaxf(quad_sum(l_r[i]), 1e-30f);
      const float inv = 1.f / l;
      // on request, the row's natural log-sum-exp of its scaled logits: m_r
      // is the raw logits' max, the exponents base 2 at scale_log2
      if (lse != nullptr && t4 == 0 && row[i] < S)
        lse[(static_cast<size_t>(tl.b) * H + tl.h) * S + row[i]] =
            (m_r[i] * scale_log2 + log2f(l)) * LN2;
      bf16* orow = og + row[i] * o_ss;
#pragma unroll
      for (int c = 0; c < L::CH; ++c) {
        uint32_t v[8];
#pragma unroll
        for (int n = 0; n < 8; ++n)
          v[n] = pack_bf16(oacc[c][4 * n + 2 * i] * inv,
                           oacc[c][4 * n + 2 * i + 1] * inv);
        // round 1: lane t4 gets the 8-byte half t4 / 2 of block 2m + t4 % 2
        uint32_t w0[4], w1[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const uint32_t got =
              __shfl_xor_sync(0xffffffffu, odd ? v[2 * m] : v[2 * m + 1], 1);
          w0[m] = odd ? got : v[2 * m];
          w1[m] = odd ? v[2 * m + 1] : got;
        }
        // round 2: and then the whole of block 4p + t4
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          // keep m = 2p + hi, send m = 2p + !hi (selects: no indexed reads)
          const uint32_t k0 = hi ? w0[2 * p + 1] : w0[2 * p];
          const uint32_t k1 = hi ? w1[2 * p + 1] : w1[2 * p];
          const uint32_t g0 =
              __shfl_xor_sync(0xffffffffu, hi ? w0[2 * p] : w0[2 * p + 1], 2);
          const uint32_t g1 =
              __shfl_xor_sync(0xffffffffu, hi ? w1[2 * p] : w1[2 * p + 1], 2);
          const uint4 out = hi ? make_uint4(g0, g1, k0, k1)
                               : make_uint4(k0, k1, g0, g1);
          if (row[i] < S)
            *reinterpret_cast<uint4*>(orow + c * 64 + (4 * p + t4) * 8) = out;
        }
      }
    }
  }
}

}  // namespace wg

// A [B, heads, S, dh] bf16 tensor with element strides (sb, sh, ss, 1) as a
// 4-d map (dh, S, heads, B) read in boxes of 64 columns x `rows` rows, in
// the 128-byte swizzle; rows past S read as zeros. The last few maps are
// kept per thread: a caller whose buffers come back at the same addresses
// and shapes (a model's layers, a benchmark's loop) skips the encoding.
bool encode_heads(CUtensorMap* map, const void* base, int dh, int S,
                  int heads, int B, long long sb, long long sh, long long ss,
                  int rows) {
  struct Entry {
    const void* base;
    long long key[8];
    CUtensorMap map;
  };
  constexpr int CACHED = 8;
  thread_local Entry cache[CACHED] = {};
  thread_local int next = 0;
  const long long key[8] = {dh, S, heads, B, sb, sh, ss, rows};
  for (const Entry& e : cache)
    if (e.base == base && e.base != nullptr &&
        memcmp(e.key, key, sizeof(key)) == 0) {
      *map = e.map;
      return true;
    }
  const sm90::EncodeTiled enc = sm90::encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  if (enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
          dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  Entry& e = cache[next];
  next = (next + 1) % CACHED;
  e.base = base;
  memcpy(e.key, key, sizeof(key));
  e.map = *map;
  return true;
}

template <int DH, bool CAUSAL>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         float* lse, const long long* st, int B, int H,
                         int Hkv, int S, int scale_dh, int window, int n_sm,
                         cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!encode_heads(&qm, q, DH, S, H, B, st[0], st[1], st[2], wg::BQ) ||
      !encode_heads(&km, k, DH, S, Hkv, B, st[3], st[4], st[5], wg::BK) ||
      !encode_heads(&vm, v, DH, S, Hkv, B, st[6], st[7], st[8], wg::BK))
    return cudaErrorInvalidValue;
  const int smem = wg::Layout<DH>::BYTES;
  auto kern = wg::flash_wgmma_kernel<DH, CAUSAL>;
  static const cudaError_t attr = cudaFuncSetAttribute(   // once per process
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const int n_tiles = B * H * ((S + wg::BQ - 1) / wg::BQ);
  const int grid = min(n_sm, n_tiles);   // persistent: one block per SM
  const double scale = 1.0 / sqrt(static_cast<double>(scale_dh));
  kern<<<grid, wg::THREADS, smem, stream>>>(
      qm, km, vm, static_cast<bf16*>(o), st[9], st[10], st[11], lse, H,
      H / Hkv, S, B * H, window,
      static_cast<float>(scale * 1.4426950408889634));
  return cudaGetLastError();
}

template <typename T, int DH, bool CAUSAL>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int rep, int S, int scale_dh,
                   int window, cudaStream_t stream) {
  const double scale = 1.0 / sqrt(static_cast<double>(scale_dh));
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  if constexpr (sizeof(T) == 2) {
    const size_t smem = sizeof(bf16) * (BQ + 2 * BK) * (DH + 8);
    auto kern = flash_bf16_kernel<DH, CAUSAL>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kern<<<grid, THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, H, rep, S,
        window, static_cast<float>(scale * 1.4426950408889634));
  } else {
    const size_t smem =
        sizeof(float) * ((BQ + BK) * (DH + 1) + BK * DH + BQ * (BK + 1));
    auto kern = flash_f32_kernel<DH, CAUSAL>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kern<<<grid, THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, H, rep, S,
        window, static_cast<float>(scale));
  }
  return cudaGetLastError();
}

template <typename T, bool CAUSAL>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int H, int rep, int S, int dh,
                        int sd, int w, cudaStream_t st) {
  switch (dh) {
    case 16:
      return launch<T, 16, CAUSAL>(q, k, v, o, lse, B, H, rep, S, sd, w,
                                   st);
    case 32:
      return launch<T, 32, CAUSAL>(q, k, v, o, lse, B, H, rep, S, sd, w,
                                   st);
    case 256:
      return launch<T, 256, CAUSAL>(q, k, v, o, lse, B, H, rep, S, sd, w,
                                    st);
    default: break;
  }
  if constexpr (sizeof(T) == 4) {   // bf16 at 64 and 128 runs on wgmma
    switch (dh) {
      case 64:
        return launch<T, 64, CAUSAL>(q, k, v, o, lse, B, H, rep, S, sd, w,
                                   st);
      case 128:
        return launch<T, 128, CAUSAL>(q, k, v, o, lse, B, H, rep, S, sd, w,
                                    st);
      default: break;
    }
  }
  return cudaErrorInvalidValue;
}

template <typename T>
int run(const void* q, const void* k, const void* v, void* o, void* lse,
        int B, int H, int Hkv, int S, int dh, int causal, int scale_dh,
        int window, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || S < 1 || H % Hkv || scale_dh < 1 ||
      scale_dh > dh || window < 0 ||
      static_cast<long long>(B) * H > 0x7fffffffLL ||
      (S + BQ - 1) / BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rep = H / Hkv;
  return static_cast<int>(
      causal ? dispatch_dh<T, true>(q, k, v, o, static_cast<float*>(lse), B,
                                    H, rep, S, dh, scale_dh, window, st)
             : dispatch_dh<T, false>(q, k, v, o, static_cast<float*>(lse), B,
                                     H, rep, S, dh, scale_dh, window, st));
}

// The SM count of the current device if it is an sm_90 card (the library
// holds sm_90a code only), else 0; the answer is kept per device.
int sm90_count() {
  static int known[64];   // 0 not asked yet, -1 another card, else SMs
  int dev = 0, major = 0, minor = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (known[dev] == 0)
    known[dev] =
        cudaDeviceGetAttribute(&major, cudaDevAttrComputeCapabilityMajor,
                               dev) == cudaSuccess &&
                cudaDeviceGetAttribute(&minor,
                                       cudaDevAttrComputeCapabilityMinor,
                                       dev) == cudaSuccess &&
                cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev) == cudaSuccess &&
                major == 9 && minor == 0 && sms > 0
            ? sms
            : -1;
  return known[dev] > 0 ? known[dev] : 0;
}

template <bool CAUSAL>
cudaError_t dispatch_wgmma(const void* q, const void* k, const void* v,
                           void* o, float* lse, const long long* st, int B,
                           int H, int Hkv, int S, int dh, int scale_dh,
                           int window, int n_sm, cudaStream_t stream) {
  switch (dh) {
    case 64:
      return launch_wgmma<64, CAUSAL>(q, k, v, o, lse, st, B, H, Hkv, S,
                                      scale_dh, window, n_sm, stream);
    case 128:
      return launch_wgmma<128, CAUSAL>(q, k, v, o, lse, st, B, H, Hkv, S,
                                       scale_dh, window, n_sm, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Dynamic shared memory per block the launcher requests on the Hopper path at
// head dim d (64 or 128; k unused), 0 for another d.
extern "C" int flash_attention_smem_bytes(int d, int) {
  return d == 64    ? wg::Layout<64>::BYTES
         : d == 128 ? wg::Layout<128>::BYTES
                    : 0;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q/o:[B,H,S,dh], k/v:[B,Hkv,S,dh], contiguous, 16-byte aligned; H % Hkv
// == 0; bf16 at dh in {16, 32, 256}, fp32 at dh in {16, 32, 64, 128, 256};
// the softmax scale is 1/sqrt(scale_dh), 1 <= scale_dh <= dh (the head dim
// before the wrapper's zero padding); window >= 0 (0: none). lse, where
// not null, receives each row's natural log-sum-exp of its scaled logits,
// fp32 [B,H,S] (what the backward kernels recompute P from). Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, void* lse, int B,
                                    int H, int Hkv, int S, int dh, int causal,
                                    int scale_dh, int window, void* stream) {
  return run<bf16>(q, k, v, o, lse, B, H, Hkv, S, dh, causal, scale_dh,
                   window, stream);
}

extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int B,
                                   int H, int Hkv, int S, int dh, int causal,
                                   int scale_dh, int window, void* stream) {
  return run<float>(q, k, v, o, lse, B, H, Hkv, S, dh, causal, scale_dh,
                    window, stream);
}

// The Hopper path, bf16 at dh in {64, 128}, on an sm_90 card only. One
// array of 29 int64 carries the call, so the host spends little on it:
// a[0..4) the q, k, v, o pointers (q/o:[B,H,S,dh], k/v:[B,Hkv,S,dh]);
// a[4..10) B, H, Hkv, S, dh, causal; a[10..26) the element strides
// (b, h, s, d) of q, k, v and o: unit stride in dh, 16-byte multiples
// elsewhere, every base 16-byte aligned, H % Hkv == 0; a[26] the head dim
// whose 1/sqrt scales the logits (1 <= a[26] <= dh); a[27] the window
// (>= 0, 0: none); a[28] the fp32 [B,H,S] log-sum-exp output, or 0 for
// none; or cudaErrorInvalidValue. Launches a persistent grid
// of at most one block per SM. Returns cudaGetLastError() (0 on success).
extern "C" int flash_attention_wgmma(const long long* a, void* stream) {
  const void* base[4] = {reinterpret_cast<const void*>(a[0]),
                         reinterpret_cast<const void*>(a[1]),
                         reinterpret_cast<const void*>(a[2]),
                         reinterpret_cast<const void*>(a[3])};
  const long long B = a[4], H = a[5], Hkv = a[6], S = a[7], dh = a[8];
  const long long causal = a[9], scale_dh = a[26], window = a[27];
  float* lse = reinterpret_cast<float*>(a[28]);
  if (B < 1 || H < 1 || Hkv < 1 || S < 1 || H % Hkv || S > 0x7fffffffLL ||
      scale_dh < 1 || scale_dh > dh || window < 0 || window > 0x7fffffffLL ||
      B * H * ((S + wg::BQ - 1) / wg::BQ) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  // the maps take (b, h, s), a size-1 dim's stride (never read) set to 8
  const long long heads[4] = {H, Hkv, Hkv, H};
  long long st[12];
  for (int t = 0; t < 4; ++t) {
    const long long* in = a + 10 + 4 * t;
    const long long size[3] = {B, heads[t], S};
    if (in[3] != 1 || reinterpret_cast<uintptr_t>(base[t]) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
    for (int d = 0; d < 3; ++d) {
      st[3 * t + d] = size[d] > 1 ? in[d] : 8;
      if (st[3 * t + d] % 8 || st[3 * t + d] < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int n_sm = sm90_count();
  if (!n_sm) return static_cast<int>(cudaErrorInvalidDeviceFunction);
  const cudaStream_t sm = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(B), h = static_cast<int>(H),
            hkv = static_cast<int>(Hkv), s = static_cast<int>(S),
            d = static_cast<int>(dh);
  return static_cast<int>(
      causal ? dispatch_wgmma<true>(base[0], base[1], base[2],
                                    const_cast<void*>(base[3]), lse, st, b, h,
                                    hkv, s, d, static_cast<int>(scale_dh),
                                    static_cast<int>(window), n_sm, sm)
             : dispatch_wgmma<false>(base[0], base[1], base[2],
                                     const_cast<void*>(base[3]), lse, st, b,
                                     h, hkv, s, d, static_cast<int>(scale_dh),
                                     static_cast<int>(window), n_sm, sm));
}
