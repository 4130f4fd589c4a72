// The gradient of attention: given q:[B,H,S,dh], k/v:[B,Hkv,S,dh], the
// forward's output o and per-row log-sum-exp lse (fp32 [B,H,S], written by
// flash_attention.cu on request) and the output's gradient dO, computes
// dq:[B,H,S,dh] and dk, dv:[B,Hkv,S,dh] for causal or not, any GQA group
// (query head h reads KV head h / (H / Hkv)), the runtime sliding window
// (window > 0: key j visible to query i iff j > i - window) and the
// softmax scale 1/sqrt(scale_dh), in bf16 or fp32. With P = exp(q k^T *
// scale - lse) over the visible pairs and D = rowsum(dO * o):
//   dv = P^T dO,  dS = P * (dO v^T - D),  dq = dS k * scale,
//   dk = dS^T q * scale,
// dk and dv summed over the query heads of each KV head. The backward of
// every attention layer of a training step.
//
// Replaces: nothing on the TPU side. The JAX package has no backward
// kernel: its Pallas flash_attention_pallas
// (src/repro/kernels/flash_attention.py) has no custom_vjp, and training
// differentiates the einsums of L.multihead_attention
// (src/repro/models/transformer.py, jax.value_and_grad in
// src/repro/train/train_step.py), which write the [S, S] logits,
// probabilities and their gradients to device memory.
//
// What bounds it on an H100: at the training shape (B 2, H 24, Hkv 8,
// S 4,096, dh 128, causal, bf16) it must read q, k, v, o, dO, lse and
// write dq, dk, dv once, about 269 MB, 80 us at 3.35 TB/s, and do 2.5x
// the forward's operations, 2.5 * 4 * B * H * dh over the 8.4 M visible
// pairs a head, 515 GFLOP, 0.52 ms at the 989 TFLOP/s bf16 tensor peak:
// operations, by a factor of six. This design does 7/5 of them (S and
// dP are recomputed in both of its passes) on mma.sync, which reaches
// a fraction of the wgmma rate; a wgmma and TMA design is later work.
//
// The design (simple and deterministic: no atomics, every sum in a fixed
// order):
//  1. dot: D = rowsum(dO * o) in fp32, one warp a row.
//  2. dkdv: one block per (b, KV head, 64-key tile) keeps its K and V
//     tiles in shared memory and loops over the q tiles of every query
//     head of its group that see any of its keys (causal: from the key
//     tile on; a window: up to the last row whose window reaches the
//     tile), recomputing S^T = K Q^T and dP^T = V dO^T, P^T from lse and
//     dS^T, and accumulating dV += P^T dO and dK += dS^T Q in fp32
//     registers across the whole group: the group's sum needs no atomics.
//  3. dq: one block per (b, head, 64-row q tile) keeps Q and dO in shared
//     memory and loops over the key tiles its rows see (the forward's
//     bounds), recomputing S, dP, P and dS, and accumulating dQ += dS K.
// bf16 (dh 16, 32, 64, 128, 256): 4 warps own 16 rows each of the block's
// tile and run mma.sync.m16n8k16 with fp32 accumulators from ldmatrix
// loads; P and dS are rounded to bf16 in registers as the next product's
// A fragment. At dh 256, 8 warps: two per row group, each owning 128 of
// the output columns (and computing the group's S and dP twice), so the
// accumulators fit in registers. fp32 (the same dims): scalar FMAs, 32-row
// tiles, four threads a row, each owning a quarter of the columns.
// Rows and keys past S read as zeros, are masked and are not stored.
// Head dims off these arrive zero-padded by the wrapper with the true dh
// as scale_dh: zero columns add nothing to dq, dk or dv's true columns.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "mma_sync.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// D[row] = sum_d dO[row, d] * o[row, d] over rows of dh elements, one warp
// a row, fp32
template <typename T>
__global__ void __launch_bounds__(256)
dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
           float* __restrict__ dsum, long long rows, int dh) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 +
                        (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* a = o + row * dh;
  const T* b = dout + row * dh;
  float s = 0.f;
  for (int d = lane; d < dh; d += 32) s += to_f32(a[d]) * to_f32(b[d]);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) dsum[row] = s;
}

// Is key j visible to query i (both below S)?
template <bool CAUSAL>
__device__ __forceinline__ bool visible(int i, int j, int S, int window) {
  return i < S && j < S && (!CAUSAL || j <= i) &&
         (window <= 0 || j > i - window);
}

// -- bf16 on mma.sync --------------------------------------------------------

// The warps of a bf16 block: 4 row groups of 16 rows x NS column slices of
// DW output columns.
template <int DH>
struct Warps {
  static constexpr int DW = DH < 128 ? DH : 128;
  static constexpr int NS = DH / DW;
  static constexpr int THREADS = 128 * NS;
  static constexpr int LD = DH + 8;   // smem row pitch: ldmatrix conflict-free
};

// Rows row0 .. row0 + ROWS - 1 of a [S, DH] bf16 head into shared memory
// with pitch DH + 8 by cp.async; rows past S are zero-filled.
template <int DH, int ROWS, int NT>
__device__ __forceinline__ void load_rows(bf16* sm, const bf16* g, int row0,
                                          int S, int tid) {
  constexpr int CPR = DH / 8;   // 16-byte chunks per row
#pragma unroll 4
  for (int c = tid; c < ROWS * CPR; c += NT) {
    const int r = c / CPR, col = (c % CPR) * 8;
    const bool ok = row0 + r < S;
    cp_async16(sm + r * (DH + 8) + col,
               g + static_cast<size_t>(ok ? row0 + r : 0) * DH + col, ok);
  }
}

// A fragment of rows r0 .. r0+15, cols c0 .. c0+15 of a row-major tile
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* sm,
                                       int ld, int r0, int c0, int lane) {
  ldsm_x4(a, sm + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + c0 +
                 (lane >> 4) * 8);
}

// B fragments of two n-blocks n0 .. n0+15 (b[0..1], then b[2..3]) over k
// c0 .. c0+15, from a tile stored [n][k] row-major
__device__ __forceinline__ void frag_b_nk(uint32_t (&b)[4], const bf16* sm,
                                          int ld, int n0, int c0, int lane) {
  ldsm_x4(b, sm + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + c0 +
                 ((lane >> 3) & 1) * 8);
}

// B fragments of two n-blocks n0 .. n0+15 over k rows k0 .. k0+15, from a
// tile stored [k][n] row-major
__device__ __forceinline__ void frag_b_kn(uint32_t (&b)[4], const bf16* sm,
                                          int ld, int k0, int n0, int lane) {
  ldsm_x4_t(b, sm + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
                   (lane >> 4) * 8);
}

// Two accumulators side by side rounded to bf16: an A fragment over k16
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&lo)[4],
                                     const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// dK and dV of one 64-key tile of one KV head, over every query head of
// its group. Warp w owns keys 16 (w % 4) .. +15 and output columns
// DW (w / 4) .. +DW-1; the q tiles are 32 rows.
template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(Warps<DH>::THREADS)
dkdv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ dsum, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, int H, int rep, int S, int window,
                 float scale, float scale_log2) {
  using W = Warps<DH>;
  constexpr int LD = W::LD, DW = W::DW, NT = W::THREADS;
  constexpr int KT = 64, QT = 32;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);   // [KT][LD]
  bf16* vs = ks + KT * LD;                     // [KT][LD]
  bf16* qs = vs + KT * LD;                     // [QT][LD]
  bf16* dos = qs + QT * LD;                    // [QT][LD]
  float* lse2 = reinterpret_cast<float*>(dos + QT * LD);   // [QT], base 2
  float* dd = lse2 + QT;                                    // [QT]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kw = warp & 3, col0 = (warp >> 2) * DW;
  const int g = lane >> 2, t = lane & 3;
  const int bkv = blockIdx.x, hkv = H / rep;
  const int b = bkv / hkv, kvh = bkv % hkv;
  const int k0 = blockIdx.y * KT;
  const size_t head = static_cast<size_t>(S) * DH;
  load_rows<DH, KT, NT>(ks, k + bkv * head, k0, S, tid);
  load_rows<DH, KT, NT>(vs, v + bkv * head, k0, S, tid);
  cp_async_commit();

  float dka[DW / 8][4], dva[DW / 8][4];
#pragma unroll
  for (int n = 0; n < DW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  const int krow[2] = {k0 + kw * 16 + g, k0 + kw * 16 + g + 8};
  const int n_qt = (S + QT - 1) / QT;
  // the q tiles that see a key of this tile
  const int i_lo = CAUSAL ? k0 / QT : 0;
  const int i_hi =
      window > 0 ? min(n_qt, (k0 + KT - 2 + window) / QT + 1) : n_qt;

  for (int hh = 0; hh < rep; ++hh) {
    const size_t bh = static_cast<size_t>(b) * H + kvh * rep + hh;
    const bf16* qg = q + bh * head;
    const bf16* dog = dout + bh * head;
    for (int it = i_lo; it < i_hi; ++it) {
      const int q0 = it * QT;
      __syncthreads();   // every warp is done with the previous q tile
      load_rows<DH, QT, NT>(qs, qg, q0, S, tid);
      load_rows<DH, QT, NT>(dos, dog, q0, S, tid);
      cp_async_commit();
      if (tid < QT) {
        const int r = q0 + tid;
        lse2[tid] = r < S ? lse[bh * S + r] * LOG2E : 0.f;
        dd[tid] = r < S ? dsum[bh * S + r] : 0.f;
      }
      cp_async_wait_0();
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x QT queries
      float s[QT / 8][4], dp[QT / 8][4];
#pragma unroll
      for (int n = 0; n < QT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t ka[4], va[4];
        frag_a(ka, ks, LD, kw * 16, kk * 16, lane);
        frag_a(va, vs, LD, kw * 16, kk * 16, lane);
#pragma unroll
        for (int n = 0; n < QT / 8; n += 2) {
          uint32_t qb[4], ob[4];
          frag_b_nk(qb, qs, LD, n * 8, kk * 16, lane);
          frag_b_nk(ob, dos, LD, n * 8, kk * 16, lane);
          mma_bf16(s[n], ka, qb[0], qb[1]);
          mma_bf16(s[n + 1], ka, qb[2], qb[3]);
          mma_bf16(dp[n], va, ob[0], ob[1]);
          mma_bf16(dp[n + 1], va, ob[2], ob[3]);
        }
      }
      // P^T = exp(S^T * scale - lse) over the visible pairs, dS^T = P^T *
      // (dP^T - D); a tile with no invisible pair skips the test
      const bool edge = q0 + QT > S || k0 + KT > S ||
                        (CAUSAL && q0 < k0 + KT - 1) ||
                        (window > 0 && q0 + QT - 1 >= k0 + window);
#pragma unroll
      for (int n = 0; n < QT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + 2 * t + (e & 1);   // the query in the tile
          const bool ok =
              !edge || visible<CAUSAL>(q0 + c, krow[e >> 1], S, window);
          const float p = ok ? exp2f(s[n][e] * scale_log2 - lse2[c]) : 0.f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - dd[c]);
        }
      // dV += P^T dO and dK += dS^T Q over this warp's columns
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk) {
        uint32_t pa[4], da[4];
        to_a(pa, s[2 * kk], s[2 * kk + 1]);
        to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int dn = 0; dn < DW / 8; dn += 2) {
          uint32_t ob[4], qb[4];
          frag_b_kn(ob, dos, LD, kk * 16, col0 + dn * 8, lane);
          frag_b_kn(qb, qs, LD, kk * 16, col0 + dn * 8, lane);
          mma_bf16(dva[dn], pa, ob[0], ob[1]);
          mma_bf16(dva[dn + 1], pa, ob[2], ob[3]);
          mma_bf16(dka[dn], da, qb[0], qb[1]);
          mma_bf16(dka[dn + 1], da, qb[2], qb[3]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (krow[i] >= S) continue;
    const size_t at = bkv * head + static_cast<size_t>(krow[i]) * DH + col0;
#pragma unroll
    for (int dn = 0; dn < DW / 8; ++dn) {
      const int c = dn * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dk + at + c) =
          pack_bf16(dka[dn][2 * i] * scale, dka[dn][2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + at + c) =
          pack_bf16(dva[dn][2 * i], dva[dn][2 * i + 1]);
    }
  }
}

// dQ of one 64-row q tile of one head. Warp w owns rows 16 (w % 4) .. +15
// and output columns DW (w / 4) .. +DW-1; the key tiles are 64 rows.
template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(Warps<DH>::THREADS)
dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ dsum,
               bf16* __restrict__ dq, int H, int rep, int S, int window,
               float scale, float scale_log2) {
  using W = Warps<DH>;
  constexpr int LD = W::LD, DW = W::DW, NT = W::THREADS;
  constexpr int QT = 64, KT = 64;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);   // [QT][LD]
  bf16* dos = qs + QT * LD;                    // [QT][LD]
  bf16* ks = dos + QT * LD;                    // [KT][LD]
  bf16* vs = ks + KT * LD;                     // [KT][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qw = warp & 3, col0 = (warp >> 2) * DW;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * QT;   // heaviest tiles first
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const size_t head = static_cast<size_t>(S) * DH;
  const size_t kvh = static_cast<size_t>(b) * (H / rep) + h / rep;
  load_rows<DH, QT, NT>(qs, q + bh * head, q0, S, tid);
  load_rows<DH, QT, NT>(dos, dout + bh * head, q0, S, tid);
  cp_async_commit();

  const int row[2] = {q0 + qw * 16 + g, q0 + qw * 16 + g + 8};
  float lse2[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t at = static_cast<size_t>(bh) * S + row[i];
    lse2[i] = row[i] < S ? lse[at] * LOG2E : 0.f;
    dd[i] = row[i] < S ? dsum[at] : 0.f;
  }
  float dqa[DW / 8][4];
#pragma unroll
  for (int n = 0; n < DW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;
  const int n_all = (S + KT - 1) / KT;
  const int n_kt = CAUSAL ? min(n_all, (q0 + QT - 1) / KT + 1) : n_all;
  const int j0 = window > 0 ? max(0, q0 - window + 1) / KT : 0;

  for (int j = j0; j < n_kt; ++j) {
    const int kv0 = j * KT;
    __syncthreads();   // every warp is done with the previous key tile
    load_rows<DH, KT, NT>(ks, k + kvh * head, kv0, S, tid);
    load_rows<DH, KT, NT>(vs, v + kvh * head, kv0, S, tid);
    cp_async_commit();
    cp_async_wait_0();
    __syncthreads();

    // S = Q K^T and dP = dO V^T: this warp's 16 rows x KT keys
    float s[KT / 8][4], dp[KT / 8][4];
#pragma unroll
    for (int n = 0; n < KT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t qa[4], oa[4];
      frag_a(qa, qs, LD, qw * 16, kk * 16, lane);
      frag_a(oa, dos, LD, qw * 16, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < KT / 8; n += 2) {
        uint32_t kb[4], vb[4];
        frag_b_nk(kb, ks, LD, n * 8, kk * 16, lane);
        frag_b_nk(vb, vs, LD, n * 8, kk * 16, lane);
        mma_bf16(s[n], qa, kb[0], kb[1]);
        mma_bf16(s[n + 1], qa, kb[2], kb[3]);
        mma_bf16(dp[n], oa, vb[0], vb[1]);
        mma_bf16(dp[n + 1], oa, vb[2], vb[3]);
      }
    }
    const bool edge = kv0 + KT > S || (CAUSAL && kv0 + KT - 1 > q0) ||
                      (window > 0 && kv0 <= q0 + QT - 1 - window);
#pragma unroll
    for (int n = 0; n < KT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const bool ok = !edge || visible<CAUSAL>(
                                     row[i], kv0 + n * 8 + 2 * t + (e & 1),
                                     S, window);
        const float p = ok ? exp2f(s[n][e] * scale_log2 - lse2[i]) : 0.f;
        dp[n][e] = p * (dp[n][e] - dd[i]);   // dS
      }
    // dQ += dS K over this warp's columns
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t da[4];
      to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < DW / 8; dn += 2) {
        uint32_t kb[4];
        frag_b_kn(kb, ks, LD, kk * 16, col0 + dn * 8, lane);
        mma_bf16(dqa[dn], da, kb[0], kb[1]);
        mma_bf16(dqa[dn + 1], da, kb[2], kb[3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= S) continue;
    bf16* out = dq + bh * head + static_cast<size_t>(row[i]) * DH + col0;
#pragma unroll
    for (int dn = 0; dn < DW / 8; ++dn)
      *reinterpret_cast<uint32_t*>(out + dn * 8 + 2 * t) =
          pack_bf16(dqa[dn][2 * i] * scale, dqa[dn][2 * i + 1] * scale);
  }
}

// -- fp32: scalar FMAs ------------------------------------------------------

constexpr int F_ROWS = 32;      // rows of a tile (keys or queries)
constexpr int F_THREADS = 128;  // four threads a row

// Rows row0 .. row0 + 31 of a [S, DH] fp32 head into shared memory with
// pitch DH + 1; rows past S are zeros.
template <int DH>
__device__ __forceinline__ void load_f32(float* sm, const float* g, int row0,
                                         int S, int tid) {
  for (int c = tid; c < F_ROWS * DH; c += F_THREADS) {
    const int r = c / DH, d = c % DH;
    sm[r * (DH + 1) + d] =
        row0 + r < S ? g[static_cast<size_t>(row0 + r) * DH + d] : 0.f;
  }
}

// dK and dV of one 32-key tile of one KV head over its group's query
// heads: thread (r = tid / 4, sub = tid % 4) owns key r, the queries
// 4i + sub of each q tile and the output columns 4i + sub.
template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(F_THREADS)
dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ dsum, float* __restrict__ dk,
                float* __restrict__ dv, int H, int rep, int S, int window,
                float scale) {
  constexpr int LD = DH + 1, LP = F_ROWS + 1, NC = DH / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);   // [32][LD]
  float* vs = ks + F_ROWS * LD;
  float* qs = vs + F_ROWS * LD;
  float* dos = qs + F_ROWS * LD;
  float* ps = dos + F_ROWS * LD;                 // [32][LP]: P^T
  float* dss = ps + F_ROWS * LP;                 // [32][LP]: dS^T
  float* lses = dss + F_ROWS * LP;               // [32]
  float* dd = lses + F_ROWS;                     // [32]

  const int tid = threadIdx.x, r = tid >> 2, sub = tid & 3;
  const int bkv = blockIdx.x, hkv = H / rep;
  const int b = bkv / hkv, kvh = bkv % hkv;
  const int k0 = blockIdx.y * F_ROWS, kr = k0 + r;
  const size_t head = static_cast<size_t>(S) * DH;
  load_f32<DH>(ks, k + bkv * head, k0, S, tid);
  load_f32<DH>(vs, v + bkv * head, k0, S, tid);
  float dka[NC], dva[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) dka[i] = dva[i] = 0.f;
  const int n_qt = (S + F_ROWS - 1) / F_ROWS;
  const int i_lo = CAUSAL ? k0 / F_ROWS : 0;
  const int i_hi =
      window > 0 ? min(n_qt, (k0 + F_ROWS - 2 + window) / F_ROWS + 1) : n_qt;

  for (int hh = 0; hh < rep; ++hh) {
    const size_t bh = static_cast<size_t>(b) * H + kvh * rep + hh;
    for (int it = i_lo; it < i_hi; ++it) {
      const int q0 = it * F_ROWS;
      __syncthreads();   // every thread is done with the previous q tile
      load_f32<DH>(qs, q + bh * head, q0, S, tid);
      load_f32<DH>(dos, dout + bh * head, q0, S, tid);
      if (tid < F_ROWS) {
        const int qr = q0 + tid;
        lses[tid] = qr < S ? lse[bh * S + qr] : 0.f;
        dd[tid] = qr < S ? dsum[bh * S + qr] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < F_ROWS / 4; ++i) {
        const int c = 4 * i + sub;
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < DH; ++d) {
          s += ks[r * LD + d] * qs[c * LD + d];
          dp += vs[r * LD + d] * dos[c * LD + d];
        }
        const float p = visible<CAUSAL>(q0 + c, kr, S, window)
                            ? expf(s * scale - lses[c])
                            : 0.f;
        ps[r * LP + c] = p;
        dss[r * LP + c] = p * (dp - dd[c]);
      }
      __syncwarp();   // the key's four threads wrote its row of P^T, dS^T
      for (int c = 0; c < F_ROWS; ++c) {
        const float p = ps[r * LP + c], ds = dss[r * LP + c];
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          dva[i] += p * dos[c * LD + 4 * i + sub];
          dka[i] += ds * qs[c * LD + 4 * i + sub];
        }
      }
    }
  }
  if (kr < S) {
    const size_t at = bkv * head + static_cast<size_t>(kr) * DH;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      dk[at + 4 * i + sub] = dka[i] * scale;
      dv[at + 4 * i + sub] = dva[i];
    }
  }
}

// dQ of one 32-row q tile of one head: thread (r = tid / 4, sub) owns row
// r, the keys 4i + sub of each key tile and the output columns 4i + sub.
template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(F_THREADS)
dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ dsum,
              float* __restrict__ dq, int H, int rep, int S, int window,
              float scale) {
  constexpr int LD = DH + 1, LP = F_ROWS + 1, NC = DH / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);   // [32][LD]
  float* dos = qs + F_ROWS * LD;
  float* ks = dos + F_ROWS * LD;
  float* vs = ks + F_ROWS * LD;
  float* dss = vs + F_ROWS * LD;                 // [32][LP]: dS

  const int tid = threadIdx.x, r = tid >> 2, sub = tid & 3;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * F_ROWS, row = q0 + r;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const size_t head = static_cast<size_t>(S) * DH;
  const size_t kvh = static_cast<size_t>(b) * (H / rep) + h / rep;
  load_f32<DH>(qs, q + bh * head, q0, S, tid);
  load_f32<DH>(dos, dout + bh * head, q0, S, tid);
  const size_t at = static_cast<size_t>(bh) * S + row;
  const float lse_r = row < S ? lse[at] : 0.f;
  const float d_r = row < S ? dsum[at] : 0.f;
  float dqa[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) dqa[i] = 0.f;
  const int n_all = (S + F_ROWS - 1) / F_ROWS;
  const int n_kt =
      CAUSAL ? min(n_all, (q0 + F_ROWS - 1) / F_ROWS + 1) : n_all;
  const int j0 = window > 0 ? max(0, q0 - window + 1) / F_ROWS : 0;

  for (int j = j0; j < n_kt; ++j) {
    const int kv0 = j * F_ROWS;
    __syncthreads();   // every thread is done with the previous key tile
    load_f32<DH>(ks, k + kvh * head, kv0, S, tid);
    load_f32<DH>(vs, v + kvh * head, kv0, S, tid);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < F_ROWS / 4; ++i) {
      const int c = 4 * i + sub;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < DH; ++d) {
        s += qs[r * LD + d] * ks[c * LD + d];
        dp += dos[r * LD + d] * vs[c * LD + d];
      }
      const float p = visible<CAUSAL>(row, kv0 + c, S, window)
                          ? expf(s * scale - lse_r)
                          : 0.f;
      dss[r * LP + c] = p * (dp - d_r);
    }
    __syncwarp();   // the row's four threads wrote its row of dS
    for (int c = 0; c < F_ROWS; ++c) {
      const float ds = dss[r * LP + c];
#pragma unroll
      for (int i = 0; i < NC; ++i) dqa[i] += ds * ks[c * LD + 4 * i + sub];
    }
  }
  if (row < S) {
    float* out = dq + bh * head + static_cast<size_t>(row) * DH;
#pragma unroll
    for (int i = 0; i < NC; ++i) out[4 * i + sub] = dqa[i] * scale;
  }
}

// -- launch ------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *o, *dout, *lse;
  void *dq, *dk, *dv, *dsum;
  int B, H, rep, S, window;
  float scale;
};

// Lets `kern` take `smem` bytes of dynamic shared memory (above 48 KB).
template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Dynamic shared memory of the bf16 dK/dV and dQ kernels at head dim DH
template <int DH>
constexpr size_t kv_smem_bf16() {
  return sizeof(bf16) * (2 * 64 + 2 * 32) * Warps<DH>::LD +
         sizeof(float) * 2 * 32;
}
template <int DH>
constexpr size_t q_smem_bf16() {
  return sizeof(bf16) * 4 * 64 * Warps<DH>::LD;
}

template <int DH, bool CAUSAL>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  using W = Warps<DH>;
  const float slog2 = a.scale * LOG2E;
  const size_t kv_smem = kv_smem_bf16<DH>();
  auto kv = dkdv_bf16_kernel<DH, CAUSAL>;
  cudaError_t err = allow_smem(kv, kv_smem);
  if (err != cudaSuccess) return err;
  kv<<<dim3(a.B * (a.H / a.rep), (a.S + 63) / 64), W::THREADS, kv_smem,
       stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.dsum),
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.H, a.rep, a.S,
      a.window, a.scale, slog2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t q_smem = q_smem_bf16<DH>();
  auto qk = dq_bf16_kernel<DH, CAUSAL>;
  if ((err = allow_smem(qk, q_smem)) != cudaSuccess) return err;
  qk<<<dim3(a.B * a.H, (a.S + 63) / 64), W::THREADS, q_smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.dsum),
      static_cast<bf16*>(a.dq), a.H, a.rep, a.S, a.window, a.scale, slog2);
  return cudaGetLastError();
}

template <int DH, bool CAUSAL>
cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  constexpr int LD = DH + 1, LP = F_ROWS + 1;
  const size_t kv_smem =
      sizeof(float) * (4 * F_ROWS * LD + 2 * F_ROWS * LP + 2 * F_ROWS);
  auto kv = dkdv_f32_kernel<DH, CAUSAL>;
  cudaError_t err = allow_smem(kv, kv_smem);
  if (err != cudaSuccess) return err;
  const int tiles = (a.S + F_ROWS - 1) / F_ROWS;
  kv<<<dim3(a.B * (a.H / a.rep), tiles), F_THREADS, kv_smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.dsum),
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.H, a.rep, a.S,
      a.window, a.scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t q_smem = sizeof(float) * (4 * F_ROWS * LD + F_ROWS * LP);
  auto qk = dq_f32_kernel<DH, CAUSAL>;
  if ((err = allow_smem(qk, q_smem)) != cudaSuccess) return err;
  qk<<<dim3(a.B * a.H, tiles), F_THREADS, q_smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.dsum),
      static_cast<float*>(a.dq), a.H, a.rep, a.S, a.window, a.scale);
  return cudaGetLastError();
}

template <typename T, int DH, bool CAUSAL>
cudaError_t launch(const Args& a, cudaStream_t st) {
  if constexpr (sizeof(T) == 2)
    return launch_bf16<DH, CAUSAL>(a, st);
  else
    return launch_f32<DH, CAUSAL>(a, st);
}

template <typename T, bool CAUSAL>
cudaError_t dispatch(const Args& a, int dh, cudaStream_t st) {
  switch (dh) {
    case 16: return launch<T, 16, CAUSAL>(a, st);
    case 32: return launch<T, 32, CAUSAL>(a, st);
    case 64: return launch<T, 64, CAUSAL>(a, st);
    case 128: return launch<T, 128, CAUSAL>(a, st);
    case 256: return launch<T, 256, CAUSAL>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int run(const void* q, const void* k, const void* v, const void* o,
        const void* dout, const void* lse, void* dq, void* dk, void* dv,
        void* dsum, int B, int H, int Hkv, int S, int dh, int causal,
        int scale_dh, int window, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || S < 1 || H % Hkv || scale_dh < 1 ||
      scale_dh > dh || window < 0 ||
      static_cast<long long>(B) * H > 0x7fffffffLL ||
      (S + F_ROWS - 1) / F_ROWS > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(B) * H * S;
  dot_kernel<T><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, st>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<float*>(dsum), rows, dh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{q, k, v, o, dout, lse, dq, dk, dv, dsum, B, H, H / Hkv, S,
               window,
               static_cast<float>(1.0 / sqrt(static_cast<double>(scale_dh)))};
  return static_cast<int>(causal ? dispatch<T, true>(a, dh, st)
                                 : dispatch<T, false>(a, dh, st));
}

}  // namespace

// Dynamic shared memory per block of the bf16 dK/dV kernel and of the dQ
// kernel at head dim d (16, 32, 64, 128 or 256; k unused), the larger of
// the two, 0 for another d.
extern "C" int flash_attention_bwd_smem_bytes(int d, int) {
  switch (d) {
    case 16: return static_cast<int>(q_smem_bf16<16>());
    case 32: return static_cast<int>(q_smem_bf16<32>());
    case 64: return static_cast<int>(q_smem_bf16<64>());
    case 128: return static_cast<int>(q_smem_bf16<128>());
    case 256: return static_cast<int>(q_smem_bf16<256>());
    default: return 0;
  }
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q/o/dO/dq:[B,H,S,dh], k/v/dk/dv:[B,Hkv,S,dh] contiguous, 16-byte aligned,
// one dtype; lse and dsum (scratch for D) fp32 [B,H,S]; H % Hkv == 0; dh in
// {16, 32, 64, 128, 256}; the softmax scale 1/sqrt(scale_dh), 1 <= scale_dh
// <= dh; window >= 0 (0: none). Launches the three passes on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* dsum, int B, int H, int Hkv, int S, int dh, int causal,
    int scale_dh, int window, void* stream) {
  return run<bf16>(q, k, v, o, dout, lse, dq, dk, dv, dsum, B, H, Hkv, S, dh,
                   causal, scale_dh, window, stream);
}

extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* dsum, int B, int H, int Hkv, int S, int dh, int causal,
    int scale_dh, int window, void* stream) {
  return run<float>(q, k, v, o, dout, lse, dq, dk, dv, dsum, B, H, Hkv, S,
                    dh, causal, scale_dh, window, stream);
}
