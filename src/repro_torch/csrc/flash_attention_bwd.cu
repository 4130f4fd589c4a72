// The gradient of attention: given q:[B,H,S,dh], k/v:[B,Hkv,S,dh], the
// forward's output o and per-row log-sum-exp lse (fp32 [B,H,S], written by
// flash_attention.cu on request) and the output's gradient dO, computes
// dq:[B,H,S,dh] and dk, dv:[B,Hkv,S,dh] for causal or not, any GQA group
// (query head h reads KV head h / (H / Hkv)), the runtime sliding window
// (window > 0: key j visible to query i iff j > i - window), the runtime
// soft cap (softcap > 0: the scaled logit s becomes c tanh(s / c), c =
// softcap; 0: none) and the softmax scale 1/sqrt(scale_dh), in bf16 or
// fp32. With P = exp(capped(q k^T * scale) - lse) over the visible pairs,
// D = rowsum(dO * o) and t = tanh(q k^T * scale / c) (t = 0 and no factor
// without a cap):
//   dv = P^T dO,  dS = P * (dO v^T - D) * (1 - t^2),  dq = dS k * scale,
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
// the forward's operations (S, dP, dV, dK and dQ: five products of the
// forward's two-product size, each 2 * dh flops a visible pair), 515
// GFLOP, 0.52 ms at the 989 TFLOP/s bf16 tensor peak: operations, by a
// factor of six, which on Hopper only wgmma reaches.
//
// Which design runs where (picked by dtype and dh alone, as the forward's):
//  * bf16, dh 64 or 128 (every training shape of the zoo; Zamba2's dh 80
//    arrives padded to 128): the Hopper design below (namespace wg),
//    sm_90a only.
//  * bf16, dh 16, 32 or 256: mma.sync, in three passes (dot, dK/dV, dQ).
//  * fp32, dh 16, 32, 64, 128 or 256: scalar FMAs, the same three passes.
// Head dims off these arrive zero-padded by the wrapper with the true dh
// as scale_dh: zero columns add nothing to dq, dk or dv's true columns.
//
// The Hopper design: one pass over the keys that does the five products
// once (the three-pass design below recomputes S and dP in its dQ pass:
// 7/5 of them), deterministically.
//  1. Preprocess (one launch): D = rowsum(dO * o) and lse log2(e) per row
//     into rows padded to 64 a head (0 past S), so a q tile's 256 bytes of
//     each load as one bulk copy; the dQ counters and the work counter
//     zeroed. The scratch comes from the wrapper.
//  2. The main kernel, a persistent grid of one block per SM. Work items
//     are (b, KV head, 128-key tile), claimed from a global atomic counter
//     in ascending key-tile order (causal: the heaviest first, as key tile
//     0 is seen by every q tile). In the producer warpgroup, which gives
//     its registers up (setmaxnreg), one thread issues every load as a
//     TMA tile copy in the 128-byte swizzle: the item's K and V tiles
//     once, then for each query head of the group and each 64-row q tile
//     that sees the key tile, its Q and dO tiles and its lse and D rows,
//     through a 2-stage ring with a full and an empty mbarrier a stage.
//     Two consumer warpgroups own 64 keys each:
//       S^T = K Q^T and dP^T = V dO^T run as wgmma m64n64k16, both
//       operands in shared memory, the two consumers taking turns to
//       issue them (named barriers), so one's P^T and dS^T work runs
//       beside the other's products; P^T and dS^T are computed in
//       registers (the cap, where set, in a uniform branch) and rounded to
//       bf16 as they are made; dV += P^T dO and dK += dS^T Q take them as
//       register A operands and dO and Q MN-major from shared memory (one
//       m64n128 product a k16 step at dh 128); dK and dV stay in fp32
//       registers across the whole group, so the group's sum needs no
//       atomics. Each consumer stores its dS^T rows to shared memory as
//       bf16 (swizzled as TMA would) and arrives on the tile's mbarrier;
//       dQ_tile [64 x dh] = dS [64 x 128] K [128 x dh] runs a tile later,
//       beside the next tile's dV and dK, as wgmma with dS and K both
//       MN-major from shared memory, each consumer taking half the columns
//       (n64 at dh 128, n32 at dh 64), and the fp32 tile is staged in
//       shared memory for the writer. Deferring dQ keeps the consumers
//       from meeting in the middle of every tile.
//     Registers at dh 128: dK 64 + dV 64 + S^T 32 + dP^T 32 a consumer
//     thread, then the bf16 fragments (16 + 16) and dQ's 32 once S^T and
//     dP^T are spent, under setmaxnreg's budget. Shared memory at dh 128:
//     K and V 32 KB each, Q and dO 2 x 16 KB each, two dS^T buffers of 16
//     KB and two staged dQ tiles of 32 KB (alternate q tiles), the rows:
//     231,576 bytes.
//  3. dQ is summed over key tiles in a fixed order, so a call is bit for
//     bit repeatable (training restarts are held to it): one thread of
//     the producer warpgroup, the writer, adds each staged tile of (b,
//     head, q tile) into an fp32 accumulator [B*H, S_pad, dh] as one bulk
//     copy (cp.reduce.async.bulk .add.f32; rank 0 stores, so the
//     accumulator needs no zeroing) once that tile's counter equals its
//     key tile's rank among the tiles that see the q tile, and releases
//     the counter when the copy's writes are done. Items are claimed in
//     ascending key-tile order from one counter, so a wait only ever names
//     an item that a running block holds, and no thread holds a release
//     while it waits: the earliest unfinished item never waits, and the
//     grid cannot deadlock, where a static assignment of items could.
//     Every item walks its q tiles from the last down, heads inner: items
//     of one (b, KV head) then reach a shared q tile at the same point of
//     their walks, and a later key tile waits about one add for the one
//     before, not for the tiles that only the earlier one sees (ascending
//     walks, which stagger the items by the tiles in between, ran slower
//     at the training shape). Whole tiles go by bulk copies: element-wise
//     red.add from the consumers was far slower there.
//  4. Postprocess: dq = the accumulator * scale in bf16, written with dq's
//     strides. The accumulator's rows hold their 16-byte chunks XOR the
//     row's index mod 8, so the consumers' staging stores are free of bank
//     conflicts.
// The tensor maps carry the callers' strides (unit stride in dh, 16-byte
// multiples elsewhere), so the model's [B,S,H,dh] activations read as
// [B,H,S,dh] need no copy, and dq, dk and dv are written in layouts of
// the caller's choosing (the wrapper's: q's, k's and v's). Rows and keys
// past S read as zeros, are masked and are not stored.
//
// The other designs: dot, then dkdv: one block per (b, KV head, 64-key
// tile) keeps its K and V tiles in shared memory and loops over the q
// tiles of every query head of its group that see any of its keys,
// recomputing S^T and dP^T, accumulating dV and dK in fp32 registers
// across the group; then dq: one block per (b, head, 64-row q tile) loops
// over the key tiles its rows see, recomputing S, dP, P and dS. bf16: 4
// warps own 16 rows each and run mma.sync.m16n8k16 from ldmatrix loads
// (at dh 256, 8 warps, two a row group, each owning 128 output columns).
// fp32: scalar FMAs, 32-row tiles, four threads a row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "cp_async.cuh"
#include "mma_sync.cuh"
#include "sm90.cuh"

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

// A logit in the units its exponent takes, from the raw product s: s * mul
// without a cap (cap_in == 0), else cap_out * tanh(s * cap_in) (cap_in =
// scale / softcap; cap_out = softcap, times log2(e) in base 2), the cap's
// derivative 1 - tanh^2 in dcap (1 without one). The branch is uniform.
__device__ __forceinline__ float capped(float s, float mul, float cap_in,
                                        float cap_out, float& dcap) {
  if (cap_in > 0.f) {
    const float t = tanhf(s * cap_in);
    dcap = 1.f - t * t;
    return t * cap_out;
  }
  dcap = 1.f;
  return s * mul;
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
                 float scale, float scale_log2, float softcap) {
  using W = Warps<DH>;
  constexpr int LD = W::LD, DW = W::DW, NT = W::THREADS;
  constexpr int KT = 64, QT = 32;
  const float cap_in = softcap > 0.f ? scale / softcap : 0.f;
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
          float dcap;
          const float x =
              capped(s[n][e], scale_log2, cap_in, softcap * LOG2E, dcap);
          const float p = ok ? exp2f(x - lse2[c]) : 0.f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - dd[c]) * dcap;
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
               float scale, float scale_log2, float softcap) {
  using W = Warps<DH>;
  constexpr int LD = W::LD, DW = W::DW, NT = W::THREADS;
  constexpr int QT = 64, KT = 64;
  const float cap_in = softcap > 0.f ? scale / softcap : 0.f;
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
        float dcap;
        const float x =
            capped(s[n][e], scale_log2, cap_in, softcap * LOG2E, dcap);
        const float p = ok ? exp2f(x - lse2[i]) : 0.f;
        dp[n][e] = p * (dp[n][e] - dd[i]) * dcap;   // dS
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
                float scale, float softcap) {
  constexpr int LD = DH + 1, LP = F_ROWS + 1, NC = DH / 4;
  const float cap_in = softcap > 0.f ? scale / softcap : 0.f;
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
        float dcap;
        const float x = capped(s, scale, cap_in, softcap, dcap);
        const float p =
            visible<CAUSAL>(q0 + c, kr, S, window) ? expf(x - lses[c]) : 0.f;
        ps[r * LP + c] = p;
        dss[r * LP + c] = p * (dp - dd[c]) * dcap;
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
              float scale, float softcap) {
  constexpr int LD = DH + 1, LP = F_ROWS + 1, NC = DH / 4;
  const float cap_in = softcap > 0.f ? scale / softcap : 0.f;
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
      float dcap;
      const float x = capped(s, scale, cap_in, softcap, dcap);
      const float p =
          visible<CAUSAL>(row, kv0 + c, S, window) ? expf(x - lse_r) : 0.f;
      dss[r * LP + c] = p * (dp - d_r) * dcap;
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

// -- the Hopper path: bf16, dh 64 or 128 -------------------------------------

namespace wg {

constexpr int BQ = 64;              // query rows per q tile
constexpr int BK = 128;             // keys per work item: 64 per consumer
constexpr int STAGES = 2;           // the Q, dO, lse and D ring
constexpr int THREADS = 384;        // producer warpgroup + 2 consumers
constexpr int CONSUMERS = 256;
// setmaxnreg: 128 * 24 + 256 * 240 = 64,512 = 384 threads * 168 at launch
// at dh 128, where the consumers' dK and dV take 128 registers; at dh 64
// the producer thread keeps 40 (it spills at 24) and the consumers 232
template <int DH>
constexpr int PRODUCER_REGS = DH == 128 ? 24 : 40;
template <int DH>
constexpr int CONSUMER_REGS = DH == 128 ? 240 : 232;
constexpr int TURN = 1;             // named barriers 1, 2: the issue turns
constexpr int WRITER = 32;          // the thread that adds dQ tiles

// Shared memory, every tile on a 1,024-byte boundary (the swizzle's
// period): the item's K and V tiles [DH/64][BK][64], STAGES Q and STAGES
// dO tiles [DH/64][BQ][64], two dS^T buffers [BK][BQ] and two fp32 dQ
// tiles [BQ][DH] (alternate q tiles), STAGES x (lse2, D) rows of BQ
// floats, the barriers and the item ids. At dh 128: 231,576 bytes of the
// 232,448 a block may have.
template <int DH>
struct Layout {
  static constexpr int CH = DH / 64;                 // 64-column chunks
  static constexpr int Q_CHUNK = BQ * 128;           // bytes
  static constexpr int KV_CHUNK = BK * 128;
  static constexpr int Q_BYTES = CH * Q_CHUNK;       // a Q or dO tile
  static constexpr int KV_BYTES = CH * KV_CHUNK;     // the K or V tile
  static constexpr int DS_BYTES = BK * BQ * 2;
  static constexpr int DQ_BYTES = BQ * DH * 4;
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int Q_OFF = 2 * KV_BYTES;
  static constexpr int DO_OFF = Q_OFF + STAGES * Q_BYTES;
  static constexpr int DS_OFF = DO_OFF + STAGES * Q_BYTES;
  static constexpr int DQ_OFF = DS_OFF + 2 * DS_BYTES;
  static constexpr int ROW_OFF = DQ_OFF + 2 * DQ_BYTES;
  static constexpr int BAR_OFF = ROW_OFF + STAGES * 2 * BQ * 4;
  // full, empty [STAGES] each, kv_full, kv_empty, item_full[2],
  // item_empty[2], dq_full[2], dq_empty[2], ds_full[2], ds_empty[2]
  static constexpr int N_BARS = 2 * STAGES + 14;
  static constexpr int ITEM_OFF = BAR_OFF + 8 * N_BARS;   // int[2]
  static constexpr int BYTES = ITEM_OFF + 8 + 1024;       // + alignment
};

// Work item i: key tile kt of KV head kvh of batch b, items in ascending
// key-tile order; it reads the q tiles lo .. hi - 1 of each query head of
// the group (those with a row that sees one of its keys).
struct Item {
  int kt, b, kvh, lo, hi;
};

__device__ __forceinline__ Item item_at(int i, int B, int Hkv, int n_qt,
                                        bool causal, int window) {
  Item r;
  const int bkv = i % (B * Hkv);
  r.kt = i / (B * Hkv);
  r.b = bkv / Hkv;
  r.kvh = bkv % Hkv;
  r.lo = causal ? r.kt * (BK / BQ) : 0;
  r.hi = window > 0 ? min(n_qt, (r.kt * BK + BK - 2 + window) / BQ + 1)
                    : n_qt;
  return r;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// Preprocess: per row of the padded [B*H, S_pad] grid, lse2 = lse log2(e)
// and D = rowsum(dO * o) (0 past S), DH / 8 threads a row with 16-byte
// loads (the grid holds whole warps: S_pad is a multiple of 64); and the
// dQ counters and the item counter zeroed.
template <int DH>
__global__ void __launch_bounds__(256)
pre_kernel(const bf16* __restrict__ o, long long o_sb, long long o_sh,
           long long o_ss, const bf16* __restrict__ dout, long long d_sb,
           long long d_sh, long long d_ss, const float* __restrict__ lse,
           float* __restrict__ lse2, float* __restrict__ dsum,
           int* __restrict__ counts, int n_counts, int H, int S, int S_pad) {
  constexpr int TPR = DH / 8;   // threads a row
  const long long gid = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (gid < n_counts) counts[gid] = 0;
  const long long row = gid / TPR, bh = row / S_pad;
  const int s = static_cast<int>(row % S_pad), c = (threadIdx.x % TPR) * 8;
  float d = 0.f;
  if (s < S) {
    const long long b = bh / H, h = bh % H;
    const uint4 a = *reinterpret_cast<const uint4*>(o + b * o_sb + h * o_sh +
                                                    s * o_ss + c);
    const uint4 g = *reinterpret_cast<const uint4*>(dout + b * d_sb +
                                                    h * d_sh + s * d_ss + c);
    const uint32_t av[4] = {a.x, a.y, a.z, a.w}, gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&av[i]));
      const float2 y = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&gv[i]));
      d += x.x * y.x + x.y * y.y;
    }
  }
#pragma unroll
  for (int w = TPR / 2; w > 0; w >>= 1)
    d += __shfl_xor_sync(0xffffffffu, d, w);
  if (c == 0) {
    lse2[row] = s < S ? lse[bh * S + s] * LOG2E : 0.f;
    dsum[row] = d;
  }
}

// The position of column c of row r in a row of the fp32 dQ accumulator:
// its 16-byte chunk XOR r % 8, so that the consumers' fragment stores into
// a staged tile of the same layout are free of bank conflicts.
__device__ __forceinline__ int dq_col(int r, int c) {
  return (((c >> 2) ^ (r & 7)) << 2) | (c & 3);
}

// Postprocess: dq = the fp32 accumulator [B*H, S_pad, DH] x scale in bf16,
// written with dq's strides, 8 columns a thread.
template <int DH>
__global__ void __launch_bounds__(256)
post_kernel(const float* __restrict__ acc, bf16* __restrict__ dq,
            long long sb, long long sh, long long ss, int H, int S,
            int S_pad, long long n, float scale) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n) return;
  const long long row = i / (DH / 8);
  const int c = static_cast<int>(i % (DH / 8)) * 8;
  const long long bh = row / S, s = row % S;
  const float* src = acc + (bh * S_pad + s) * DH;
  const int r = static_cast<int>(s);
  const float4 x = *reinterpret_cast<const float4*>(src + dq_col(r, c));
  const float4 y = *reinterpret_cast<const float4*>(src + dq_col(r, c + 4));
  const uint4 out = make_uint4(
      pack_bf16(x.x * scale, x.y * scale), pack_bf16(x.z * scale, x.w * scale),
      pack_bf16(y.x * scale, y.y * scale), pack_bf16(y.z * scale, y.w * scale));
  *reinterpret_cast<uint4*>(dq + (bh / H) * sb + (bh % H) * sh + s * ss + c) =
      out;
}

// A consumer's P^T and dS^T from its S^T and dP^T fragments (64 keys x 64
// q rows), rounded to bf16 as they are made: the A fragments of the four
// k16 steps over q (fragment column block j = 2kk + h). P^T = 2^(x -
// lse2) over the visible pairs, x the scaled (CAP: capped) logit in base
// 2; dS^T = P^T * (dP^T - D) (CAP: times the cap's derivative). rs holds
// the q tile's lse2 then D rows; a pair with no invisible key or row
// (edge false) skips the test. A template on CAP, so the kernel without a
// cap does no per-logit work for it.
template <bool CAP, bool CAUSAL>
__device__ __forceinline__ void p_ds(const float (&s)[32],
                                     const float (&dp)[32],
                                     uint32_t (&pf)[4][4],
                                     uint32_t (&df)[4][4], const float* rs,
                                     bool edge, int q0, int krow, int t4,
                                     int S, int window, float scale_log2,
                                     float cap_in, float cap_l2) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * kk + h, col = 8 * j + 2 * t4;
      const float2 l2 = *reinterpret_cast<const float2*>(rs + col);
      const float2 dd = *reinterpret_cast<const float2*>(rs + BQ + col);
      float p4[4], d4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[4 * j + e];
        float t = 0.f, p;
        if constexpr (CAP) {
          t = tanh_ex2(x * cap_in);
          p = ex2(t * cap_l2 - ((e & 1) ? l2.y : l2.x));
        } else {
          p = ex2(x * scale_log2 - ((e & 1) ? l2.y : l2.x));
        }
        if (edge && !visible<CAUSAL>(q0 + col + (e & 1), krow + 8 * (e >> 1),
                                     S, window))
          p = 0.f;
        p4[e] = p;
        d4[e] = p * (dp[4 * j + e] - ((e & 1) ? dd.y : dd.x));
        if constexpr (CAP) d4[e] *= 1.f - t * t;
      }
      pf[kk][2 * h] = pack_bf16(p4[0], p4[1]);
      pf[kk][2 * h + 1] = pack_bf16(p4[2], p4[3]);
      df[kk][2 * h] = pack_bf16(d4[0], d4[1]);
      df[kk][2 * h + 1] = pack_bf16(d4[2], d4[3]);
    }
}

// The descriptor of p (desc_sw128) as a value made where it is used: the
// descriptors of every k16 step of K, V and dQ's B operand are the same
// for all q tiles of an item, and hoisted out of the q-tile loop they
// would hold 48 registers across it. A step's descriptor adds its byte
// offset / 16 to this one's start-address field (no offset carries out of
// it: shared memory ends below 2^18 bytes).
__device__ __forceinline__ uint64_t desc_here(const void* p) {
  uint64_t d = sm90::desc_sw128(p);
  asm volatile("" : "+l"(d));
  return d;
}

// desc_here of an MN-major operand of two 64-column chunks lbo bytes
// apart (desc_sw128_mn).
__device__ __forceinline__ uint64_t desc_here_mn(const void* p, uint32_t lbo) {
  uint64_t d = sm90::desc_sw128_mn(p, lbo);
  asm volatile("" : "+l"(d));
  return d;
}

// Two m64n64 accumulators side by side as one m64n128 accumulator: the
// same registers in the same order (the n128 fragment's columns 64.. are
// the second chunk's).
__device__ __forceinline__ float (&as_row(float (&a)[2][32]))[64] {
  return *reinterpret_cast<float(*)[64]>(&a[0][0]);
}

template <int CH>
__device__ __forceinline__ void fence_acc(float (&a)[CH][32]) {
#pragma unroll
  for (int c = 0; c < CH; ++c) sm90::reg_fence(a[c]);
}
__device__ __forceinline__ void fence_frags(uint32_t (&f)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) sm90::reg_fence(f[kk]);
}

// The main kernel: a persistent grid; each block claims work items from
// counts[B*H*n_qt] in ascending order.
template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(THREADS, 1)
bwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const __grid_constant__ CUtensorMap do_map,
                 const float* __restrict__ lse2,
                 const float* __restrict__ dsum, float* __restrict__ dq_acc,
                 int* __restrict__ counts, bf16* __restrict__ dk,
                 long long k_sb, long long k_sh, long long k_ss,
                 bf16* __restrict__ dv, long long v_sb, long long v_sh,
                 long long v_ss, int B, int H, int Hkv, int S, int window,
                 float scale, float scale_log2, float cap_in, float cap_l2) {
  using L = Layout<DH>;
  constexpr int NQ = DH / 2;   // dQ columns a consumer computes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = bars;
  uint64_t* empty = bars + STAGES;
  uint64_t* kv_full = bars + 2 * STAGES;
  uint64_t* kv_empty = kv_full + 1;
  uint64_t* item_full = kv_full + 2;
  uint64_t* item_empty = kv_full + 4;
  uint64_t* dq_full = kv_full + 6;
  uint64_t* dq_empty = kv_full + 8;
  uint64_t* ds_full = kv_full + 10;
  uint64_t* ds_empty = kv_full + 12;
  int* items = reinterpret_cast<int*>(smem + L::ITEM_OFF);

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], CONSUMERS);
    }
    sm90::mbar_init(kv_full, 1);
    sm90::mbar_init(kv_empty, CONSUMERS);
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(&item_full[s], 1);
      sm90::mbar_init(&item_empty[s], CONSUMERS + 1);   // + the writer
      sm90::mbar_init(&dq_full[s], CONSUMERS);
      sm90::mbar_init(&dq_empty[s], 1);
      sm90::mbar_init(&ds_full[s], CONSUMERS);
      sm90::mbar_init(&ds_empty[s], CONSUMERS);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int rep = H / Hkv;
  const int n_qt = (S + BQ - 1) / BQ, S_pad = n_qt * BQ;
  const int n_items = (S + BK - 1) / BK * B * Hkv;
  int* work = counts + static_cast<size_t>(B) * H * n_qt;

  if (tid < 128) {   // producer warpgroup: one thread claims and loads
    sm90::setmaxnreg_dec<PRODUCER_REGS<DH>>();
    if (tid == 0) {
      sm90::tma_prefetch_desc(&q_map);
      sm90::tma_prefetch_desc(&k_map);
      sm90::tma_prefetch_desc(&v_map);
      sm90::tma_prefetch_desc(&do_map);
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0;; ++it) {
        const int slot = it & 1;
        sm90::mbar_wait(&item_empty[slot], ((it >> 1) & 1) ^ 1);
        const int i = atomicAdd(work, 1);
        items[slot] = i;
        sm90::mbar_arrive(&item_full[slot]);
        if (i >= n_items) break;
        const Item w = item_at(i, B, Hkv, n_qt, CAUSAL, window);
        sm90::mbar_wait(kv_empty, (it & 1) ^ 1);   // the last item is done
        sm90::mbar_expect_tx(kv_full, 2 * L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < L::CH; ++c) {
          sm90::tma_load_4d(smem + c * L::KV_CHUNK, &k_map, kv_full, c * 64,
                            w.kt * BK, w.kvh, w.b);
          sm90::tma_load_4d(smem + L::V_OFF + c * L::KV_CHUNK, &v_map,
                            kv_full, c * 64, w.kt * BK, w.kvh, w.b);
        }
        for (int qt = w.hi - 1; qt >= w.lo; --qt) {   // the item's order
          for (int hh = 0; hh < rep; ++hh) {
            const int h = w.kvh * rep + hh;
            const size_t rows = (static_cast<size_t>(w.b) * H + h) * S_pad;
            sm90::mbar_wait(&empty[stage], phase ^ 1);
            sm90::mbar_expect_tx(&full[stage], 2 * L::Q_BYTES + 2 * BQ * 4);
#pragma unroll
            for (int c = 0; c < L::CH; ++c) {
              sm90::tma_load_4d(
                  smem + L::Q_OFF + stage * L::Q_BYTES + c * L::Q_CHUNK,
                  &q_map, &full[stage], c * 64, qt * BQ, h, w.b);
              sm90::tma_load_4d(
                  smem + L::DO_OFF + stage * L::Q_BYTES + c * L::Q_CHUNK,
                  &do_map, &full[stage], c * 64, qt * BQ, h, w.b);
            }
            float* rs =
                reinterpret_cast<float*>(smem + L::ROW_OFF) + stage * 2 * BQ;
            sm90::bulk_load(rs, lse2 + rows + qt * BQ, BQ * 4, &full[stage]);
            sm90::bulk_load(rs + BQ, dsum + rows + qt * BQ, BQ * 4,
                            &full[stage]);
            if (++stage == STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    } else if (tid == WRITER) {
      // The ordered adds: each staged dQ tile of (b, head, q tile) goes
      // into the accumulator once the tile's counter equals this key
      // tile's rank among the tiles that see the q tile (rank 0 stores),
      // as one bulk copy; the counter is released once the copy's writes
      // are done.
      int nt = 0;
      for (int it = 0;; ++it) {
        const int slot = it & 1;
        sm90::mbar_wait(&item_full[slot], (it >> 1) & 1);
        const int i = items[slot];
        sm90::mbar_arrive(&item_empty[slot]);
        if (i >= n_items) break;
        const Item w = item_at(i, B, Hkv, n_qt, CAUSAL, window);
        for (int qt = w.hi - 1; qt >= w.lo; --qt) {
          for (int hh = 0; hh < rep; ++hh, ++nt) {
            const int bh = w.b * H + w.kvh * rep + hh;
            const int q0 = qt * BQ, b2 = nt & 1;
            const int rank =
                w.kt - (window > 0 ? max(0, q0 - window + 1) / BK : 0);
            int* cnt = counts + static_cast<size_t>(bh) * n_qt + qt;
            float* acc = dq_acc + (static_cast<size_t>(bh) * S_pad + q0) * DH;
            const unsigned char* tile = smem + L::DQ_OFF + b2 * L::DQ_BYTES;
            sm90::mbar_wait(&dq_full[b2], (nt >> 1) & 1);
            if (rank == 0) {
              sm90::bulk_store(acc, tile, L::DQ_BYTES);
            } else {
              while (ld_acquire(cnt) != rank) {
              }
              sm90::fence_proxy_async_global();
              sm90::bulk_add_f32(acc, tile, L::DQ_BYTES);
            }
            sm90::bulk_commit();
            sm90::bulk_wait_read();
            sm90::mbar_arrive(&dq_empty[b2]);   // the staged tile is free
            sm90::bulk_wait();
            sm90::fence_proxy_async_global();
            st_release(cnt, rank + 1);
          }
        }
      }
    }
    return;
  }

  // consumer warpgroups: cw owns keys 64cw .. 64cw+63 of the item's tile
  sm90::setmaxnreg_inc<CONSUMER_REGS<DH>>();
  const int ct = tid - 128, cw = ct >> 7;
  const int warp = (ct >> 5) & 3, lane = ct & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const unsigned char* ks = smem + cw * 64 * 128;   // this consumer's keys
  const unsigned char* vs = smem + L::V_OFF + cw * 64 * 128;
  // dQ's B operand: K's columns NQ cw .. NQ cw + NQ - 1 (MN-major)
  const unsigned char* kq =
      smem + (DH == 128 ? cw * L::KV_CHUNK : cw * NQ * 2);
  int stage = 0, nt = 0;   // nt: q tiles begun (alternates dS^T, dQ)
  uint32_t phase = 0;
  // The two consumers take turns to issue S^T and dP^T (named barriers
  // TURN, TURN + 1; consumer 0 first), so one's P^T and dS^T work runs
  // beside the other's products.
  if (cw == 1) sm90::bar_arrive(TURN, CONSUMERS);

  // dQ of tile n (this consumer's NQ columns) = dS K over the item's 128
  // keys, once both consumers' dS^T rows of n are in buffer n & 1 (A = dS
  // and B = K both MN-major), then staged for the writer in the
  // accumulator's layout (dq_col). It runs a tile late, beside the next
  // tile's dV and dK (whose products it waits for too), so that neither
  // consumer waits for the other's dS^T in the middle of a tile.
  auto dq_tile = [&](int n) {
    const int b = n & 1;
    sm90::mbar_wait(&ds_full[b], (n >> 1) & 1);
    float dq[NQ / 2] = {};
    sm90::reg_fence(dq);
    const uint64_t d_ds = desc_here(smem + L::DS_OFF + b * L::DS_BYTES);
    const uint64_t d_kq = desc_here(kq);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = d_ds + (kk * 2048 >> 4);
      const uint64_t db = d_kq + (kk * 2048 >> 4);
      if constexpr (DH == 128)
        sm90::wgmma_m64n64k16_ss<1, 1>(dq, da, db, kk > 0);
      else
        sm90::wgmma_m64n32k16_ss<1, 1>(dq, da, db, kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::reg_fence(dq);
    sm90::mbar_arrive(&ds_empty[b]);   // this consumer has read buffer b
    sm90::mbar_wait(&dq_empty[b], ((n >> 1) & 1) ^ 1);
    float* tile = reinterpret_cast<float*>(smem + L::DQ_OFF + b * L::DQ_BYTES);
    int rq = warp * 16 + g;   // made here (see r0 below)
    asm volatile("" : "+r"(rq));
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      const int r = rq + 8 * i2;
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j)
        *reinterpret_cast<float2*>(
            tile + r * DH + dq_col(r, cw * NQ + 8 * j + 2 * t4)) =
            make_float2(dq[4 * j + 2 * i2], dq[4 * j + 2 * i2 + 1]);
    }
    sm90::fence_proxy_async();
    sm90::mbar_arrive(&dq_full[b]);
  };

  for (int it = 0;; ++it) {
    const int slot = it & 1;
    sm90::mbar_wait(&item_full[slot], (it >> 1) & 1);
    const int i = items[slot];
    sm90::mbar_arrive(&item_empty[slot]);
    if (i >= n_items) break;
    const Item w = item_at(i, B, Hkv, n_qt, CAUSAL, window);
    const int k0 = w.kt * BK;
    const int krow = k0 + cw * 64 + warp * 16 + g;   // keys krow, krow + 8
    float dka[L::CH][32], dva[L::CH][32];
#pragma unroll
    for (int c = 0; c < L::CH; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) dka[c][e] = dva[c][e] = 0.f;
    sm90::mbar_wait(kv_full, it & 1);
    const int first = nt;   // the item's first tile

    for (int qt = w.hi - 1; qt >= w.lo; --qt) {
      for (int hh = 0; hh < rep; ++hh, ++nt) {
        const int q0 = qt * BQ, b2 = nt & 1;
        const unsigned char* qs = smem + L::Q_OFF + stage * L::Q_BYTES;
        const unsigned char* dos = smem + L::DO_OFF + stage * L::Q_BYTES;
        const float* rs =
            reinterpret_cast<const float*>(smem + L::ROW_OFF) + stage * 2 * BQ;
        unsigned char* dst = smem + L::DS_OFF + b2 * L::DS_BYTES;
        sm90::mbar_wait(&full[stage], phase);

        // S^T = K Q^T and dP^T = V dO^T: this consumer's 64 keys x 64 rows
        float s[32] = {}, dp[32] = {};
        sm90::reg_fence(s);
        sm90::reg_fence(dp);
        const uint64_t d_k = desc_here(ks), d_v = desc_here(vs);
        const uint64_t d_q = desc_here(qs), d_do = desc_here(dos);
        sm90::bar_sync(TURN + cw, 2 * 128);   // this consumer's turn
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {   // 16-byte units below
          const int kv = (kk / 4 * L::KV_CHUNK + kk % 4 * 32) >> 4;
          const int qo = (kk / 4 * L::Q_CHUNK + kk % 4 * 32) >> 4;
          sm90::wgmma_m64n64k16_ss<0, 0>(s, d_k + kv, d_q + qo, kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          const int kv = (kk / 4 * L::KV_CHUNK + kk % 4 * 32) >> 4;
          const int qo = (kk / 4 * L::Q_CHUNK + kk % 4 * 32) >> 4;
          sm90::wgmma_m64n64k16_ss<0, 0>(dp, d_v + kv, d_do + qo, kk > 0);
        }
        sm90::wgmma_commit();
        sm90::bar_arrive(TURN + (cw ^ 1), 2 * 128);   // the other's turn
        sm90::wgmma_wait<0>();
        sm90::reg_fence(s);
        sm90::reg_fence(dp);

        // P^T and dS^T in bf16 (p_ds)
        const bool edge = q0 + BQ > S || k0 + BK > S ||
                          (CAUSAL && q0 < k0 + BK - 1) ||
                          (window > 0 && q0 + BQ - 1 - k0 >= window);
        uint32_t pf[4][4], df[4][4];
        if (cap_in > 0.f)
          p_ds<true, CAUSAL>(s, dp, pf, df, rs, edge, q0, krow, t4, S, window,
                             scale_log2, cap_in, cap_l2);
        else
          p_ds<false, CAUSAL>(s, dp, pf, df, rs, edge, q0, krow, t4, S,
                              window, scale_log2, cap_in, cap_l2);
        // dS^T to shared memory for dQ, in the 128-byte swizzle, once both
        // consumers' dQ of tile nt - 2 has read the buffer: key row r (bits
        // 0-2 of r are g), q columns 8j + 2 t4, 8j + 2 t4 + 1 (the row
        // offset is made here, not hoisted out of the loop: the 16
        // addresses, kept across it, are registers the loop lacks)
        sm90::mbar_wait(&ds_empty[b2], ((nt >> 1) & 1) ^ 1);
        int r0 = (cw * 64 + warp * 16 + g) * 128;
        asm volatile("" : "+r"(r0));
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2) {
          unsigned char* row = dst + r0 + i2 * 8 * 128;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<uint32_t*>(row + ((j ^ g) << 4) + 4 * t4) =
                df[j >> 1][(j & 1) * 2 + i2];
        }
        sm90::fence_proxy_async();
        sm90::mbar_arrive(&ds_full[b2]);

        // dV += P^T dO and dK += dS^T Q (A from registers, dO and Q read
        // MN-major)
        fence_acc(dka);
        fence_acc(dva);
        fence_frags(pf);
        fence_frags(df);
        sm90::wgmma_fence();
        if constexpr (L::CH == 2) {   // both chunks in one n128 product
          const uint64_t n_do = desc_here_mn(dos, L::Q_CHUNK);
          const uint64_t n_q = desc_here_mn(qs, L::Q_CHUNK);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            sm90::wgmma_m64n128k16_rs_tb(as_row(dva), pf[kk],
                                         n_do + (kk * 2048 >> 4));
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            sm90::wgmma_m64n128k16_rs_tb(as_row(dka), df[kk],
                                         n_q + (kk * 2048 >> 4));
        } else {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            sm90::wgmma_m64n64k16_rs_tb(dva[0], pf[kk],
                                        d_do + (kk * 2048 >> 4));
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            sm90::wgmma_m64n64k16_rs_tb(dka[0], df[kk],
                                        d_q + (kk * 2048 >> 4));
        }
        sm90::wgmma_commit();
        if (nt > first) {
          dq_tile(nt - 1);   // the last tile's dQ; waits for dV, dK too
        } else {
          sm90::wgmma_wait<0>();
        }
        fence_acc(dka);
        fence_acc(dva);
        fence_frags(pf);
        fence_frags(df);
        sm90::mbar_arrive(&empty[stage]);   // Q, dO, lse2, D are free
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    dq_tile(nt - 1);   // the item's last tile, while K is still there
    sm90::mbar_arrive(kv_empty);   // K and V are free for the next item

    // dK (scaled) and dV of this consumer's keys below S
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      const int key = krow + 8 * i2;
      if (key >= S) continue;
      bf16* kr = dk + w.b * k_sb + w.kvh * k_sh + key * k_ss;
      bf16* vr = dv + w.b * v_sb + w.kvh * v_sh + key * v_ss;
#pragma unroll
      for (int c = 0; c < L::CH; ++c)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = c * 64 + 8 * j + 2 * t4;
          *reinterpret_cast<uint32_t*>(kr + col) =
              pack_bf16(dka[c][4 * j + 2 * i2] * scale,
                        dka[c][4 * j + 2 * i2 + 1] * scale);
          *reinterpret_cast<uint32_t*>(vr + col) =
              pack_bf16(dva[c][4 * j + 2 * i2], dva[c][4 * j + 2 * i2 + 1]);
        }
    }
  }
}

}  // namespace wg

// -- launch ------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *o, *dout, *lse;
  void *dq, *dk, *dv, *dsum;
  int B, H, rep, S, window;
  float scale, softcap;
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
      a.window, a.scale, slog2, a.softcap);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t q_smem = q_smem_bf16<DH>();
  auto qk = dq_bf16_kernel<DH, CAUSAL>;
  if ((err = allow_smem(qk, q_smem)) != cudaSuccess) return err;
  qk<<<dim3(a.B * a.H, (a.S + 63) / 64), W::THREADS, q_smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.dsum),
      static_cast<bf16*>(a.dq), a.H, a.rep, a.S, a.window, a.scale, slog2,
      a.softcap);
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
      a.window, a.scale, a.softcap);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t q_smem = sizeof(float) * (4 * F_ROWS * LD + F_ROWS * LP);
  auto qk = dq_f32_kernel<DH, CAUSAL>;
  if ((err = allow_smem(qk, q_smem)) != cudaSuccess) return err;
  qk<<<dim3(a.B * a.H, tiles), F_THREADS, q_smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.dsum),
      static_cast<float*>(a.dq), a.H, a.rep, a.S, a.window, a.scale,
      a.softcap);
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
    case 256: return launch<T, 256, CAUSAL>(a, st);
    default: break;
  }
  if constexpr (sizeof(T) == 4) {   // bf16 at 64 and 128 runs on wgmma
    switch (dh) {
      case 64: return launch<T, 64, CAUSAL>(a, st);
      case 128: return launch<T, 128, CAUSAL>(a, st);
      default: break;
    }
  }
  return cudaErrorInvalidValue;
}

template <typename T>
int run(const void* q, const void* k, const void* v, const void* o,
        const void* dout, const void* lse, void* dq, void* dk, void* dv,
        void* dsum, int B, int H, int Hkv, int S, int dh, int causal,
        int scale_dh, int window, double softcap, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || S < 1 || H % Hkv || scale_dh < 1 ||
      scale_dh > dh || window < 0 || !(softcap >= 0.0) ||
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
               static_cast<float>(1.0 / sqrt(static_cast<double>(scale_dh))),
               static_cast<float>(softcap)};
  return static_cast<int>(causal ? dispatch<T, true>(a, dh, st)
                                 : dispatch<T, false>(a, dh, st));
}

// The Hopper path's three launches: preprocess, the main kernel on a
// persistent grid of at most one block per SM, postprocess. p: q, k, v, o,
// dout, lse, dq, dk, dv, the dQ accumulator, the lse2 and D rows, the
// counters; st: the (b, h, s) strides of q, k, v, o, dout, dq, dk, dv.
template <int DH, bool CAUSAL>
cudaError_t launch_wgmma(void* const* p, const long long* st, int B, int H,
                         int Hkv, int S, int scale_dh, int window,
                         double softcap, int n_sm, cudaStream_t stream) {
  CUtensorMap qm, km, vm, dm;
  if (!sm90::encode_heads(&qm, p[0], DH, S, H, B, st[0], st[1], st[2],
                          wg::BQ) ||
      !sm90::encode_heads(&km, p[1], DH, S, Hkv, B, st[3], st[4], st[5],
                          wg::BK) ||
      !sm90::encode_heads(&vm, p[2], DH, S, Hkv, B, st[6], st[7], st[8],
                          wg::BK) ||
      !sm90::encode_heads(&dm, p[4], DH, S, H, B, st[12], st[13], st[14],
                          wg::BQ))
    return cudaErrorInvalidValue;
  const int n_qt = (S + wg::BQ - 1) / wg::BQ, S_pad = n_qt * wg::BQ;
  const long long n_rows = static_cast<long long>(B) * H * S_pad;
  const int n_counts = B * H * n_qt + 1;
  float* lse2 = static_cast<float*>(p[10]);
  float* dsum = lse2 + n_rows;
  int* counts = static_cast<int*>(p[11]);
  wg::pre_kernel<DH><<<static_cast<unsigned>(n_rows * (DH / 8) / 256), 256,
                       0, stream>>>(
      static_cast<const bf16*>(p[3]), st[9], st[10], st[11],
      static_cast<const bf16*>(p[4]), st[12], st[13], st[14],
      static_cast<const float*>(p[5]), lse2, dsum, counts, n_counts, H, S,
      S_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int smem = wg::Layout<DH>::BYTES;
  auto kern = wg::bwd_wgmma_kernel<DH, CAUSAL>;
  static const cudaError_t attr = cudaFuncSetAttribute(   // once per process
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const int n_items = (S + wg::BK - 1) / wg::BK * B * Hkv;
  const double scale = 1.0 / sqrt(static_cast<double>(scale_dh));
  const double cap = softcap;
  kern<<<min(n_sm, n_items), wg::THREADS, smem, stream>>>(
      qm, km, vm, dm, lse2, dsum, static_cast<float*>(p[9]), counts,
      static_cast<bf16*>(p[7]), st[18], st[19], st[20],
      static_cast<bf16*>(p[8]), st[21], st[22], st[23], B, H, Hkv, S, window,
      static_cast<float>(scale), static_cast<float>(scale * LOG2E),
      static_cast<float>(cap > 0.0 ? scale / cap : 0.0),
      static_cast<float>(cap * LOG2E));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const long long n = static_cast<long long>(B) * H * S * (DH / 8);
  wg::post_kernel<DH><<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                        stream>>>(
      static_cast<const float*>(p[9]), static_cast<bf16*>(p[6]), st[15],
      st[16], st[17], H, S, S_pad, n, static_cast<float>(scale));
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory per block: of the Hopper kernel at head dim d 64
// or 128, of the larger of the bf16 dK/dV and dQ kernels at 16, 32 or 256
// (k unused); 0 for another d.
extern "C" int flash_attention_bwd_smem_bytes(int d, int) {
  switch (d) {
    case 16: return static_cast<int>(q_smem_bf16<16>());
    case 32: return static_cast<int>(q_smem_bf16<32>());
    case 64: return wg::Layout<64>::BYTES;
    case 128: return wg::Layout<128>::BYTES;
    case 256: return static_cast<int>(q_smem_bf16<256>());
    default: return 0;
  }
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q/o/dO/dq:[B,H,S,dh], k/v/dk/dv:[B,Hkv,S,dh] contiguous, 16-byte aligned,
// one dtype; lse and dsum (scratch for D) fp32 [B,H,S]; H % Hkv == 0; dh in
// {16, 32, 256} for bf16, {16, 32, 64, 128, 256} for fp32; the softmax
// scale 1/sqrt(scale_dh), 1 <= scale_dh <= dh; window >= 0 (0: none);
// softcap >= 0 (0: none). Launches the three passes on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* dsum, int B, int H, int Hkv, int S, int dh, int causal,
    int scale_dh, int window, double softcap, void* stream) {
  return run<bf16>(q, k, v, o, dout, lse, dq, dk, dv, dsum, B, H, Hkv, S, dh,
                   causal, scale_dh, window, softcap, stream);
}

extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* dsum, int B, int H, int Hkv, int S, int dh, int causal,
    int scale_dh, int window, double softcap, void* stream) {
  return run<float>(q, k, v, o, dout, lse, dq, dk, dv, dsum, B, H, Hkv, S,
                    dh, causal, scale_dh, window, softcap, stream);
}

// The Hopper path, bf16 at dh in {64, 128}, on an sm_90 card only. One
// array of 52 int64 and a double carries the call: a[0..9) the q, k, v,
// o, dout, lse, dq, dk, dv pointers (q/o/dout/dq:[B,H,S,dh],
// k/v/dk/dv:[B,Hkv,S,dh], lse fp32 [B,H,S] contiguous); a[9..12) the
// scratch: the fp32 dQ accumulator [B*H, S_pad, dh], the fp32 lse2 and D
// rows [2, B*H, S_pad] and the int32 counters [B*H*S_pad/64 + 1], S_pad =
// S rounded up to 64, each 16-byte aligned (none needs zeroing);
// a[12..18) B, H, Hkv, S, dh, causal; a[18..50) the element strides (b,
// h, s, d) of q, k, v, o, dout, dq, dk, dv: unit stride in dh, 16-byte
// multiples elsewhere, every base 16-byte aligned, H % Hkv == 0; a[50] the
// head dim whose 1/sqrt scales the logits (1 <= a[50] <= dh); a[51] the
// window (>= 0, 0: none); a[52] the soft cap as a double (>= 0, 0: none);
// or cudaErrorInvalidValue. Returns cudaGetLastError() (0 on success).
extern "C" int flash_attention_bwd_wgmma(const long long* a, void* stream) {
  void* p[12];
  for (int i = 0; i < 12; ++i) p[i] = reinterpret_cast<void*>(a[i]);
  const long long B = a[12], H = a[13], Hkv = a[14], S = a[15], dh = a[16];
  const long long causal = a[17], scale_dh = a[50];
  long long window = a[51];
  double cap;
  memcpy(&cap, a + 52, sizeof(cap));
  if (B < 1 || H < 1 || Hkv < 1 || S < 1 || H % Hkv || S > (1LL << 30) ||
      (dh != 64 && dh != 128) || scale_dh < 1 || scale_dh > dh ||
      window < 0 || !(cap >= 0.0) || B * H * ((S + 63) / 64) + 1 > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (window >= S) window = 0;   // every key of a row in its window
  const long long heads[8] = {H, Hkv, Hkv, H, H, H, Hkv, Hkv};
  const int at[8] = {0, 1, 2, 3, 4, 6, 7, 8};   // their pointers in p
  long long st[24];
  for (int t = 0; t < 8; ++t)
    if (!sm90::head_strides(st + 3 * t, p[at[t]], a + 18 + 4 * t, B,
                            heads[t], S))
      return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 9; i < 12; ++i)
    if (reinterpret_cast<uintptr_t>(p[i]) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
  const int n_sm = sm90::sm90_count();
  if (!n_sm) return static_cast<int>(cudaErrorInvalidDeviceFunction);
  const cudaStream_t sm = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(B), h = static_cast<int>(H),
            hkv = static_cast<int>(Hkv), s = static_cast<int>(S),
            sd = static_cast<int>(scale_dh), w = static_cast<int>(window);
  cudaError_t err;
  if (dh == 64)
    err = causal ? launch_wgmma<64, true>(p, st, b, h, hkv, s, sd, w, cap,
                                          n_sm, sm)
                 : launch_wgmma<64, false>(p, st, b, h, hkv, s, sd, w, cap,
                                           n_sm, sm);
  else
    err = causal ? launch_wgmma<128, true>(p, st, b, h, hkv, s, sd, w, cap,
                                           n_sm, sm)
                 : launch_wgmma<128, false>(p, st, b, h, hkv, s, sd, w, cap,
                                            n_sm, sm);
  return static_cast<int>(err);
}
