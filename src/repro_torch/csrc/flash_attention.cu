// Attention with an online softmax, causal or not, with grouped-query heads:
// o = softmax(q k^T / sqrt(dh)) v for q:[B,H,S,dh], k/v:[B,Hkv,S,dh]
// (query head h reads KV head h / (H / Hkv)), output in q's dtype. The
// prefill of every layer of the generator (causal) and the forward of the
// embedder and the cross-encoder (not causal).
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
// bf16 tensor peak: so bytes, as long as the products run on the tensor
// cores. In fp32 scalar FMAs the same work would take 0.26 ms.
//
// What the design does about it:
//  * One block of 4 warps per (b*h, 64-row q tile), heaviest causal tiles
//    first; each warp owns 16 query rows. K/V heads are indexed, never
//    repeated in memory, and each block reads its K/V rows once.
//  * bf16: Q, then each 64-row K and V tile, go to shared memory with
//    cp.async (rows padded by 16 bytes, so ldmatrix is free of bank
//    conflicts). S = Q K^T and O += P V run as mma.sync.m16n8k16 with fp32
//    accumulators; P is the fp32 S fragment rounded to bf16 in registers,
//    as the reference rounds its probabilities to q's dtype. The next K
//    tile loads during the softmax and P V, the next V tile during Q K^T.
//  * fp32 (the small shapes of the reference's tests): the same tiling with
//    scalar FMAs, exact fp32 as the TPU kernel computes it.
//  * The logits never reach device memory; the running max and normaliser
//    per row are reduced across the four lanes that share a row with
//    shuffles. Causal blocks stop at the tile holding their last row; only
//    the diagonal tile and the ragged last tile are masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // key/value rows per tile
constexpr int THREADS = 128;    // 4 warps, 16 query rows each
constexpr float LOG2E = 1.4426950408889634f;
constexpr float M_INIT = -1.0e30f;   // running max before any key

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// The same, each matrix transposed on the way to registers.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c[16x8] += a[16x16] b[16x8], bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

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

template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int H,
                  int rep, int S, float scale_log2) {
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

  load_tile<DH>(qs, qg, q0, S, tid);
  load_tile<DH>(ks, kg, 0, S, tid);
  cp_async_commit();
  load_tile<DH>(vs, vg, 0, S, tid);
  cp_async_commit();

  uint32_t qf[DH / 16][4];
  float oacc[DH / 8][4];
#pragma unroll
  for (int dn = 0; dn < DH / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[dn][e] = 0.f;
  float m_r[2] = {M_INIT, M_INIT}, l_r[2] = {0.f, 0.f};
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  for (int j = 0; j < n_kt; ++j) {
    cp_async_wait_1();   // K_j (and Q) landed; V_j may be in flight
    __syncthreads();
    if (j == 0) {
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
    const bool masked = kv0 + BK > S || (CAUSAL && kv0 + BK - 1 > q0);
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
          if (masked && (col >= S || (CAUSAL && col > row[i]))) x = -INFINITY;
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
                 const float* __restrict__ v, float* __restrict__ o, int H,
                 int rep, int S, float scale) {
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

  for (int j = 0; j < n_kt; ++j) {
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
    const bool masked = kv0 + BK > S || (CAUSAL && kv0 + BK - 1 > q0);
    float mx = M_INIT;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int col = kv0 + 2 * i + half;
      if (masked && (col >= S || (CAUSAL && col > qrow))) s[i] = -INFINITY;
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
  }
}

template <typename T, int DH, bool CAUSAL>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int rep, int S, cudaStream_t stream) {
  const double scale = 1.0 / sqrt(static_cast<double>(DH));
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
        static_cast<const bf16*>(v), static_cast<bf16*>(o), H, rep, S,
        static_cast<float>(scale * 1.4426950408889634));
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
        static_cast<const float*>(v), static_cast<float*>(o), H, rep, S,
        static_cast<float>(scale));
  }
  return cudaGetLastError();
}

template <typename T, bool CAUSAL>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int rep, int S, int dh,
                        cudaStream_t st) {
  switch (dh) {
    case 16: return launch<T, 16, CAUSAL>(q, k, v, o, B, H, rep, S, st);
    case 32: return launch<T, 32, CAUSAL>(q, k, v, o, B, H, rep, S, st);
    case 64: return launch<T, 64, CAUSAL>(q, k, v, o, B, H, rep, S, st);
    case 128: return launch<T, 128, CAUSAL>(q, k, v, o, B, H, rep, S, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int run(const void* q, const void* k, const void* v, void* o, int B, int H,
        int Hkv, int S, int dh, int causal, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || S < 1 || H % Hkv ||
      static_cast<long long>(B) * H > 0x7fffffffLL ||
      (S + BQ - 1) / BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rep = H / Hkv;
  return static_cast<int>(
      causal ? dispatch_dh<T, true>(q, k, v, o, B, H, rep, S, dh, st)
             : dispatch_dh<T, false>(q, k, v, o, B, H, rep, S, dh, st));
}

}  // namespace

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q/o:[B,H,S,dh], k/v:[B,Hkv,S,dh], contiguous, 16-byte aligned, bf16 or
// fp32 by the entry point; dh in {16, 32, 64, 128}; H % Hkv == 0. Launches
// on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int B, int H,
                                    int Hkv, int S, int dh, int causal,
                                    void* stream) {
  return run<bf16>(q, k, v, o, B, H, Hkv, S, dh, causal, stream);
}

extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int B, int H,
                                   int Hkv, int S, int dh, int causal,
                                   void* stream) {
  return run<float>(q, k, v, o, B, H, Hkv, S, dh, causal, stream);
}
