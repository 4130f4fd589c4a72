// The large-k path of the DB kernels: the exact top-k of every query's
// candidates when k is above the register and shared-memory lists of
// topk_search.cu, ivf_topk.cu, sq8_topk.cu and pq_topk.cu (TOPK_MAX_K), and
// pq_topk's path for a lookup table larger than shared memory.
//
// Replaces, for those inputs: src/repro/kernels/topk_search.py,
// topk_search_pallas; src/repro/kernels/fused_retrieve.py, ivf_topk_pallas,
// sq8_topk_pallas and pq_topk_pallas (the candidates' scores), and their
// merge_candidates, which pads and takes any k. sq8_topk's scores come from
// quant_score.cu's kernel (the same int8 limb products); the wrapper hands
// them to the selection here.
//
// What bounds it on an H100: the scores (nq x candidates x 4 bytes) are
// written once and read by the selection four or five times: at the flat
// main shape (64 queries, 1,114,112 rows) about 1.4 GB, 0.4 ms at 3.35
// TB/s, beside the corpus's 1.7 GB read and 55 GFLOP of exact fp32 FMAs
// (0.8 ms at 67 TFLOP/s). A simple design that is right comes first:
//  * Scores: the flat scan is a 32-query x 128-row tiled fp32 product
//    (shared memory, 4 x 4 scores a thread); an IVF or PQ probe is one
//    block per (query, probe) that scores the probed bucket's rows, a warp
//    a row (IVF: lanes over the row's columns, the query in shared memory;
//    PQ: a thread a row, the table read from global memory, where it stays
//    L2-resident: 256 KB at m = 256). Dead rows score TOPK_NEG.
//  * Selection, one block per query: every candidate at position p of the
//    query's row (the corpus row; for IVF and PQ, probe rank * cap_b +
//    row in the bucket) has a distinct 64-bit key, the score's
//    order-preserving bits above the complement of p, so a larger key is
//    the earlier entry of lax.top_k's order. An MSB-first radix select
//    over 8-bit digits (warp-aggregated shared-memory histograms) finds
//    the least key prefix whose entries fill exactly k places; it stops at
//    the first digit whose bin is taken whole, so distinct scores end
//    after the four digits of the score. One more pass gathers those k
//    keys, a bitonic sort orders them (in shared memory up to 8,192 keys,
//    in the wrapper's global scratch above that), and the output is
//    (score, id) by rank, (TOPK_NEG, -1) for dead candidates and past the
//    candidates' count.
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_list.cuh"

namespace {

constexpr int SEL_THREADS = 1024;
constexpr int SMEM_SORT_MAX = 8192;   // keys sorted in shared memory (64 KB)
constexpr int FLAT_BQ = 32, FLAT_BN = 128, FLAT_DK = 32;
constexpr int ROW_THREADS = 256;      // IVF / PQ scoring blocks
constexpr int ROWS_PER_BLOCK = 1024;  // bucket rows a scoring block covers

// TOPK_NEG for a dead candidate, else its score
__device__ __forceinline__ float score_at(const float* row, const uint8_t* live,
                                          int p) {
  return live != nullptr && !live[p] ? TOPK_NEG : row[p];
}

__device__ __forceinline__ unsigned long long key_of(float s, int p) {
  int b = s == 0.f ? 0 : __float_as_int(s);   // -0.0 as +0.0
  b ^= (b >> 31) & 0x7FFFFFFF;                // signed int order = float order
  const unsigned hi = static_cast<unsigned>(b) ^ 0x80000000u;
  const unsigned lo = 0xFFFFFFFFu - static_cast<unsigned>(p);
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

// scores[q, n] = q . vecs[n] for the live rows, TOPK_NEG for the others
__global__ void __launch_bounds__(256)
flat_score_kernel(const float* __restrict__ q, const float* __restrict__ vecs,
                  const uint8_t* __restrict__ live, float* __restrict__ out,
                  int nq, int n, int d) {
  __shared__ float qs[FLAT_BQ][FLAT_DK + 1];
  __shared__ float rs[FLAT_BN][FLAT_DK + 1];
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int n0 = blockIdx.x * FLAT_BN, q0 = blockIdx.y * FLAT_BQ;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < d; k0 += FLAT_DK) {
    for (int e = tid; e < FLAT_BQ * FLAT_DK; e += 256) {
      const int r = e / FLAT_DK, c = e % FLAT_DK;
      qs[r][c] = q0 + r < nq && k0 + c < d
                     ? q[static_cast<size_t>(q0 + r) * d + k0 + c] : 0.f;
    }
    for (int e = tid; e < FLAT_BN * FLAT_DK; e += 256) {
      const int r = e / FLAT_DK, c = e % FLAT_DK;
      rs[r][c] = n0 + r < n && k0 + c < d
                     ? vecs[static_cast<size_t>(n0 + r) * d + k0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < FLAT_DK; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[ty * 4 + i][c];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = rs[tx + 32 * j][c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= nq) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = n0 + tx + 32 * j;
      if (r < n)
        out[static_cast<size_t>(qi) * n + r] = live[r] ? acc[i][j] : TOPK_NEG;
    }
  }
}

// scores[q, p * cap_b + r] = q . packed[bucket(q, p) * cap_b + r] where ok
__global__ void __launch_bounds__(ROW_THREADS)
ivf_score_kernel(const float* __restrict__ q, const float* __restrict__ packed,
                 const uint8_t* __restrict__ ok, const int* __restrict__ probes,
                 float* __restrict__ out, int d, int cap_b, int nprobe) {
  extern __shared__ float qrow[];
  const int qp = blockIdx.x, qi = qp / nprobe;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = threadIdx.x; c < d; c += ROW_THREADS)
    qrow[c] = q[static_cast<size_t>(qi) * d + c];
  __syncthreads();
  const size_t base = static_cast<size_t>(probes[qp]) * cap_b;
  const int r_end = min(cap_b, (blockIdx.y + 1) * ROWS_PER_BLOCK);
  for (int r = blockIdx.y * ROWS_PER_BLOCK + warp; r < r_end;
       r += ROW_THREADS / 32) {
    float s = TOPK_NEG;
    if (ok[base + r]) {   // the whole warp
      const float* v = packed + (base + r) * d;
      float acc = 0.f;
      for (int c = lane; c < d; c += 32) acc = fmaf(qrow[c], v[c], acc);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_xor_sync(FULL_MASK, acc, o);
      s = acc;
    }
    if (lane == 0) out[static_cast<size_t>(qp) * cap_b + r] = s;
  }
}

// scores[q, p * cap_b + r] = sum_j lut[q, j, codes[row, j]] where ok, in
// increasing j, row = bucket(q, p) * cap_b + r
__global__ void __launch_bounds__(ROW_THREADS)
pq_score_kernel(const float* __restrict__ lut, const uint8_t* __restrict__ codes,
                const uint8_t* __restrict__ ok, const int* __restrict__ probes,
                float* __restrict__ out, int m, int cap_b, int nprobe) {
  const int qp = blockIdx.x, qi = qp / nprobe;
  const int r = blockIdx.y * ROW_THREADS + threadIdx.x;
  if (r >= cap_b) return;
  const size_t row = static_cast<size_t>(probes[qp]) * cap_b + r;
  float s = TOPK_NEG;
  if (ok[row]) {
    const float* t = lut + static_cast<size_t>(qi) * m * 256;
    const uint8_t* c = codes + row * m;
    s = 0.f;
    for (int j = 0; j < m; ++j) s += t[j * 256 + c[j]];
  }
  out[static_cast<size_t>(qp) * cap_b + r] = s;
}

// The k largest keys of one query's C candidates, sorted, then written out
// as (score, id). live (nullable) masks positions; probes and slot
// (nullable together) map position p to the id slot[probes[q, p / cap_b] *
// cap_b + p % cap_b], else the id is p. buf: [nq, P] global scratch, used
// when P > SMEM_SORT_MAX.
__global__ void __launch_bounds__(SEL_THREADS)
select_kernel(const float* __restrict__ scores, const uint8_t* __restrict__ live,
              const int* __restrict__ probes, const int* __restrict__ slot,
              int cap_b, int nprobe, int C, int k, int P,
              unsigned long long* __restrict__ buf, float* __restrict__ top_s,
              int* __restrict__ top_i) {
  extern __shared__ unsigned long long sorted_smem[];
  __shared__ unsigned hist[256];
  __shared__ unsigned long long s_prefix, s_mask;
  __shared__ int s_remaining, s_done, s_count;
  const int qi = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const float* row = scores + static_cast<size_t>(qi) * C;
  const int kk = min(k, C);
  if (tid == 0) {
    s_prefix = 0;
    s_mask = 0;
    s_remaining = kk;
    s_done = kk == C;   // every candidate is taken
    s_count = 0;
  }
  __syncthreads();
  for (int digit = 7; digit >= 0 && !s_done; --digit) {
    for (int b = tid; b < 256; b += SEL_THREADS) hist[b] = 0;
    __syncthreads();
    const unsigned long long prefix = s_prefix, mask = s_mask;
    const int shift = 8 * digit;
    for (int base = 0; base < C; base += SEL_THREADS) {
      const int p = base + tid;
      int bin = -1;
      if (p < C) {
        const unsigned long long key = key_of(score_at(row, live, p), p);
        if ((key & mask) == prefix) bin = static_cast<int>((key >> shift) & 255);
      }
      const unsigned peers = __match_any_sync(FULL_MASK, bin);
      if (bin >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&hist[bin], static_cast<unsigned>(__popc(peers)));
    }
    __syncthreads();
    if (tid == 0) {
      unsigned above = 0;
      int b = 255;
      for (; b > 0; --b) {
        if (above + hist[b] >= static_cast<unsigned>(s_remaining)) break;
        above += hist[b];
      }
      s_remaining -= static_cast<int>(above);
      s_prefix = prefix | (static_cast<unsigned long long>(b) << shift);
      s_mask = mask | (255ull << shift);
      s_done = hist[b] == static_cast<unsigned>(s_remaining);
    }
    __syncthreads();
  }
  // gather the kk keys whose masked bits are at or above the prefix (with
  // every candidate taken, mask and prefix are 0: all of them)
  unsigned long long* keys =
      P <= SMEM_SORT_MAX ? sorted_smem : buf + static_cast<size_t>(qi) * P;
  const unsigned long long prefix = s_prefix, mask = s_mask;
  for (int base = 0; base < C; base += SEL_THREADS) {
    const int p = base + tid;
    unsigned long long key = 0;
    bool take = false;
    if (p < C) {
      key = key_of(score_at(row, live, p), p);
      take = (key & mask) >= prefix;
    }
    const unsigned ballot = __ballot_sync(FULL_MASK, take);
    int at = 0;
    if (lane == 0 && ballot) at = atomicAdd(&s_count, __popc(ballot));
    at = __shfl_sync(FULL_MASK, at, 0);
    if (take) keys[at + __popc(ballot & ((1u << lane) - 1))] = key;
  }
  for (int e = kk + tid; e < P; e += SEL_THREADS) keys[e] = 0;   // after all
  __syncthreads();
  // bitonic sort, descending
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < P / 2; i += SEL_THREADS) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const unsigned long long a = keys[lo], b = keys[hi];
        const bool down = (lo & size) == 0;   // this run sorts descending
        if (down ? a < b : a > b) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int r = tid; r < k; r += SEL_THREADS) {
    float s = TOPK_NEG;
    int id = -1;
    if (r < kk) {
      const int p = static_cast<int>(0xFFFFFFFFu -
                                     static_cast<unsigned>(keys[r] & 0xFFFFFFFFu));
      const float v = score_at(row, live, p);
      if (v > TOPK_NEG / 2) {
        s = v;
        id = slot == nullptr
                 ? p
                 : slot[static_cast<size_t>(probes[qi * nprobe + p / cap_b]) *
                            cap_b + p % cap_b];
      }
    }
    top_s[static_cast<size_t>(qi) * k + r] = s;
    top_i[static_cast<size_t>(qi) * k + r] = id;
  }
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace

// Dynamic shared memory of the selection at k (the width unused): its
// sort's keys when they fit, else 0 (the sort runs in global scratch).
extern "C" int topk_large_smem_bytes(int, int k) {
  const int P = pow2_at_least(k);
  return P <= SMEM_SORT_MAX ? static_cast<int>(sizeof(unsigned long long)) * P
                            : 0;
}

extern "C" const char* topk_large_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Long longs of global scratch select_f32 needs for nq queries of C
// candidates at k: nq * P (P the least power of two >= min(k, C)) when the
// sort does not fit in shared memory, else 0.
extern "C" long long topk_large_scratch_keys(int nq, int C, int k) {
  const int P = pow2_at_least(k < C ? k : C);
  return P <= SMEM_SORT_MAX ? 0 : static_cast<long long>(nq) * P;
}

// q:[nq,d] vecs:[n,d] fp32, live:[n] uint8 -> scores:[nq,n] fp32.
extern "C" int topk_large_flat_f32(const float* q, const float* vecs,
                                   const uint8_t* live, float* scores, int nq,
                                   int n, int d, void* stream) {
  if (nq < 1 || n < 1 || d < 1 || (nq + FLAT_BQ - 1) / FLAT_BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + FLAT_BN - 1) / FLAT_BN, (nq + FLAT_BQ - 1) / FLAT_BQ);
  flat_score_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      q, vecs, live, scores, nq, n, d);
  return static_cast<int>(cudaGetLastError());
}

// q:[nq,d] packed:[nlist*cap_b,d] fp32, ok:[nlist*cap_b] uint8,
// probes:[nq,nprobe] int32 -> scores:[nq,nprobe*cap_b] fp32.
extern "C" int topk_large_ivf_f32(const float* q, const float* packed,
                                  const uint8_t* ok, const int* probes,
                                  float* scores, int nq, int d, int cap_b,
                                  int nprobe, void* stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(d);
  if (nq < 1 || d < 1 || cap_b < 1 || nprobe < 1 || smem > 227 * 1024 ||
      (cap_b + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ivf_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(nq * nprobe, (cap_b + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  ivf_score_kernel<<<grid, ROW_THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      q, packed, ok, probes, scores, d, cap_b, nprobe);
  return static_cast<int>(cudaGetLastError());
}

// lut:[nq,m,256] fp32, codes:[nlist*cap_b,m] uint8, ok:[nlist*cap_b] uint8,
// probes:[nq,nprobe] int32 -> scores:[nq,nprobe*cap_b] fp32.
extern "C" int topk_large_pq_u8(const float* lut, const uint8_t* codes,
                                const uint8_t* ok, const int* probes,
                                float* scores, int nq, int m, int cap_b,
                                int nprobe, void* stream) {
  if (nq < 1 || m < 1 || cap_b < 1 || nprobe < 1 ||
      (cap_b + ROW_THREADS - 1) / ROW_THREADS > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(nq * nprobe, (cap_b + ROW_THREADS - 1) / ROW_THREADS);
  pq_score_kernel<<<grid, ROW_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      lut, codes, ok, probes, scores, m, cap_b, nprobe);
  return static_cast<int>(cudaGetLastError());
}

// scores:[nq,C] fp32; live:[C] uint8 or null; probes:[nq,nprobe] int32 and
// slot:[rows] int32, both null or both set (then C = nprobe * cap_b);
// keys: topk_large_scratch_keys(nq, C, k) long longs (null when 0) ->
// top_s:[nq,k] fp32, top_i:[nq,k] int32 in lax.top_k's order over the
// candidates' positions, (TOPK_NEG, -1) padded.
extern "C" int topk_large_select_f32(const float* scores, const uint8_t* live,
                                     const int* probes, const int* slot,
                                     unsigned long long* keys, float* top_s,
                                     int* top_i, int nq, int C, int k,
                                     int cap_b, int nprobe, void* stream) {
  if (nq < 1 || C < 1 || k < 1 || ((probes == nullptr) != (slot == nullptr)) ||
      (slot != nullptr && (cap_b < 1 || nprobe < 1 ||
                           static_cast<long long>(cap_b) * nprobe != C)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int P = pow2_at_least(k < C ? k : C);
  if (P > SMEM_SORT_MAX && keys == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      P <= SMEM_SORT_MAX ? sizeof(unsigned long long) * P : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  select_kernel<<<nq, SEL_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      scores, live, probes, slot, cap_b, nprobe, C, k, P, keys, top_s, top_i);
  return static_cast<int>(cudaGetLastError());
}
