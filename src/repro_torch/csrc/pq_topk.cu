// PQ asymmetric-distance (ADC) scan over the vector DB's packed mirror of
// bucket codes: for each (query, probed bucket) pair, score the bucket's ok
// rows from the query's lookup table and keep the bucket's top-k.
//
// Replaces: src/repro/kernels/fused_retrieve.py, pq_topk_pallas with
// _pq_bucket_kernel, adc_sum and _bucket_topk, the TPU kernel whose grid
// step (i, p) DMAs the p-th probed bucket's [cap_b, m] int32 codes
// (scalar-prefetched probe ids steering the BlockSpec), gathers
// LUT[t, code_t] from query i's VMEM-resident [m, 256] table, sums the m
// values in order, masks with ok and reduces by k rounds of max/argmax.
//
// What bounds it on an H100: a scored row costs m 4-byte code reads and m
// table lookups for m adds; no multiply. The bytes of the probed ok rows'
// codes bound it against device memory, but each lookup is a dependent
// shared-memory read at a data-chosen bank, so the lookups (nq * probed ok
// rows * m of them) are the likelier limit.
//
// What the design does about it:
//  * Grid (nprobe, nq), 256 threads, as ivf_topk.cu; the block reads
//    probe[i, p] itself (in place of the TPU's scalar prefetch) and copies
//    query i's [m, 256] fp32 table to shared memory (48 KB at m = 48, so
//    the dynamic shared memory limit is raised).
//  * Each warp takes 32-row groups of the bucket and reads their 32 ok
//    bytes in one coalesced load; each lane scores its own row only if it
//    is ok, so padding and tombstones cost one byte each. A lane reads its
//    row's codes with 16-byte loads when m % 4 == 0.
//  * A lane sums LUT[t, code_t] for t = 0 .. m-1 in that order with plain
//    adds, as ref.adc_sum does, so two rows with identical codes score
//    bit-identically and the kernel equals the plain version exactly.
//  * Each warp folds its lanes' scores in row order into its own running
//    top-k (topk_list.cuh); the 8 lists merge at the end by (score, row),
//    so equal scores keep the lower packed row, as argmax does on the TPU.
//  * Output [nq, nprobe, k] as slot ids (-1 for padding); the caller
//    merges them with a stable sort.
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_list.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KSUB = 256;        // codes per subspace (8-bit PQ)

size_t smem_bytes(int m, int k) {
  return sizeof(float) * m * KSUB + (sizeof(float) + sizeof(int)) * WARPS * k;
}

// LUT[0, c[0]] + LUT[1, c[1]] + ... in order t = 0 .. m-1
__device__ __forceinline__ float adc_row(const float* lt,
                                         const int* __restrict__ c, int m) {
  float s;
  if ((m & 3) == 0) {
    const int4* c4 = reinterpret_cast<const int4*>(c);
    int4 v = __ldg(c4);
    s = lt[v.x];
    s = s + lt[KSUB + v.y];
    s = s + lt[2 * KSUB + v.z];
    s = s + lt[3 * KSUB + v.w];
    for (int t = 4; t < m; t += 4) {
      v = __ldg(c4 + (t >> 2));
      s = s + lt[t * KSUB + v.x];
      s = s + lt[(t + 1) * KSUB + v.y];
      s = s + lt[(t + 2) * KSUB + v.z];
      s = s + lt[(t + 3) * KSUB + v.w];
    }
  } else {
    s = lt[__ldg(c)];
    for (int t = 1; t < m; ++t) s = s + lt[t * KSUB + __ldg(c + t)];
  }
  return s;
}

__global__ void __launch_bounds__(THREADS)
pq_bucket_kernel(const float* __restrict__ lut,
                 const int* __restrict__ codes, const int* __restrict__ slot,
                 const uint8_t* __restrict__ ok,
                 const int* __restrict__ probe, float* __restrict__ out_s,
                 int* __restrict__ out_i, int m, int cap_b, int nprobe,
                 int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* lt = reinterpret_cast<float*>(smem);         // [m][KSUB]
  float* lsb = lt + m * KSUB;                          // [WARPS][k]
  int* lib = reinterpret_cast<int*>(lsb + WARPS * k);  // [WARPS][k]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = blockIdx.x, i = blockIdx.y;
  const long long base =
      static_cast<long long>(probe[static_cast<size_t>(i) * nprobe + p]) *
      cap_b;
  const float4* src =
      reinterpret_cast<const float4*>(lut + static_cast<size_t>(i) * m * KSUB);
  for (int e = tid; e < m * KSUB / 4; e += THREADS)
    reinterpret_cast<float4*>(lt)[e] = src[e];
  list_clear(lsb, lib, WARPS * k, tid, THREADS);
  __syncthreads();

  float* ls = lsb + warp * k;
  int* li = lib + warp * k;
  float thr = TOPK_NEG;
  for (int g = warp * 32; g < cap_b; g += WARPS * 32) {
    const int r = g + lane;
    const bool okr = r < cap_b && ok[base + r] != 0;
    const float s =
        okr ? adc_row(lt, codes + (base + r) * m, m) : TOPK_NEG;
    unsigned msk = __ballot_sync(FULL_MASK, okr && s > thr);
    while (msk) {
      const int src_lane = __ffs(msk) - 1;
      const float cs = __shfl_sync(FULL_MASK, s, src_lane);
      warp_list_insert(ls, li, k, cs, g + src_lane, lane);
      thr = ls[k - 1];
      msk &= msk - 1;
      msk &= __ballot_sync(FULL_MASK, okr && s > thr);
    }
  }
  __syncthreads();

  if (warp == 0) {   // merge the WARPS lists by (score desc, row asc)
    const size_t o = (static_cast<size_t>(i) * nprobe + p) * k;
    int h = 0;       // lane w < WARPS: next entry of list w
    for (int t = 0; t < k; ++t) {
      float s = TOPK_NEG;
      int row = INT_MAX, w = lane;
      if (lane < WARPS && h < k) {
        s = lsb[lane * k + h];
        const int rr = lib[lane * k + h];
        row = rr < 0 ? INT_MAX : rr;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float s2 = __shfl_xor_sync(FULL_MASK, s, off);
        const int r2 = __shfl_xor_sync(FULL_MASK, row, off);
        const int w2 = __shfl_xor_sync(FULL_MASK, w, off);
        if (s2 > s || (s2 == s && (r2 < row || (r2 == row && w2 < w)))) {
          s = s2;
          row = r2;
          w = w2;
        }
      }
      if (lane == w) ++h;
      if (lane == 0) {
        out_s[o + t] = s;
        out_i[o + t] = row == INT_MAX ? -1 : slot[base + row];
      }
    }
  }
}

}  // namespace

extern "C" const char* pq_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// lut:[nq, m, 256] fp32, 16-byte aligned; codes:[nlist*cap_b, m] int32 in
// [0, 256), 16-byte aligned; slot:[nlist*cap_b] int32;
// ok:[nlist*cap_b] bytes; probe:[nq, nprobe] int32 bucket ids;
// out_s/out_i:[nq, nprobe, k]. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int pq_topk_f32(const float* lut, const int* codes,
                           const int* slot, const uint8_t* ok,
                           const int* probe, float* out_s, int* out_i,
                           int nq, int m, int cap_b, int nprobe, int k,
                           void* stream) {
  if (nq < 1 || nq > 65535 || m < 1 || cap_b < 1 || nprobe < 1 || k < 1 ||
      k > TOPK_MAX_K)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(m, k);
  cudaError_t err = cudaFuncSetAttribute(
      pq_bucket_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nprobe, nq);
  pq_bucket_kernel<<<grid, THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      lut, codes, slot, ok, probe, out_s, out_i, m, cap_b, nprobe, k);
  return static_cast<int>(cudaGetLastError());
}
