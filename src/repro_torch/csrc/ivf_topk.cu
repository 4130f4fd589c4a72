// IVF bucket scan over the vector DB's packed mirror: for each (query,
// probed bucket) pair, score the bucket's live rows and keep its top-k.
//
// Replaces: src/repro/kernels/fused_retrieve.py, ivf_topk_pallas with
// _ivf_bucket_kernel and _bucket_topk, the TPU kernel whose grid step
// (i, p) DMAs the p-th probed bucket of query i (scalar-prefetched probe
// ids steering the BlockSpec), scores it against q[i] on the MXU, masks it
// with ok and reduces it by k rounds of max/argmax.
//
// What bounds it on an H100: every scored row is one d-long dot product
// against a single query, 2 FLOP per 4 bytes read, far below the card's 20
// FLOP per byte: the bytes of the probed rows bound it. A bucket is sized
// at 4x the mean fill (cap_b = 4 * capacity / nlist), so about three
// quarters of each packed bucket are padding or tombstones.
//
// What the design does about it:
//  * Grid (nprobe, nq), 256 threads; the block reads probe[i, p] itself
//    (in place of the TPU's scalar prefetch) and copies q[i] to shared
//    memory.
//  * Each warp takes 32-row groups of the bucket, reads their 32 ok bytes
//    in one coalesced load and loads only the vectors of ok rows, so the
//    padding and tombstones cost one byte each, not 4*d. A row's vector is
//    read with 16-byte loads spread over the warp, two rows in flight.
//  * Each warp keeps its own running top-k in shared memory
//    (topk_list.cuh); the 8 lists merge at the end by (score, row), so
//    equal scores keep the lower packed row, as argmax does on the TPU.
//  * Output [nq, nprobe, k] as slot ids (-1 for padding); the caller
//    merges them with a stable sort.
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_list.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

size_t smem_bytes(int d, int k) {
  return sizeof(float) * d + (sizeof(float) + sizeof(int)) * WARPS * k;
}

__device__ __forceinline__ float warp_allsum(float v) {
  // xor butterfly: every lane ends with the same bits (a + b == b + a)
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

__global__ void __launch_bounds__(THREADS)
ivf_bucket_kernel(const float* __restrict__ q,
                  const float* __restrict__ packed,
                  const int* __restrict__ slot,
                  const uint8_t* __restrict__ ok,
                  const int* __restrict__ probe, float* __restrict__ out_s,
                  int* __restrict__ out_i, int d, int cap_b, int nprobe,
                  int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qv = reinterpret_cast<float*>(smem);        // [d]
  float* lsb = qv + d;                                // [WARPS][k]
  int* lib = reinterpret_cast<int*>(lsb + WARPS * k); // [WARPS][k]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = blockIdx.x, i = blockIdx.y;
  const long long base =
      static_cast<long long>(probe[static_cast<size_t>(i) * nprobe + p]) *
      cap_b;
  for (int e = tid; e < d; e += THREADS)
    qv[e] = q[static_cast<size_t>(i) * d + e];
  list_clear(lsb, lib, WARPS * k, tid, THREADS);
  __syncthreads();

  float* ls = lsb + warp * k;
  int* li = lib + warp * k;
  float thr = TOPK_NEG;
  const int d4 = d >> 2;
  const float4* q4 = reinterpret_cast<const float4*>(qv);
  for (int g = warp * 32; g < cap_b; g += WARPS * 32) {
    const int r = g + lane;
    unsigned m = __ballot_sync(FULL_MASK, r < cap_b && ok[base + r] != 0);
    while (m) {
      const int j1 = __ffs(m) - 1;
      m &= m - 1;
      const int j2 = m ? __ffs(m) - 1 : -1;
      if (m) m &= m - 1;
      const float4* v1 =
          reinterpret_cast<const float4*>(packed + (base + g + j1) * d);
      const float4* v2 = reinterpret_cast<const float4*>(
          packed + (base + g + (j2 >= 0 ? j2 : j1)) * d);
      float a1 = 0.f, a2 = 0.f;
      for (int f = lane; f < d4; f += 32) {
        const float4 x = q4[f];
        const float4 u = v1[f];
        a1 = fmaf(x.x, u.x, a1);
        a1 = fmaf(x.y, u.y, a1);
        a1 = fmaf(x.z, u.z, a1);
        a1 = fmaf(x.w, u.w, a1);
        if (j2 >= 0) {
          const float4 w = v2[f];
          a2 = fmaf(x.x, w.x, a2);
          a2 = fmaf(x.y, w.y, a2);
          a2 = fmaf(x.z, w.z, a2);
          a2 = fmaf(x.w, w.w, a2);
        }
      }
      a1 = warp_allsum(a1);
      a2 = warp_allsum(a2);
      if (a1 > thr) {
        warp_list_insert(ls, li, k, a1, g + j1, lane);
        thr = ls[k - 1];
      }
      if (j2 >= 0 && a2 > thr) {
        warp_list_insert(ls, li, k, a2, g + j2, lane);
        thr = ls[k - 1];
      }
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

// Dynamic shared memory per block the launcher requests for rows of d floats
// and lists of k.
extern "C" int ivf_topk_smem_bytes(int d, int k) {
  return static_cast<int>(smem_bytes(d, k));
}

extern "C" const char* ivf_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q:[nq,d] fp32; packed:[nlist*cap_b, d] fp32 row-major, 16-byte aligned,
// d % 4 == 0; slot:[nlist*cap_b] int32; ok:[nlist*cap_b] bytes;
// probe:[nq, nprobe] int32 bucket ids; out_s/out_i:[nq, nprobe, k].
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int ivf_topk_f32(const float* q, const float* packed,
                            const int* slot, const uint8_t* ok,
                            const int* probe, float* out_s, int* out_i,
                            int nq, int d, int cap_b, int nprobe, int k,
                            void* stream) {
  if (nq < 1 || nq > 65535 || d < 4 || d % 4 != 0 || cap_b < 1 ||
      nprobe < 1 || k < 1 || k > TOPK_MAX_K)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(d, k);
  cudaError_t err = cudaFuncSetAttribute(
      ivf_bucket_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nprobe, nq);
  ivf_bucket_kernel<<<grid, THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      q, packed, slot, ok, probe, out_s, out_i, d, cap_b, nprobe, k);
  return static_cast<int>(cudaGetLastError());
}
