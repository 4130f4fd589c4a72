// PQ asymmetric-distance (ADC) scan over the vector DB's packed mirror of
// bucket codes: for each query and each group of its probed buckets, score
// the buckets' ok rows from the query's lookup table and keep the group's
// top-k.
//
// Replaces: src/repro/kernels/fused_retrieve.py, pq_topk_pallas with
// _pq_bucket_kernel, adc_sum and _bucket_topk, the TPU kernel whose grid
// step (i, p) DMAs the p-th probed bucket's [cap_b, m] int32 codes
// (scalar-prefetched probe ids steering the BlockSpec), gathers
// LUT[t, code_t] from query i's VMEM-resident [m, 256] table, sums the m
// values in order, masks with ok and reduces by k rounds of max/argmax.
//
// What bounds it on an H100: a scored row costs m one-byte codes and m
// table lookups for m adds; no multiply. The probed ok rows' code bytes
// (once per bucket, however many queries probe it) bound it against device
// memory; the lookups (nq * probed ok rows * m of them) are dependent
// shared-memory reads at data-chosen banks, the likelier limit in practice.
//
// What the design does about it:
//  * The mirror holds one uint8 per code (core/vectordb.py), a quarter of
//    the reference's int32: a row of m = 48 codes is three 16-byte loads.
//  * One block of 256 threads per (query, group of `group` probes): the
//    block copies the query's [m, 256] fp32 table to shared memory once
//    (48 KB at m = 48) with cp.async, in flight while it reads its buckets'
//    ok bytes, and scores all the group's buckets against it (the TPU
//    kernel loads it once per bucket).
//  * The block first reads the ok bytes of its buckets (16 a load, every
//    load of a thread in flight at once) into one 32-bit mask per 32-row
//    group, and lists the groups that hold an ok row in increasing (probe
//    rank, row): padding past a bucket's fill costs its ok bytes only.
//    Warp w scores listed groups w, w + 8, ..., a lane its own row if ok;
//    the next group's codes are loaded before this group's lookups, so
//    their latency overlaps the adds. Where m % 16 == 0 and m <= 64 a lane
//    holds its row's codes in registers as 16-byte words; otherwise it
//    reads them a byte at a time.
//  * A lane sums LUT[t, code_t] for t = 0 .. m-1 in that order with plain
//    adds, as ref.adc_sum does, so two rows with identical codes score
//    bit-identically and the kernel equals the plain version exactly.
//  * Each warp keeps its own running top-k keyed by pos = probe rank *
//    cap_b + row: its lanes' scores above the list's k-th go to the warp's
//    buffer of 32 (places by popc of a ballot), which merges into the list
//    in one batch when it would overflow (merge_buffer, topk_list.cuh;
//    inserting one at a time left the warp waiting on every insert);
//    the 8 lists merge at the end by (score descending, pos ascending): the
//    order that merge_candidates gives over probe-major candidates, in the
//    JAX package and in the port.
//  * Output [nq, groups, k] scores, slot ids (-1 for padding) and pos, and
//    their merge by (score, pos), the [nq, k] result, by a second kernel
//    launched from the same entry point (merge_lists.cuh).
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "merge_lists.cuh"
#include "topk_list.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KSUB = 256;        // codes per subspace (8-bit PQ)
constexpr int SMEM_MAX = 232448; // shared memory a block may use (bytes)

// The table, the warps' lists and buffers of 32, and the ok masks and item
// list of a probe group's 32-row groups.
size_t smem_bytes(int m, int k, int cap_b, int group) {
  return sizeof(float) * m * KSUB + 8 * WARPS * (k + 32) +
         8 * static_cast<size_t>(group) * ((cap_b + 31) / 32);
}

// One 32-row group of a bucket, as a lane sees it: its row's ok bit, pos
// and, for MV > 0, its m = 16 MV codes.
template <int MV>
struct Rows {
  bool ok;
  int pos;
  long long at;          // packed row
  uint4 v[MV > 0 ? MV : 1];
};

// LUT[0, c[0]] + LUT[1, c[1]] + ... in order t = 0 .. m-1
template <int MV>
__device__ __forceinline__ float adc_row(const float* lt, const Rows<MV>& r,
                                         const uint8_t* __restrict__ codes,
                                         int m) {
  float s = 0.f;
  if constexpr (MV > 0) {
#pragma unroll
    for (int u = 0; u < MV; ++u) {
      const uint32_t w[4] = {r.v[u].x, r.v[u].y, r.v[u].z, r.v[u].w};
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        const int t = 16 * u + b;
        const float x = lt[t * KSUB + ((w[b >> 2] >> (8 * (b & 3))) & 0xff)];
        s = t == 0 ? x : s + x;
      }
    }
  } else {
    const uint8_t* c = codes + r.at * m;
    s = lt[__ldg(c)];
    for (int t = 1; t < m; ++t) s = s + lt[t * KSUB + __ldg(c + t)];
  }
  return s;
}

template <int MV>
__global__ void __launch_bounds__(THREADS)
pq_group_kernel(const float* __restrict__ lut,
                const uint8_t* __restrict__ codes,
                const int* __restrict__ slot, const uint8_t* __restrict__ ok,
                const int* __restrict__ probe, float* __restrict__ out_s,
                int* __restrict__ out_i, int* __restrict__ out_p, int m,
                int cap_b, int nprobe, int group, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_groups = (cap_b + 31) / 32;   // 32-row groups of a bucket
  float* lt = reinterpret_cast<float*>(smem);         // [m][KSUB]
  float* lsb = lt + m * KSUB;                          // [WARPS][k]
  int* lpb = reinterpret_cast<int*>(lsb + WARPS * k);  // [WARPS][k] pos
  float* bsb = reinterpret_cast<float*>(lpb + WARPS * k);   // [WARPS][32]
  int* bpb = reinterpret_cast<int*>(bsb + WARPS * 32);      // [WARPS][32]
  unsigned* masks = reinterpret_cast<unsigned*>(bpb + WARPS * 32);
  int* items = reinterpret_cast<int*>(masks + group * n_groups);
  __shared__ int n_items;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = blockIdx.y;
  const int p0 = blockIdx.x * group;
  const int np = min(group, nprobe - p0);
  const int* pr = probe + static_cast<size_t>(i) * nprobe + p0;

  // the table, in flight while the buckets' ok bytes load
  const float* src = lut + static_cast<size_t>(i) * m * KSUB;
  for (int e = tid; e < m * KSUB / 4; e += THREADS)
    cp_async16(lt + 4 * e, src + 4 * e, true);
  cp_async_commit();
  float* ls = lsb + warp * k;
  int* lp = lpb + warp * k;
  list_clear(ls, lp, k, lane, 32);

  // the ok mask of every 32-row group f = rank * n_groups + group index:
  // 16 ok bytes a load, all of a thread's loads in flight at once, where
  // cap_b % 16 == 0 keeps every bucket's bytes 16-byte aligned; else 32
  // bytes a warp, eight groups in flight
  const int n_all = np * n_groups;
  if (cap_b % 16 == 0) {
    for (int f = tid; f < n_all; f += THREADS) masks[f] = 0;
    __syncthreads();
    const int per16 = cap_b / 16;   // 16-byte words a bucket
    for (int u0 = tid; u0 < np * per16; u0 += THREADS * 4) {
      uint4 v[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int u = u0 + THREADS * x;
        v[x] = u < np * per16
                   ? __ldg(reinterpret_cast<const uint4*>(
                               ok + static_cast<long long>(pr[u / per16]) *
                                        cap_b) +
                           u % per16)
                   : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int u = u0 + THREADS * x;
        if (u >= np * per16) continue;
        const uint32_t w[4] = {v[x].x, v[x].y, v[x].z, v[x].w};
        uint32_t m16 = 0;
#pragma unroll
        for (int b = 0; b < 16; ++b)
          m16 |= static_cast<uint32_t>(((w[b >> 2] >> (8 * (b & 3))) & 0xff)
                                       != 0) << b;
        const int r = u / per16, w16 = u % per16;   // rows 16 w16 ..
        if (m16)
          atomicOr(&masks[r * n_groups + w16 / 2], m16 << (16 * (w16 & 1)));
      }
    }
  } else {
    for (int f0 = warp; f0 < n_all; f0 += WARPS * 8) {
      bool okv[8];
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const int f = f0 + WARPS * x;
        const int row = (f % n_groups) * 32 + lane;
        okv[x] = f < n_all && row < cap_b &&
                 ok[static_cast<long long>(pr[f / n_groups]) * cap_b + row];
      }
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        const unsigned b = __ballot_sync(FULL_MASK, okv[x]);
        if (lane == 0 && f0 + WARPS * x < n_all) masks[f0 + WARPS * x] = b;
      }
    }
  }
  __syncthreads();
  if (warp == 0) {   // the groups holding an ok row, in increasing f
    int cnt = 0;
    for (int f0 = 0; f0 < n_all; f0 += 32) {
      const int f = f0 + lane;
      const bool any = f < n_all && masks[f] != 0;
      const unsigned b = __ballot_sync(FULL_MASK, any);
      if (any) items[cnt + __popc(b & ((1u << lane) - 1))] = f;
      cnt += __popc(b);
    }
    if (lane == 0) n_items = cnt;
  }
  __syncthreads();

  // warp w scores items w, w + WARPS, ...: increasing pos
  const int mine = n_items > warp ? (n_items - warp + WARPS - 1) / WARPS : 0;
  auto load = [&](int it, Rows<MV>& r) {
    const int f = items[warp + WARPS * it];
    const int rank = f / n_groups;
    const int row = (f % n_groups) * 32 + lane;
    r.at = static_cast<long long>(pr[rank]) * cap_b + row;
    r.pos = (p0 + rank) * cap_b + row;
    r.ok = (masks[f] >> lane) & 1;
    if constexpr (MV > 0) {
      const uint4* c = reinterpret_cast<const uint4*>(codes + r.at * m);
#pragma unroll
      for (int u = 0; u < MV; ++u)
        r.v[u] = r.ok ? __ldg(c + u) : make_uint4(0, 0, 0, 0);
    }
  };

  Rows<MV> cur, nxt;
  if (mine > 0) load(0, cur);
  cp_async_wait_0();
  __syncthreads();   // the table

  // the scores above the list's k-th go to the warp's buffer; a buffer
  // that would overflow, and the last one, merge into the list
  float thr = TOPK_NEG;
  int nb = 0;
  float* bs = bsb + warp * 32;
  int* bp = bpb + warp * 32;
  for (int it = 0; it < mine; ++it) {
    if (it + 1 < mine) load(it + 1, nxt);
    const float s = cur.ok ? adc_row<MV>(lt, cur, codes, m) : TOPK_NEG;
    bool pass = cur.ok && s > thr;
    unsigned msk = __ballot_sync(FULL_MASK, pass);
    if (nb + __popc(msk) > 32) {
      thr = merge_buffer<1>(ls, lp, k, bs, bp, nb, lane);
      nb = 0;
      pass = cur.ok && s > thr;
      msk = __ballot_sync(FULL_MASK, pass);
    }
    if (pass) {
      const int at = nb + __popc(msk & ((1u << lane) - 1));
      bs[at] = s;
      bp[at] = cur.pos;
    }
    nb += __popc(msk);
    cur = nxt;
  }
  if (nb > 0) merge_buffer<1>(ls, lp, k, bs, bp, nb, lane);
  __syncthreads();

  if (warp == 0) {   // merge the WARPS lists by (score desc, pos asc)
    const size_t o = (static_cast<size_t>(i) * gridDim.x + blockIdx.x) * k;
    int h = 0;       // lane w < WARPS: next entry of list w
    for (int t = 0; t < k; ++t) {
      float s = TOPK_NEG;
      int pos = INT_MAX, w = lane;
      if (lane < WARPS && h < k) {
        s = lsb[lane * k + h];
        const int pp = lpb[lane * k + h];
        pos = pp < 0 ? INT_MAX : pp;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float s2 = __shfl_xor_sync(FULL_MASK, s, off);
        const int p2 = __shfl_xor_sync(FULL_MASK, pos, off);
        const int w2 = __shfl_xor_sync(FULL_MASK, w, off);
        if (s2 > s || (s2 == s && (p2 < pos || (p2 == pos && w2 < w)))) {
          s = s2;
          pos = p2;
          w = w2;
        }
      }
      if (lane == w) ++h;
      if (lane == 0) {
        const bool real = pos != INT_MAX;
        out_s[o + t] = s;
        out_p[o + t] = real ? pos : -1;
        out_i[o + t] =
            real ? slot[static_cast<long long>(probe[static_cast<size_t>(i) *
                                                         nprobe +
                                                     pos / cap_b]) *
                            cap_b +
                        pos % cap_b]
                 : -1;
      }
    }
  }
}

template <int MV>
cudaError_t launch(const float* lut, const uint8_t* codes, const int* slot,
                   const uint8_t* ok, const int* probe, float* out_s,
                   int* out_i, int* out_p, int nq, int m, int cap_b,
                   int nprobe, int group, int k, cudaStream_t stream) {
  const size_t smem = smem_bytes(m, k, cap_b, group);
  cudaError_t err = cudaFuncSetAttribute(
      pq_group_kernel<MV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((nprobe + group - 1) / group, nq);
  pq_group_kernel<MV><<<grid, THREADS, smem, stream>>>(
      lut, codes, slot, ok, probe, out_s, out_i, out_p, m, cap_b, nprobe,
      group, k);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory per block the launcher requests for m subspaces (d)
// and lists of k, without the 8 bytes per 32-row group of a probe group's
// buckets (4 KB at cap_b = 4096 and 4 probes a group).
extern "C" int pq_topk_smem_bytes(int m, int k) {
  return static_cast<int>(smem_bytes(m, k, 0, 0));
}

extern "C" const char* pq_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// lut:[nq, m, 256] fp32, 16-byte aligned; codes:[nlist*cap_b, m] uint8,
// 16-byte aligned; slot:[nlist*cap_b] int32; ok:[nlist*cap_b] bytes;
// probe:[nq, nprobe] int32 bucket ids, distinct per query;
// out_s/out_i/out_p:[nq, ceil(nprobe / group), k]: group g holds probe
// ranks g*group .. g*group + group - 1, its list's scores, slot ids and
// pos = rank * cap_b + row (-1 for padding); top_s/top_i: [nq, k], their
// merge. Launches both kernels on `stream` and returns cudaGetLastError()
// (0 on success).
extern "C" int pq_topk_u8(const float* lut, const uint8_t* codes,
                          const int* slot, const uint8_t* ok,
                          const int* probe, float* out_s, int* out_i,
                          int* out_p, float* top_s, int* top_i, int nq, int m,
                          int cap_b, int nprobe, int group, int k,
                          void* stream) {
  if (nq < 1 || nq > 65535 || m < 1 || cap_b < 1 || nprobe < 1 ||
      group < 1 || k < 1 || k > TOPK_MAX_K ||
      static_cast<long long>(nprobe) * cap_b > INT_MAX - 1 ||
      smem_bytes(m, k, cap_b, group) > SMEM_MAX ||
      reinterpret_cast<uintptr_t>(codes) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PQ_ARGS lut, codes, slot, ok, probe, out_s, out_i, out_p, nq, m, \
                cap_b, nprobe, group, k, st
  cudaError_t err;
  switch (m % 16 == 0 ? m / 16 : 0) {
    case 1: err = launch<1>(PQ_ARGS); break;
    case 2: err = launch<2>(PQ_ARGS); break;
    case 3: err = launch<3>(PQ_ARGS); break;
    case 4: err = launch<4>(PQ_ARGS); break;
    default: err = launch<0>(PQ_ARGS); break;
  }
#undef PQ_ARGS
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = (nprobe + group - 1) / group;
  return static_cast<int>(merge::launch_merge(out_s, out_i, out_p, top_s,
                                              top_i, nq, groups, k, st));
}
