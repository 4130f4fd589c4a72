// IVF bucket scan over the vector DB's packed mirror, bucket-major: each
// probed bucket is read once per group of up to QG queries that probe it,
// scored against all of them, and reduced to one top-k list per (query,
// probe); the lists merge into each query's top-k in the same entry point.
//
// Replaces: src/repro/kernels/fused_retrieve.py, ivf_topk_pallas with
// _ivf_bucket_kernel and _bucket_topk, the TPU kernel whose grid step
// (i, p) DMAs the p-th probed bucket of query i (scalar-prefetched probe
// ids steering the BlockSpec), scores it against q[i] on the MXU, masks it
// with ok and reduces it by k rounds of max/argmax.
//
// What bounds it on an H100: every scored row is one d-long dot product
// per query that probes its bucket, 2 FLOP per 4 bytes read for a bucket
// probed once, far below the card's 20 FLOP per byte: the bytes of the
// probed buckets' ok rows bound it, each read once however many queries
// probe it. A bucket is sized at 4x the mean fill (cap_b = 4 * capacity /
// nlist), so about three quarters of each packed bucket are padding or
// tombstones. A grid of (query, probe) blocks reads a bucket once per
// query that probes it: at 64 queries x 16 probes of 1,024 lists about
// 650 distinct buckets for 1,024 reads, and on the main path's IVF16 with
// 4-8 probes every bucket is read by a quarter to a half of the batch.
//
// What the design does about it:
//  * probe_kernel selects each query's nprobe lists from its centroid
//    scores (the caller's q @ cent.T) in the plain version's stable order,
//    one block a query (at nprobe <= 128; wider probes come selected).
//  * invert_kernel (one block) turns the probes [nq, nprobe] into
//    per-bucket lists of (query, probe rank) pairs by a counting sort in
//    device memory, and the lists into work items (bucket, up to QG pairs):
//    a bucket probed by more queries splits into several items.
//  * ivf_bucket_kernel, one persistent block per SM: its producer warp
//    takes the next work item (an atomic counter), reads the bucket's ok
//    bytes 16 at a time into one 32-bit mask per 32-row group, and streams
//    the groups that hold an ok row into shared memory through a ring of
//    stages (full/empty mbarriers): lane r copies row r of the group with a
//    1-d bulk copy, only where it is ok, so padding and tombstones cost one
//    byte each. A stage is one group's rows, at most DC columns of them
//    (wider rows take several stages), and a small record of what it holds;
//    an item ends with an end stage, the run with a stop stage. The next
//    item's loads start while the consumers finish the last one.
//  * Each of the QG consumer warps scores the stage's 32 rows against one
//    query of the item: lane l holds the query's columns 4 l + 128 m in
//    registers and reads each row's matching float4s from shared memory
//    (one read a row for 4 exact fp32 FMAs; no TF32: the bytes bound it),
//    and the 32 lanes' partial sums of the 32 rows are reduced by 5
//    halving exchanges (31 shuffles) so that lane r ends with row r's score.
//    Every row's sum is taken in the same order, so equal rows score equal.
//  * Selection from registers: a lane's score above its list's k-th goes
//    to the warp's buffer of 32 (places by a ballot), which merges into the
//    list in one batch when it would overflow (merge_buffer, topk_list.cuh);
//    equal scores keep the lower packed row. At the end stage the warp writes
//    its (query, probe) list to [nq, nprobe, k]: scores, slot ids (-1 for
//    padding) and order = probe rank * cap_b + row.
//  * merge_lists.cuh merges each query's nprobe lists by (score descending,
//    order ascending): equal scores keep the lower probe rank, then the
//    lower row, the order the JAX package's merge_candidates (a stable sort
//    of the probe-major candidates) gives.
#include <climits>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "merge_lists.cuh"
#include "sm90.cuh"
#include "topk_list.cuh"

namespace {

constexpr int QG = 8;                  // queries per work item
constexpr int CONSUMERS = 32 * QG;     // a warp per query
constexpr int THREADS = CONSUMERS + 32;   // and the producer warp
constexpr int DC = 384;                // columns a stage holds at most
constexpr int MAX_STAGES = 8;
constexpr int BUF = 32;                // a warp's candidate buffer
constexpr int BATCH = 8;               // 32-row groups a producer lane
                                       // masks per pass: 8,192 rows a pass
constexpr int INV_THREADS = 1024;
constexpr int SMEM_MAX = 232448;       // shared memory a block may use

// What a stage holds (written by producer lane 0 before its arrival)
constexpr int ROWS = 0, END = 1, STOP = 2;
struct Stage {
  int kind, item, row0, c0, cw, last;   // last: the group's last columns
  unsigned mask;                        // the group's ok rows
  int pad;
};

// Shared memory: the ring [stages][32][cols] fp32 (cols = min(d, DC)),
// the stage records [stages], the warps' lists [QG][k] (scores, rows) and
// buffers [QG][BUF] (scores, rows), the producer's ok masks [32 BATCH],
// the full and empty barriers [stages].
struct Layout {
  int cols, stages, stage_bytes;
  int meta_off, ls_off, li_off, bs_off, bi_off, mask_off, bar_off, bytes;
};

__host__ __device__ inline Layout layout(int d, int k) {
  Layout L;
  L.cols = d < DC ? d : DC;
  L.stage_bytes = 32 * L.cols * 4;
  const int fixed = 16 + 8 * QG * (k + BUF) + 4 * 32 * BATCH;
  L.stages = (SMEM_MAX - fixed) /
             (L.stage_bytes + static_cast<int>(sizeof(Stage)) + 16);
  if (L.stages > MAX_STAGES) L.stages = MAX_STAGES;
  L.meta_off = L.stages * L.stage_bytes;
  L.ls_off = L.meta_off + L.stages * static_cast<int>(sizeof(Stage));
  L.li_off = L.ls_off + 4 * QG * k;
  L.bs_off = L.li_off + 4 * QG * k;
  L.bi_off = L.bs_off + 4 * QG * BUF;
  L.mask_off = L.bi_off + 4 * QG * BUF;
  L.bar_off = L.mask_off + 4 * 32 * BATCH;
  L.bytes = 16 + L.bar_off + 16 * L.stages;
  return L;
}

// Exclusive scan over the block of (a, b) pairs; returns the totals in
// tot. Called by all INV_THREADS threads.
__device__ __forceinline__ void block_scan2(int a, int b, int& ea, int& eb,
                                            int& ta, int& tb) {
  __shared__ int wa[INV_THREADS / 32], wb[INV_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int ia = a, ib = b;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int xa = __shfl_up_sync(FULL_MASK, ia, o);
    const int xb = __shfl_up_sync(FULL_MASK, ib, o);
    if (lane >= o) {
      ia += xa;
      ib += xb;
    }
  }
  if (lane == 31) {
    wa[warp] = ia;
    wb[warp] = ib;
  }
  __syncthreads();
  if (warp == 0) {
    int va = wa[lane], vb = wb[lane];   // INV_THREADS / 32 == 32 warps
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int xa = __shfl_up_sync(FULL_MASK, va, o);
      const int xb = __shfl_up_sync(FULL_MASK, vb, o);
      if (lane >= o) {
        va += xa;
        vb += xb;
      }
    }
    wa[lane] = va;
    wb[lane] = vb;
  }
  __syncthreads();
  ea = ia - a + (warp > 0 ? wa[warp - 1] : 0);
  eb = ib - b + (warp > 0 ? wb[warp - 1] : 0);
  ta = wa[31];
  tb = wb[31];
  __syncthreads();
}

// The probe: the top nprobe <= TOPK_MAX_K of each query's centroid scores
// [nq, nlist] (q @ cent.T, computed by the caller as the plain version
// computes it) by score descending, equal scores by the lower list: the
// order of the plain version's stable sort. One block a query: warp w
// takes the row's 32-column groups w, w + PROBE_WARPS, ..., PROBE_RUN of
// them at a time (all loads in flight at once); its columns above its
// list's k-th score go to a buffer of 32, merged into the warp's list by
// (score, column) when it would overflow (merge_buffer). Warp 0 then
// merges the warps' lists by (score, column). Ids stay in [0, nlist).
constexpr int PROBE_WARPS = 8;
constexpr int PROBE_RUN = 8;

__global__ void __launch_bounds__(32 * PROBE_WARPS)
probe_kernel(const float* __restrict__ scores, int* __restrict__ probe,
             int nlist, int nprobe) {
  extern __shared__ __align__(16) unsigned char psm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x;
  float* lsb = reinterpret_cast<float*>(psm);              // [warps][nprobe]
  int* lib = reinterpret_cast<int*>(lsb + PROBE_WARPS * nprobe);
  float* bs = reinterpret_cast<float*>(lib + PROBE_WARPS * nprobe) +
              32 * warp;                                   // [warps][32]
  int* bi = reinterpret_cast<int*>(bs) + 32 * PROBE_WARPS;
  float* ls = lsb + warp * nprobe;
  int* li = lib + warp * nprobe;
  list_clear(ls, li, nprobe, lane, 32);
  const float* row = scores + static_cast<size_t>(i) * nlist;
  float thr = TOPK_NEG;
  int nb = 0;
  constexpr int STEP = 32 * PROBE_WARPS;   // columns between a warp's groups
  for (int c0 = 32 * warp; c0 < nlist; c0 += STEP * PROBE_RUN) {
    float v[PROBE_RUN];
#pragma unroll
    for (int r = 0; r < PROBE_RUN; ++r) {
      const int c = c0 + STEP * r + lane;
      v[r] = c < nlist ? row[c] : -INFINITY;
    }
#pragma unroll
    for (int r = 0; r < PROBE_RUN; ++r) {
      bool pass = v[r] > thr;
      unsigned m = __ballot_sync(FULL_MASK, pass);
      if (nb + __popc(m) > 32) {
        thr = merge_buffer<1>(ls, li, nprobe, bs, bi, nb, lane);
        nb = 0;
        pass = v[r] > thr;
        m = __ballot_sync(FULL_MASK, pass);
      }
      if (pass) {
        const int at = nb + __popc(m & ((1u << lane) - 1));
        bs[at] = v[r];
        bi[at] = c0 + STEP * r + lane;
      }
      nb += __popc(m);
    }
  }
  if (nb > 0) merge_buffer<1>(ls, li, nprobe, bs, bi, nb, lane);
  __syncthreads();
  if (warp != 0) return;
  // lane w < PROBE_WARPS watches warp w's list; each round takes the best
  // head by (score, column)
  int h = 0;
  for (int t = 0; t < nprobe; ++t) {
    float sv = -INFINITY;
    int col = INT_MAX, w = lane;
    if (lane < PROBE_WARPS && h < nprobe) {
      sv = lsb[lane * nprobe + h];
      const int c = lib[lane * nprobe + h];
      col = c < 0 ? INT_MAX : c;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float s2 = __shfl_xor_sync(FULL_MASK, sv, off);
      const int c2 = __shfl_xor_sync(FULL_MASK, col, off);
      const int w2 = __shfl_xor_sync(FULL_MASK, w, off);
      if (s2 > sv || (s2 == sv && (c2 < col || (c2 == col && w2 < w)))) {
        sv = s2;
        col = c2;
        w = w2;
      }
    }
    if (lane == w) ++h;
    if (lane == 0)
      probe[static_cast<size_t>(i) * nprobe + t] = col == INT_MAX ? 0 : col;
  }
}

// probe [n_pairs] bucket ids (pair e = query e / nprobe, probe rank
// e % nprobe) -> pairs [n_pairs] grouped by bucket, items [<= n_pairs]
// (bucket, first pair, pairs <= QG, 0), ctr[0] = items, ctr[1] = 0 (the
// work counter). cnt and start: [nlist] scratch.
__global__ void __launch_bounds__(INV_THREADS)
invert_kernel(const int* __restrict__ probe, int n_pairs, int nlist,
              int* __restrict__ cnt, int* __restrict__ start,
              int* __restrict__ pairs, int4* __restrict__ items,
              int* __restrict__ ctr) {
  const int tid = threadIdx.x;
  for (int b = tid; b < nlist; b += INV_THREADS) cnt[b] = 0;
  __syncthreads();
  for (int e = tid; e < n_pairs; e += INV_THREADS) atomicAdd(&cnt[probe[e]], 1);
  __syncthreads();
  int base_p = 0, base_i = 0;
  for (int b0 = 0; b0 < nlist; b0 += INV_THREADS) {
    const int b = b0 + tid;
    const int c = b < nlist ? cnt[b] : 0;
    const int ni = (c + QG - 1) / QG;
    int ep, ei, tp, ti;
    block_scan2(c, ni, ep, ei, tp, ti);
    if (b < nlist) {
      start[b] = base_p + ep;
      for (int j = 0; j < ni; ++j)
        items[base_i + ei + j] =
            make_int4(b, base_p + ep + j * QG, min(QG, c - j * QG), 0);
    }
    base_p += tp;
    base_i += ti;
  }
  __syncthreads();
  for (int e = tid; e < n_pairs; e += INV_THREADS)
    pairs[atomicAdd(&start[probe[e]], 1)] = e;
  if (tid == 0) {
    ctr[0] = base_i;
    ctr[1] = 0;
  }
}

// One halving exchange of row_sums at distance O: a lane keeps the O rows
// whose bit O matches its own and adds the partner's partials of them.
template <int O>
__device__ __forceinline__ void halve(float (&p)[32], int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = up ? p[i] : p[i + O];
    const float keep = up ? p[i + O] : p[i];
    p[i] = keep + __shfl_xor_sync(FULL_MASK, send, O);
  }
}

// The 32 lanes' partial sums p[r] of rows r = 0..31 -> row `lane`'s sum
// (returned), by five halving exchanges (31 shuffles). The tree of adds is
// the same for every row.
__device__ __forceinline__ float row_sums(float (&p)[32], int lane) {
  halve<16>(p, lane);
  halve<8>(p, lane);
  halve<4>(p, lane);
  halve<2>(p, lane);
  halve<1>(p, lane);
  return p[0];
}

__global__ void __launch_bounds__(THREADS, 1)
ivf_bucket_kernel(const float* __restrict__ q,
                  const float* __restrict__ packed,
                  const int* __restrict__ slot,
                  const uint8_t* __restrict__ ok,
                  const int* __restrict__ pairs,
                  const int4* __restrict__ items, int* __restrict__ ctr,
                  float* __restrict__ out_s, int* __restrict__ out_i,
                  int* __restrict__ out_p, int d, int cap_b, int nprobe,
                  int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(d, k);
  float* ring = reinterpret_cast<float*>(smem);   // [stages][32][cols]
  Stage* meta = reinterpret_cast<Stage*>(smem + L.meta_off);
  float* lsb = reinterpret_cast<float*>(smem + L.ls_off);   // [QG][k]
  int* lib = reinterpret_cast<int*>(smem + L.li_off);
  float* bsb = reinterpret_cast<float*>(smem + L.bs_off);   // [QG][BUF]
  int* bib = reinterpret_cast<int*>(smem + L.bi_off);
  unsigned* masks = reinterpret_cast<unsigned*>(smem + L.mask_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar_off);
  uint64_t* empty = full + L.stages;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_items = ctr[0];
  const int n_groups = (cap_b + 31) / 32;
  if (tid == 0) {
    for (int s = 0; s < L.stages; ++s) {
      sm90::mbar_init(&full[s], 32);   // the producer warp's lanes
      sm90::mbar_init(&empty[s], QG);  // one arrival per consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp == QG) {   // the producer warp
    int u = 0;        // stages filled
    // the next free stage, its record written by lane 0 (kind, item, ...)
    auto next = [&](Stage rec) {
      const int s = u % L.stages;
      sm90::mbar_wait(&empty[s], ((u / L.stages) & 1) ^ 1);
      if (lane == 0) meta[s] = rec;
      ++u;
      return s;
    };
    for (;;) {
      int w = 0;
      if (lane == 0) w = atomicAdd(&ctr[1], 1);
      w = __shfl_sync(FULL_MASK, w, 0);
      if (w >= n_items) {
        sm90::mbar_arrive(&full[next(Stage{STOP, w, 0, 0, 0, 0, 0u, 0})]);
        return;
      }
      const long long base = static_cast<long long>(items[w].x) * cap_b;
      for (int g0 = 0; g0 < n_groups; g0 += 32 * BATCH) {
        // ok masks of groups g0 + 32 x + lane into masks[32 x + lane], all
        // loads in flight at once
        if (cap_b % 16 == 0) {   // 16 ok bytes a load
          uint4 v[BATCH][2];
#pragma unroll
          for (int x = 0; x < BATCH; ++x) {
            const int g = g0 + 32 * x + lane;
            const uint4* src =
                reinterpret_cast<const uint4*>(ok + base + 32LL * g);
#pragma unroll
            for (int h = 0; h < 2; ++h)
              v[x][h] = g < n_groups && 32 * g + 16 * h < cap_b
                            ? __ldg(src + h)
                            : make_uint4(0, 0, 0, 0);
          }
#pragma unroll
          for (int x = 0; x < BATCH; ++x) {
            unsigned m = 0;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t wd[4] = {v[x][h].x, v[x][h].y, v[x][h].z,
                                      v[x][h].w};
#pragma unroll
              for (int b = 0; b < 16; ++b)
                m |= static_cast<unsigned>(
                         ((wd[b >> 2] >> (8 * (b & 3))) & 0xff) != 0)
                     << (16 * h + b);
            }
            masks[32 * x + lane] = m;
          }
        } else {                 // a byte a lane, one group at a time
          for (int j = 0; j < 32 * BATCH; ++j) {
            const int g = g0 + j, row = 32 * g + lane;
            const unsigned bal = __ballot_sync(
                FULL_MASK, g < n_groups && row < cap_b && ok[base + row]);
            if (lane == 0) masks[j] = bal;
          }
        }
        __syncwarp();
        // the groups holding an ok row, in increasing order
        for (int x = 0; x < BATCH; ++x) {
          const unsigned mine = masks[32 * x + lane];
          unsigned any = __ballot_sync(FULL_MASK, mine != 0);
          while (any) {
            const int src = __ffs(any) - 1;
            any &= any - 1;
            const int g = g0 + 32 * x + src;
            const unsigned mask = __shfl_sync(FULL_MASK, mine, src);
            const float* rowp = packed + (base + 32LL * g + lane) * d;
            for (int c0 = 0; c0 < d; c0 += L.cols) {
              const int cw = min(L.cols, d - c0);
              const int s = next(Stage{ROWS, w, 32 * g, c0, cw,
                                       c0 + cw >= d, mask, 0});
              if ((mask >> lane) & 1) {   // row lane's columns [c0, c0 + cw)
                sm90::mbar_expect_tx(&full[s], 4 * cw);
                sm90::bulk_load(ring + (s * 32 + lane) * L.cols, rowp + c0,
                                4 * cw, &full[s]);
              } else {
                sm90::mbar_arrive(&full[s]);
              }
            }
          }
        }
        __syncwarp();
      }
      sm90::mbar_arrive(&full[next(Stage{END, w, 0, 0, 0, 0, 0u, 0})]);
    }
  }

  // the consumer warps: warp w takes pair w of each item, if there is one
  float* ls = lsb + warp * k;
  int* li = lib + warp * k;
  float* bs = bsb + warp * BUF;
  int* bi = bib + warp * BUF;
  int cur = -1, pair = -1, qc0 = -1;   // qc0: the columns qx holds
  float4 qx[DC / 128];
  long long base = 0;
  float thr = TOPK_NEG;
  int nb = 0;
  float p[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) p[r] = 0.f;
  for (int u = 0;; ++u) {
    const int s = u % L.stages;
    sm90::mbar_wait(&full[s], (u / L.stages) & 1);
    const Stage rec = meta[s];
    if (rec.kind == STOP) return;
    if (rec.item != cur) {   // a new item: this warp's pair and list
      cur = rec.item;
      const int4 it = items[cur];
      pair = warp < it.z ? pairs[it.y + warp] : -1;
      base = static_cast<long long>(it.x) * cap_b;
      qc0 = -1;
      __syncwarp();
      list_clear(ls, li, k, lane, 32);
      __syncwarp();
      thr = TOPK_NEG;
      nb = 0;
    }
    if (rec.kind == ROWS && pair >= 0) {
      // this lane's columns c0 + 4 lane + 128 m of the query (loaded once a
      // chunk: once an item where d <= DC) and of the stage's rows
      if (rec.c0 != qc0) {
        const float* qv = q + static_cast<size_t>(pair / nprobe) * d + rec.c0;
#pragma unroll
        for (int mm = 0; mm < DC / 128; ++mm) {
          const int col = 4 * lane + 128 * mm;
          qx[mm] = col < rec.cw
                       ? __ldg(reinterpret_cast<const float4*>(qv + col))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        qc0 = rec.c0;
      }
      const float* st = ring + s * 32 * L.cols;
#pragma unroll
      for (int mm = 0; mm < DC / 128; ++mm) {
        const int col = 4 * lane + 128 * mm;
        if (col < rec.cw) {
          const float4 x = qx[mm];
#pragma unroll
          for (int r = 0; r < 32; ++r) {
            const float4 y =
                *reinterpret_cast<const float4*>(st + r * L.cols + col);
            p[r] = fmaf(x.w, y.w, fmaf(x.z, y.z, fmaf(x.y, y.y,
                   fmaf(x.x, y.x, p[r]))));
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);   // the stage is read
    if (rec.kind == ROWS && rec.last && pair >= 0) {
      const float sc = row_sums(p, lane);
#pragma unroll
      for (int r = 0; r < 32; ++r) p[r] = 0.f;
      const bool okr = (rec.mask >> lane) & 1;
      bool pass = okr && sc > thr;
      unsigned msk = __ballot_sync(FULL_MASK, pass);
      if (nb + __popc(msk) > BUF) {
        thr = merge_buffer<1>(ls, li, k, bs, bi, nb, lane);
        nb = 0;
        pass = okr && sc > thr;
        msk = __ballot_sync(FULL_MASK, pass);
      }
      if (pass) {
        const int at = nb + __popc(msk & ((1u << lane) - 1));
        bs[at] = sc;
        bi[at] = rec.row0 + lane;
      }
      nb += __popc(msk);
    }
    if (rec.kind == END && pair >= 0) {
      if (nb > 0) merge_buffer<1>(ls, li, k, bs, bi, nb, lane);
      nb = 0;
      const int rank = pair % nprobe;
      const size_t o = static_cast<size_t>(pair) * k;   // [nq, nprobe, k]
      for (int e = lane; e < k; e += 32) {
        const int r = li[e];
        out_s[o + e] = ls[e];
        out_i[o + e] = r < 0 ? -1 : slot[base + r];
        out_p[o + e] = r < 0 ? -1 : rank * cap_b + r;
      }
      cur = -1;   // the next stage starts an item
    }
  }
}

}  // namespace

// Dynamic shared memory per block the launcher requests for rows of d
// floats and lists of k; 0 where not even one ring stage fits (every
// d % 4 == 0 and k <= 128 fits).
extern "C" int ivf_topk_smem_bytes(int d, int k) {
  const Layout L = layout(d, k);
  return L.stages >= 1 ? L.bytes : 0;
}

extern "C" const char* ivf_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Ints of the scratch the entry point takes for nq x nprobe probes of
// nlist buckets.
extern "C" int ivf_topk_scratch_ints(int nq, int nprobe, int nlist) {
  return 5 * nq * nprobe + 2 * nlist + 4;
}

// q:[nq,d] fp32, 16-byte aligned; packed:[nlist*cap_b, d] fp32 row-major,
// 16-byte aligned, d % 4 == 0; slot:[nlist*cap_b] int32; ok:[nlist*cap_b]
// bytes; cscores:[nq, nlist] fp32, the queries' centroid scores, from which
// the probe is selected into probe:[nq, nprobe] int32 (nprobe <= 128), or
// null where probe already holds the bucket ids (in [0, nlist), distinct
// per query); scratch: ivf_topk_scratch_ints(nq, nprobe, nlist) int32,
// 16-byte aligned; out_s/out_i/out_p:[nq, nprobe, k]: each (query, probe)
// list's scores, slot ids and orders (probe rank * cap_b + row; -1 for
// padding); top_s/top_i: [nq, k], their merge; blocks: persistent blocks
// (one per SM). Launches the probe, the inversion, the scan and the merge
// on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int ivf_topk_f32(const float* q, const float* packed,
                            const int* slot, const uint8_t* ok,
                            const float* cscores, int* probe, int* scratch,
                            float* out_s, int* out_i, int* out_p,
                            float* top_s, int* top_i, int nq, int d,
                            int nlist, int cap_b, int nprobe, int k,
                            int blocks, void* stream) {
  if (nq < 1 || d < 4 || d % 4 != 0 || nlist < 1 || cap_b < 1 ||
      nprobe < 1 || nprobe > nlist || k < 1 || k > TOPK_MAX_K ||
      blocks < 1 || (cscores != nullptr && nprobe > TOPK_MAX_K) ||
      static_cast<long long>(nprobe) * cap_b > INT_MAX - 1 ||
      static_cast<long long>(nq) * nprobe * 5 + 2LL * nlist + 4 > INT_MAX ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(packed) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = layout(d, k);
  if (L.stages < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int n_pairs = nq * nprobe;
  int4* items = reinterpret_cast<int4*>(scratch);   // [n_pairs]
  int* pairs = scratch + 4 * n_pairs;               // [n_pairs]
  int* cnt = pairs + n_pairs;                       // [nlist]
  int* start = cnt + nlist;                         // [nlist]
  int* ctr = start + nlist;                         // [4]
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (cscores != nullptr) {
    probe_kernel<<<nq, 32 * PROBE_WARPS, 8 * PROBE_WARPS * (nprobe + 32),
                   st>>>(cscores, probe, nlist, nprobe);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  invert_kernel<<<1, INV_THREADS, 0, st>>>(probe, n_pairs, nlist, cnt, start,
                                           pairs, items, ctr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ivf_bucket_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ivf_bucket_kernel<<<blocks, THREADS, L.bytes, st>>>(
      q, packed, slot, ok, pairs, items, ctr, out_s, out_i, out_p, d, cap_b,
      nprobe, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(merge::launch_merge(out_s, out_i, out_p, top_s,
                                              top_i, nq, nprobe, k, st));
}
