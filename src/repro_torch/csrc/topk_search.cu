// Exact inner-product top-k over a row-major fp32 corpus: the vector DB's
// flat index, its cold-start scan and its freshness-buffer scan.
//
// Replaces: src/repro/kernels/topk_search.py, topk_search_pallas with
// _topk_tile_kernel, the TPU kernel that scores one (128 x 1024) tile on
// the MXU and reduces it to the tile's top-k by k rounds of max/argmax.
//
// What bounds it on an H100: each live corpus row (4*d bytes) feeds one
// d-long dot product per query. With 64 queries that is 32 FLOP per byte
// of corpus, above the card's 20 (67 TFLOP/s fp32 FMA over 3.35 TB/s), so
// a full batch is bound by the FMA units and a batch of a few queries by
// the corpus bytes. The scores must be exact fp32, so no tensor cores.
//
// What the design does about it:
//  * The FMA loop: 256 threads, each with a 4 x 8 block of scores (4
//    queries x 8 corpus rows) in registers, fed by float4 reads from
//    shared memory (8 FMAs per read; fma_chunk). Depth
//    chunks of DK floats of the query block and of a BN-row sub-tile go to
//    shared memory with 16-byte cp.async loads through a 3-stage ring, so
//    one block barrier per chunk suffices and two chunks' loads overlap
//    the FMAs. Warps whose query rows are all past nq skip the FMAs.
//  * Liveness: the block reads each TILE_N-row tile's liveness bytes
//    first, skips every sub-tile without a live row and never loads a
//    dead row's vector (cp.async with source size 0 writes zeros): a
//    freshness scan over a mostly dead capacity reads the fresh rows only.
//  * Selection in registers, off the FMA units' way: warp w computes every
//    row of queries 8w..8w+7, so a finished sub-tile is folded by the warp
//    that holds it, with no block barrier and without the score tile ever
//    passing through shared memory. Each thread keeps a threshold in
//    registers for each of its 4 query rows and compares its scores
//    against it; a ballot picks the (score, row) pairs above it, which
//    the warp inserts one at a time, in increasing row order, into that
//    query's list in shared memory, refreshing the threshold after each
//    insert. An insert reads the list once, counts its place with ballots
//    and shifts the tail: no reduction by shuffles.
//    Invariant: a thread's threshold is never above its list's k-th
//    score (it is read from the list, whose k-th only rises). A stale
//    threshold only lets extra candidates through, and the insert re-checks
//    them against the list: a candidate enters only if its score is above
//    the k-th, and candidates fold in increasing row order, so equal
//    scores keep the lower row.
//  * Several tiles per block: block b walks tiles b, b + G, b + 2G, ...
//    (G = gridDim.x, two blocks per SM) with one list per query,
//    so a corpus tile adds few inserts once the list is full, the wrapper
//    merges G lists instead of one per tile, and a freshness buffer of
//    consecutive rows still spreads over consecutive blocks.
//  * Output [nq, G, k] per-block lists, each in descending score with the
//    lower row first on ties; the wrapper merges them with one torch.topk
//    over a 64-bit key (the score's order-preserving bits above the row's
//    complement, so no two candidates tie): the order of lax.top_k over
//    the whole score matrix.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "topk_list.cuh"

// acc[i][j] += qb[ty*4+i, :] . cb[tx+16*j, :] over one depth chunk of DK
// floats, both operands in shared memory with row pitch DKP: the 4 x 8
// register block of a 256-thread (16 x 16) block, 8 FMAs per float4 read.
template <int DK, int DKP>
__device__ __forceinline__ void fma_chunk(float (&acc)[4][8], const float* qb,
                                          const float* cb, int tx, int ty) {
#pragma unroll
  for (int kk = 0; kk < DK; kk += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(qb + (ty * 4 + i) * DKP + kk);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 b =
          *reinterpret_cast<const float4*>(cb + (tx + 16 * j) * DKP + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
      }
    }
  }
}

// Called by the whole block. rowok[r] = 1 for each live row of the
// TILE_N-row tile at tile_base; subs[0] = the number of BN-row sub-tiles
// holding a live row, subs[1..] = their indices in order. The caller may
// fill shared memory of its own before the call: the first barrier here
// covers it.
template <int TILE_N, int BN, int THREADS>
__device__ __forceinline__ void live_subtiles(const uint8_t* __restrict__ live,
                                              long long tile_base, int n,
                                              uint8_t* rowok, int* subs,
                                              int tid) {
  constexpr int NSUB = TILE_N / BN;
  for (int r = tid; r < TILE_N; r += THREADS) {
    const long long g = tile_base + r;
    rowok[r] = (g < n && live[g] != 0) ? 1 : 0;
  }
  __syncthreads();
  if (tid < NSUB) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(rowok + tid * BN);
    uint32_t any = 0;
    for (int r = 0; r < BN / 4; ++r) any |= w[r];
    subs[1 + tid] = any != 0;
  }
  __syncthreads();
  if (tid == 0) {   // compact to the list of sub-tiles holding a live row
    int m = 0;
    for (int s = 0; s < NSUB; ++s)
      if (subs[1 + s]) subs[1 + m++] = s;
    subs[0] = m;
  }
  __syncthreads();
}

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BN = 128;          // corpus rows per sub-tile
constexpr int DK = 32;           // depth chunk (floats)
constexpr int DKP = DK + 4;      // chunk row pitch: 16-byte reads stay conflict free
constexpr int STAGES = 3;        // cp.async ring of depth chunks
constexpr int TILE_N = 256;      // corpus rows per tile (round-robin unit)
constexpr int NSUB = TILE_N / BN;
constexpr int THREADS = 256;     // 16 x 16: 4 queries x 8 rows per thread
constexpr int STAGE_FLOATS = (BQ + BN) * DKP;

size_t smem_bytes(int k) {
  return sizeof(float) * STAGES * STAGE_FLOATS +
         (sizeof(float) + sizeof(int)) * BQ * k + TILE_N +
         sizeof(int) * (NSUB + 1);
}

// Insert (s, id) into the list (ls, li) of length k <= TOPK_MAX_K, sorted
// by score descending; all 32 lanes call it with the same (s, id), s above
// the list's k-th. The entries at or above s are a prefix, counted by one
// ballot per 32 entries; the new entry goes after them, so on equal scores
// the earlier entry stays first. Returns the list's new k-th score.
__device__ __forceinline__ float list_insert(float* ls, int* li, int k,
                                             float s, int id, int lane) {
  float v[4];
  int w[4], cnt = 0;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int e = lane + 32 * t;
    const bool in = e < k;
    v[t] = in ? ls[e] : TOPK_NEG;
    w[t] = in ? li[e] : -1;
    if (32 * t < k) cnt += __popc(__ballot_sync(FULL_MASK, in && v[t] >= s));
  }
  // the old entry k - 2 becomes the k-th, unless s lands at k - 1
  const float prev = k >= 2 ? ls[k - 2] : s;
  __syncwarp();
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int e = lane + 32 * t;
    if (e >= cnt && e < k - 1) {
      ls[e + 1] = v[t];
      li[e + 1] = w[t];
    }
  }
  if (lane == 0) {
    ls[cnt] = s;
    li[cnt] = id;
  }
  __syncwarp();
  return cnt >= k - 1 ? s : prev;
}

// Fold one finished sub-tile (scores acc of rows row0 + tx + 16j for the
// thread's queries ty*4 + i) into the warp's lists: per (i, j), a ballot of
// the scores above their query's threshold; the lanes of a half-warp share
// a query, so the set bits of each half, lowest first, are that query's
// candidates in increasing row order.
__device__ __forceinline__ void select_subtile(const float (&acc)[4][8],
                                               float (&thr)[4],
                                               const uint8_t* rowok,
                                               float* lsb, int* lib, int k,
                                               int qbase, int row0, int lane) {
  const int tx = lane & 15, half = lane >> 4;
  bool live[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) live[j] = rowok[tx + 16 * j] != 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      unsigned m = __ballot_sync(FULL_MASK, live[j] && acc[i][j] > thr[i]);
      while (m) {
        const int src = __ffs(m) - 1, h = src >> 4;
        const int qq = qbase + h * 4 + i;   // the half-warp's query
        const float s = __shfl_sync(FULL_MASK, acc[i][j], src);
        const float kth = list_insert(lsb + qq * k, lib + qq * k, k, s,
                                      row0 + 16 * j + (src & 15), lane);
        if (half == h) thr[i] = kth;
        m &= m - 1;
        m &= __ballot_sync(FULL_MASK, live[j] && acc[i][j] > thr[i]);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2)
topk_tile_kernel(const float* __restrict__ q, const float* __restrict__ vecs,
                 const uint8_t* __restrict__ live, float* __restrict__ out_s,
                 int* __restrict__ out_i, int nq, int n, int d, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);   // [STAGES][BQ + BN][DKP]
  float* lsb = ring + STAGES * STAGE_FLOATS;       // [BQ][k] list scores
  int* lib = reinterpret_cast<int*>(lsb + BQ * k);   // [BQ][k] list rows
  uint8_t* rowok = reinterpret_cast<uint8_t*>(lib + BQ * k);  // [TILE_N]
  int* subs = reinterpret_cast<int*>(rowok + TILE_N);  // count, live sub-tiles

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.y * BQ;
  const int n_tiles = (n + TILE_N - 1) / TILE_N;
  const int nchunk = (d + DK - 1) / DK;
  // this warp computes queries 8 warp .. 8 warp + 7 (ty = 2 warp, 2 warp + 1)
  const bool active = q0 + 8 * warp < nq;
  // each list starts at (TOPK_NEG, -1); a query past nq never selects
  float thr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    thr[i] = q0 + ty * 4 + i < nq ? TOPK_NEG : INFINITY;

  list_clear(lsb, lib, BQ * k, tid, THREADS);   // live_subtiles syncs

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long tile_base = static_cast<long long>(tile) * TILE_N;
    live_subtiles<TILE_N, BN, THREADS>(live, tile_base, n, rowok, subs, tid);
    const int nsteps = subs[0] * nchunk;

    // step = (live sub-tile, depth chunk); copies its operands into ring
    // stage step % STAGES
    auto load_step = [&](int step) {
      const int st = subs[1 + step / nchunk];
      const int col0 = (step % nchunk) * DK;
      float* qd = ring + (step % STAGES) * STAGE_FLOATS;
      float* vd = qd + BQ * DKP;
#pragma unroll
      for (int t = 0; t < (BQ * DK / 4) / THREADS; ++t) {
        const int idx = tid + t * THREADS;
        const int row = idx >> 3, col = col0 + (idx & 7) * 4;
        const bool ok = q0 + row < nq && col < d;
        const float* src = ok ? q + static_cast<size_t>(q0 + row) * d + col : q;
        cp_async16(qd + row * DKP + (idx & 7) * 4, src, ok);
      }
#pragma unroll
      for (int t = 0; t < (BN * DK / 4) / THREADS; ++t) {
        const int idx = tid + t * THREADS;
        const int row = idx >> 3, col = col0 + (idx & 7) * 4;
        const bool ok = rowok[st * BN + row] && col < d;
        const float* src =
            ok ? vecs + static_cast<size_t>(tile_base + st * BN + row) * d + col
               : vecs;
        cp_async16(vd + row * DKP + (idx & 7) * 4, src, ok);
      }
    };

    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    // groups committed before step s's wait: steps 0 .. s+1 (empty past
    // the end), so waiting until one is pending means step s has landed
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nsteps) load_step(s);
      cp_async_commit();
    }
    for (int step = 0; step < nsteps; ++step) {
      cp_async_wait_1();
      // every thread has landed its part of step and finished step - 1,
      // whose buffer the load below refills
      __syncthreads();
      if (step + STAGES - 1 < nsteps) load_step(step + STAGES - 1);
      cp_async_commit();
      const float* qd = ring + (step % STAGES) * STAGE_FLOATS;
      if (active) fma_chunk<DK, DKP>(acc, qd, qd + BQ * DKP, tx, ty);
      if (step % nchunk == nchunk - 1) {   // sub-tile finished: select
        const int st = subs[1 + step / nchunk];
        if (active)
          select_subtile(acc, thr, rowok + st * BN, lsb, lib, k, 8 * warp,
                         static_cast<int>(tile_base) + st * BN, lane);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      }
    }
    cp_async_wait_0();
    __syncthreads();   // rowok, subs and the ring are free for the next tile
  }

  // each warp writes the lists of its own queries
  const int G = gridDim.x;
  for (int qq = 8 * warp; qq < 8 * warp + 8 && q0 + qq < nq; ++qq) {
    const size_t o = (static_cast<size_t>(q0 + qq) * G + blockIdx.x) * k;
    for (int e = lane; e < k; e += 32) {
      out_s[o + e] = lsb[qq * k + e];
      out_i[o + e] = lib[qq * k + e];
    }
  }
}

}  // namespace

extern "C" int topk_search_tile_rows() { return TILE_N; }

// Dynamic shared memory per block the launcher requests for lists of k (d unused).
extern "C" int topk_search_smem_bytes(int, int k) {
  return static_cast<int>(smem_bytes(k));
}

extern "C" const char* topk_search_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q:[nq,d] vecs:[n,d] fp32 row-major, 16-byte aligned, d % 4 == 0;
// live:[n] bytes; out_s/out_i:[nq, n_lists, k] with 1 <= n_lists <=
// ceil(n / TILE_N): list b covers tiles b, b + n_lists, ... Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int topk_search_f32(const float* q, const float* vecs,
                               const uint8_t* live, float* out_s, int* out_i,
                               int nq, int n, int d, int k, int n_lists,
                               void* stream) {
  if (nq < 1 || n < 1 || d < 4 || d % 4 != 0 || k < 1 || k > TOPK_MAX_K ||
      n_lists < 1 || n_lists > (n + TILE_N - 1) / TILE_N ||
      (nq + BQ - 1) / BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      topk_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_lists, (nq + BQ - 1) / BQ);
  topk_tile_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      q, vecs, live, out_s, out_i, nq, n, d, k);
  return static_cast<int>(cudaGetLastError());
}
