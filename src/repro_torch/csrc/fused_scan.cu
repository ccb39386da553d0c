// Kernel B's exact scan at M = N: every query against every row, with the
// gather kernel's per-pair score bit for bit, and a streaming top-k.  It is
// the bruteforce backend's path (index/segments.py brute_force_topk).
//
// Replaces the TPU kernel repro/kernels/fused_query.py (fused_gather_topk,
// pallas_call at :146) where the reference calls it with ids = arange(N)
// for every query (repro/index/segments.py brute_force_topk).
//
// Contract (plain version: repro_torch/kernels/ref.py fused_scan_ref):
//   q (B, d) f32, db (N, d) f32, valid (N,) uint8 or null -> out_d (B, k)
//   f32, out_i (B, k) int32: the k smallest finite scores in (score, id)
//   order, ties to the smaller id (the earliest slot of arange(N)); a dead
//   row (valid 0) loads nothing and takes no place; +inf / -1 past the live
//   rows.  Each (query, row) pair scores the bits fused_query.cu's gather
//   gives it (pair_score.cuh: the same accum<METRIC> terms in the same lane
//   classes, summed in the same tree).  k <= KMAX; a larger k takes rounds,
//   with lo_d / lo_i each query's exclusive lower key (score, id).
//
// What bounds it on an H100: fp32 instruction issues.  Every pair costs d
// terms (l2: an FADD and an FFMA each; 1024 x 60,000 x 784 pairs-elements
// on MNIST-784, 2.9 ms at 33.5e12 issues/s), while the gather kernel re-read
// every row for every query.  The design keeps a tile of queries and a tile
// of rows in shared memory and scores every pair of the two tiles:
//   * A block takes 32 queries (warp w owns queries 4w .. 4w + 3) and one
//     slice of the rows in tiles of 64 (lane l owns rows l and l + 32): 8
//     pairs a thread, each with its running class partial in a register
//     and the five partial sums of its tree beside it.  The tree costs
//     registers the tile cannot spare, so tiles stay small and three blocks
//     share an SM (fewer, larger tiles measured slower on the H100: the
//     scan is bound by latency more than by shared-memory or L2 traffic).
//   * A stage is up to 32 elements of one lane class, for the query tile
//     and the row tile, copied with cp.async (16 bytes a group at W = 4),
//     double buffered; a dead row or one past the slice is zero-filled and
//     never read from memory.  The classes come in bit-reversed order, so
//     after each class's last stage every pair folds its partial into its
//     tree (tree_fold); after class 31 the row tile's scores are complete.
//   * A row is read from memory once per query tile (32 times for 1024
//     queries, mostly from L2), not once per query.
//   * Warp w merges its 4 queries' scores of the tile into their running
//     top-k in shared memory (kernel D's merge: survivors by ballot, placed
//     by rank).  Row slices are sized so that one wave of blocks fills the
//     card; merge_slices_kernel merges their lists.
//   * Cosine's row norms sum(y * y) and query norms come from a pre-pass
//     (scan_norms), in the gather's order; the tile loop adds x * y only.
// Products stay true fp32 FFMAs (no TF32, no tensor cores): the scores must
// equal the gather's.  No (B, N) id matrix, mask or score matrix is built.
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

#include "cp_async.cuh"
#include "merge_slices.cuh"
#include "pair_score.cuh"

#define SQ 4               // queries a thread
#define SR 2               // rows a thread
#define MIN_BLOCKS 3       // blocks an SM: at most 85 registers a thread
#define THREADS 256
#define WARPS (THREADS / 32)
#define BQ (SQ * WARPS)    // queries a tile
#define BN (SR * 32)       // rows a tile
#define DK 32              // elements of a lane class a stage (a multiple of 4)
#define STRIDE (DK + 4)    // floats a staged vector: conflict-free float4 reads
#define KMAX 128
#define MAX_SLICES 32

__device__ __forceinline__ int brev5(int p) { return (int)(__brev((unsigned)p) >> 27); }

// the elements lane class cls holds, W per group over G groups
__device__ __forceinline__ int class_elems(int cls, int G, int W) {
  return cls < G ? W * ((G - cls + 31) / 32) : 0;
}

// one warp a vector: the queries' sqrtf(|x|^2) + EPS and the live rows'
// sum(y * y), in the gather kernel's orders (cosine only)
template <bool VEC4>
__global__ void scan_norms(const float* __restrict__ q, const float* __restrict__ db,
                           const unsigned char* __restrict__ valid, float* __restrict__ q_norm,
                           float* __restrict__ row_sq, int B, int N, int d) {
  const int v = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (v < B) {
    const float s = warp_sum(norm_partial(q + (size_t)v * d, d, lane));
    if (lane == 0) q_norm[v] = sqrtf(s) + EPS;
  } else if (v < B + N && (valid == nullptr || valid[v - B])) {
    const float c = warp_sum(row_sq_partial<VEC4>(db + (size_t)(v - B) * d, d, lane));
    if (lane == 0) row_sq[v - B] = c;
  }
}

// a stage's place in the scan: row tile t, lane class brev5(p), chunk c of
// that class's elements (each class is cut into n_chunks stages)
struct Cursor {
  int t, p, c;
  __device__ __forceinline__ void next(int n_chunks) {
    if (++c < n_chunks) return;
    c = 0;
    if (++p < 32) return;
    p = 0;
    ++t;
  }
};

template <int METRIC, bool VEC4>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    fused_scan_kernel(const float* __restrict__ q, const float* __restrict__ db,
                      const unsigned char* __restrict__ valid,
                      const float* __restrict__ q_norm, const float* __restrict__ row_sq,
                      const float* __restrict__ lo_d, const int* __restrict__ lo_i,
                      float* __restrict__ part_d, int* __restrict__ part_i, int B, int N,
                      int d, int k, int n_slices, int rows_per_slice, int final_out) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                          // [2][BQ][STRIDE]
  float* cs = qs + 2 * BQ * STRIDE;          // [2][BN][STRIDE]
  float* run_d = cs + 2 * BN * STRIDE;       // [BQ][k]
  int* run_i = (int*)(run_d + BQ * k);       // [BQ][k]
  float* nx_d = (float*)(run_i + BQ * k);    // [WARPS][k]
  int* nx_i = (int*)(nx_d + WARPS * k);      // [WARPS][k]
  float* sv_d = (float*)(nx_i + WARPS * k);  // [WARPS][BN]
  int* sv_i = (int*)(sv_d + WARPS * BN);     // [WARPS][BN]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BQ;
  const int slice = blockIdx.y;
  const int lo = slice * rows_per_slice;
  const int hi = min(N, lo + rows_per_slice);
  const int W = VEC4 ? 4 : 1;
  const int G = d / W;
  // stages a class: those of the largest class (class 0); a smaller class
  // leaves its last stages empty
  const int n_chunks = (class_elems(0, G, W) + DK - 1) / DK;
  const int n_steps = (hi - lo + BN - 1) / BN * 32 * n_chunks;
  const float* q_tile = q + (size_t)q0 * d;

  for (int r = tid; r < BQ * k; r += THREADS) {  // distinct (+inf, beyond-N) keys
    run_d[r] = INFINITY;
    run_i[r] = N + r % k;
  }

  // stage at cursor s: elements e0 .. e0 + ne - 1 of lane class brev5(s.p)
  // for the query tile and row tile s.t; element e of class cls is at dim
  // W (cls + 32 (e / W)) + e % W.  A query past B, a row past the slice or
  // a dead row is zero-filled and read from nowhere.
  auto stage = [&](const Cursor& s, int buf) {
    const int cls = brev5(s.p), e0 = s.c * DK;
    const int ne = min(DK, class_elems(cls, G, W) - e0);
    const int r0 = lo + s.t * BN;
    const float* r_tile = db + (size_t)r0 * d;
    float* sq = qs + buf * BQ * STRIDE;
    float* sc = cs + buf * BN * STRIDE;
    const int n_copy = (BQ + BN) * (VEC4 ? ne / 4 : ne);
    for (int x = tid; x < n_copy; x += THREADS) {
      const int v = x % (BQ + BN), e = x / (BQ + BN);  // e: a group at W = 4
      const int dim = VEC4 ? 4 * (cls + 32 * (e0 / 4 + e)) : cls + 32 * (e0 + e);
      const bool is_q = v < BQ;
      const int r = v - BQ;
      const bool ok = is_q ? q0 + v < B
                           : r0 + r < hi && (valid == nullptr || valid[r0 + r]);
      const float* src = is_q ? q_tile + v * d + dim : r_tile + r * d + dim;
      float* dst = (is_q ? sq + v * STRIDE : sc + r * STRIDE) + (VEC4 ? 4 * e : e);
      if (VEC4) cp_async16(dst, ok ? src : db, ok ? 16 : 0);
      else cp_async4(dst, ok ? src : db, ok ? 4 : 0);
    }
    cp_async_commit();
  };

  float acc[SQ][SR], stk[SQ][SR][5];
#pragma unroll
  for (int i = 0; i < SQ; ++i)
#pragma unroll
    for (int j = 0; j < SR; ++j) {
      acc[i][j] = 0.f;
#pragma unroll
      for (int l = 0; l < 5; ++l) stk[i][j][l] = 0.f;
    }
  float dummy = 0.f;  // cosine's sum(y * y) comes from scan_norms

  float* wnx_d = nx_d + warp * k;
  int* wnx_i = nx_i + warp * k;
  float* wsv_d = sv_d + warp * BN;
  int* wsv_i = sv_i + warp * BN;

  Cursor cur = {0, 0, 0}, ahead = {0, 0, 0};
  if (n_steps > 0) {
    stage(ahead, 0);
    ahead.next(n_chunks);
  }
  for (int step = 0; step < n_steps; ++step, cur.next(n_chunks)) {
    const int buf = step & 1;
    if (step + 1 < n_steps) {
      stage(ahead, buf ^ 1);
      ahead.next(n_chunks);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int p = cur.p;
    const int ne = min(DK, class_elems(brev5(p), G, W) - cur.c * DK);
    const float* sq = qs + buf * BQ * STRIDE + warp * SQ * STRIDE;
    const float* sc = cs + buf * BN * STRIDE + lane * STRIDE;
    int e = 0;
    for (; e + 4 <= ne; e += 4) {
      float4 y4[SR];
#pragma unroll
      for (int j = 0; j < SR; ++j)
        y4[j] = *reinterpret_cast<const float4*>(sc + j * 32 * STRIDE + e);
#pragma unroll
      for (int i = 0; i < SQ; ++i) {
        const float4 x4 = *reinterpret_cast<const float4*>(sq + i * STRIDE + e);
#pragma unroll
        for (int j = 0; j < SR; ++j) {
          accum<METRIC>(x4.x, y4[j].x, acc[i][j], dummy);
          accum<METRIC>(x4.y, y4[j].y, acc[i][j], dummy);
          accum<METRIC>(x4.z, y4[j].z, acc[i][j], dummy);
          accum<METRIC>(x4.w, y4[j].w, acc[i][j], dummy);
        }
      }
    }
    for (; e < ne; ++e) {  // W = 1 only: the class's last elements
#pragma unroll
      for (int i = 0; i < SQ; ++i)
#pragma unroll
        for (int j = 0; j < SR; ++j)
          accum<METRIC>(sq[i * STRIDE + e], sc[j * 32 * STRIDE + e], acc[i][j], dummy);
    }
    __syncthreads();  // this buffer is free for step + 2
    if (cur.c != n_chunks - 1) continue;

    // ---- the class is summed: fold it into each pair's tree
#pragma unroll
    for (int i = 0; i < SQ; ++i)
#pragma unroll
      for (int j = 0; j < SR; ++j) acc[i][j] = tree_fold(acc[i][j], stk[i][j], p);
    if (p != 31) {
#pragma unroll
      for (int i = 0; i < SQ; ++i)
#pragma unroll
        for (int j = 0; j < SR; ++j) acc[i][j] = 0.f;
      continue;
    }

    // ---- the row tile is scored: warp w merges its queries SQ w .. SQ w + SQ - 1
    const int r0 = lo + cur.t * BN;
    int id[SR];
    bool live[SR];
    float rsq[SR];
#pragma unroll
    for (int j = 0; j < SR; ++j) {
      id[j] = r0 + lane + 32 * j;
      live[j] = id[j] < hi && (valid == nullptr || valid[id[j]]);
      rsq[j] = (METRIC == COSINE && live[j]) ? row_sq[id[j]] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < SQ; ++i) {
      const int qi = warp * SQ + i, gq = q0 + qi;
      if (gq >= B) break;  // warp-uniform
      float* rd = run_d + qi * k;
      int* ri = run_i + qi * k;
      const float kd = rd[k - 1];
      const int ki = ri[k - 1];
      const bool lower = lo_d != nullptr;
      const float low_d = lower ? lo_d[gq] : 0.f;
      const int low_i = lower ? lo_i[gq] : 0;
      const float qn = METRIC == COSINE ? q_norm[gq] : 0.f;
      float s[SR];
      unsigned m[SR];
      int ns = 0;
#pragma unroll
      for (int j = 0; j < SR; ++j) {
        s[j] = finish<METRIC>(acc[i][j], rsq[j], qn);
        const bool keep = live[j] && isfinite(s[j]) &&
                          (!lower || lex_less(low_d, low_i, s[j], id[j])) &&
                          lex_less(s[j], id[j], kd, ki);
        m[j] = __ballot_sync(0xffffffffu, keep);
        ns += __popc(m[j]);
      }
      if (ns == 0) continue;  // warp-uniform
      const unsigned below = (1u << lane) - 1u;
      int off = 0;
#pragma unroll
      for (int j = 0; j < SR; ++j) {
        if (m[j] >> lane & 1u) {
          const int pos = off + __popc(m[j] & below);
          wsv_d[pos] = s[j];
          wsv_i[pos] = id[j];
        }
        off += __popc(m[j]);
      }
      __syncwarp();
      // rank of a survivor: running entries below it (binary search of the
      // sorted list) + survivors below it; of a running entry: its index +
      // survivors below it.  Keys are unique, so each place fills once.
      for (int t = lane; t < ns; t += 32) {
        const float sd = wsv_d[t];
        const int si = wsv_i[t];
        int a = 0, b = k;
        while (a < b) {
          const int mid = (a + b) >> 1;
          if (lex_less(rd[mid], ri[mid], sd, si)) a = mid + 1;
          else b = mid;
        }
        int rank = a;
        for (int u = 0; u < ns; ++u) rank += lex_less(wsv_d[u], wsv_i[u], sd, si);
        if (rank < k) {
          wnx_d[rank] = sd;
          wnx_i[rank] = si;
        }
      }
      for (int r = lane; r < k; r += 32) {
        const float sd = rd[r];
        const int si = ri[r];
        int rank = r;
        for (int u = 0; u < ns; ++u) rank += lex_less(wsv_d[u], wsv_i[u], sd, si);
        if (rank < k) {
          wnx_d[rank] = sd;
          wnx_i[rank] = si;
        }
      }
      __syncwarp();
      for (int r = lane; r < k; r += 32) {
        rd[r] = wnx_d[r];
        ri[r] = wnx_i[r];
      }
      __syncwarp();
    }
#pragma unroll
    for (int i = 0; i < SQ; ++i)
#pragma unroll
      for (int j = 0; j < SR; ++j) acc[i][j] = 0.f;
  }
  __syncthreads();

  for (int t = tid; t < BQ * k; t += THREADS) {
    const int qi = t / k, r = t % k;
    const int gq = q0 + qi;
    if (gq >= B) continue;
    const float sd = run_d[t];
    if (final_out) {
      part_d[(size_t)gq * k + r] = sd;
      part_i[(size_t)gq * k + r] = isinf(sd) ? -1 : run_i[t];
    } else {
      const size_t o = ((size_t)gq * n_slices + slice) * k + r;
      part_d[o] = sd;
      part_i[o] = run_i[t];
    }
  }
}

template <int METRIC, bool VEC4>
static int launch(const float* q, const float* db, const unsigned char* valid, float* q_norm,
                  float* row_sq, const float* lo_d, const int* lo_i, float* part_d, int* part_i,
                  float* out_d, int* out_i, int B, int N, int d, int k, int max_slices,
                  cudaStream_t stream) {
  cudaError_t err;
  if (METRIC == COSINE) {
    const int vecs = B + N, per_block = THREADS / 32;
    scan_norms<VEC4><<<(vecs + per_block - 1) / per_block, THREADS, 0, stream>>>(
        q, db, valid, q_norm, row_sq, B, N, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  auto kernel = fused_scan_kernel<METRIC, VEC4>;
  const int dyn = 2 * (BQ + BN) * STRIDE * 4 + (BQ * k + WARPS * k) * 8 + WARPS * BN * 8;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return (int)err;
  // slices: one wave of blocks over the card, at most one per row tile
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, dyn);
  if (err != cudaSuccess) return (int)err;
  const int q_tiles = (B + BQ - 1) / BQ;
  const int row_tiles = (N + BN - 1) / BN;
  int s = std::max(1, per_sm * n_sm / q_tiles);
  s = std::min(std::min(s, max_slices), row_tiles);
  const int tiles_per_slice = (row_tiles + s - 1) / s;
  const int rows_per_slice = tiles_per_slice * BN;
  s = (row_tiles + tiles_per_slice - 1) / tiles_per_slice;  // no empty slice
  const dim3 grid(q_tiles, s);
  if (s == 1) {
    kernel<<<grid, THREADS, dyn, stream>>>(q, db, valid, q_norm, row_sq, lo_d, lo_i, out_d,
                                           out_i, B, N, d, k, 1, rows_per_slice, 1);
    return (int)cudaGetLastError();
  }
  kernel<<<grid, THREADS, dyn, stream>>>(q, db, valid, q_norm, row_sq, lo_d, lo_i, part_d,
                                         part_i, B, N, d, k, s, rows_per_slice, 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  merge_slices_kernel<<<(B + WARPS - 1) / WARPS, THREADS, 0, stream>>>(part_d, part_i, out_d,
                                                                      out_i, B, k, s);
  return (int)cudaGetLastError();
}

template <int METRIC>
static int launch_metric(const float* q, const float* db, const unsigned char* valid,
                         float* q_norm, float* row_sq, const float* lo_d, const int* lo_i,
                         float* part_d, int* part_i, float* out_d, int* out_i, int B, int N,
                         int d, int k, int max_slices, cudaStream_t s) {
  if (d % 4 == 0)
    return launch<METRIC, true>(q, db, valid, q_norm, row_sq, lo_d, lo_i, part_d, part_i,
                                out_d, out_i, B, N, d, k, max_slices, s);
  return launch<METRIC, false>(q, db, valid, q_norm, row_sq, lo_d, lo_i, part_d, part_i, out_d,
                               out_i, B, N, d, k, max_slices, s);
}

// valid (N,) uint8 may be null (every row live); q_norm (B,) and row_sq (N,)
// are scratch for cosine (unread otherwise); lo_d / lo_i (B,) may be null
// (no lower key); part_d / part_i: scratch of (B, max_slices, k).
extern "C" int fused_scan(const void* q, const void* db, const void* valid, void* q_norm,
                          void* row_sq, const void* lo_d, const void* lo_i, void* part_d,
                          void* part_i, void* out_d, void* out_i, int B, int N, int d, int k,
                          int max_slices, int metric, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (k < 1 || k > KMAX || N < 1 || d < 1 || max_slices < 1 || max_slices > MAX_SLICES)
    return (int)cudaErrorInvalidValue;
  const float* qf = (const float*)q;
  const float* dbf = (const float*)db;
  const unsigned char* vv = (const unsigned char*)valid;
  float* qn = (float*)q_norm;
  float* rs = (float*)row_sq;
  const float* ld = (const float*)lo_d;
  const int* li = (const int*)lo_i;
  float* pd = (float*)part_d;
  int* pi = (int*)part_i;
  float* od = (float*)out_d;
  int* oi = (int*)out_i;
  cudaStream_t s = (cudaStream_t)stream;
  switch (metric) {
    case L2:
      return launch_metric<L2>(qf, dbf, vv, qn, rs, ld, li, pd, pi, od, oi, B, N, d, k,
                               max_slices, s);
    case DOT:
      return launch_metric<DOT>(qf, dbf, vv, qn, rs, ld, li, pd, pi, od, oi, B, N, d, k,
                                max_slices, s);
    case CHI2:
      return launch_metric<CHI2>(qf, dbf, vv, qn, rs, ld, li, pd, pi, od, oi, B, N, d, k,
                                 max_slices, s);
    case COSINE:
      return launch_metric<COSINE>(qf, dbf, vv, qn, rs, ld, li, pd, pi, od, oi, B, N, d, k,
                                   max_slices, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
