// Exact brute-force scan + streaming top-k: kernel D (l2 / dot) of the port,
// one tiled kernel with the metric as a template parameter.
//
// Replaces the TPU kernel repro/kernels/matmul_topk.py (matmul_topk,
// pallas_call at :79).  Kernel E (chi2) has its own design in
// chi2_topk.cu; the two share the merge of row slices (merge_slices.cuh).
//
// Contract (plain version: repro_torch/kernels/ref.py matmul_topk_ref):
//   q (B, d) f32, db (N, d) f32 -> out_d (B, k) f32, out_i (B, k) int32:
//   the k smallest scores in (score, id) order, so ties go to the smaller
//   id; +inf / -1 past N.  l2 is |q|^2 - 2 q.c + |c|^2 (not clamped), with
//   |q|^2 and |c|^2 given as (B,) and (N,) vectors; dot is -q.c.
//
// What bounds it on an H100: operations.  Every (query, row) pair costs d
// multiply-adds (96 GFLOP for 1024 queries against MNIST-784), while the
// rows are read from memory once per query tile.  The products are fp32
// FFMAs, not TF32 or cuBLAS: the reference's products are IEEE fp32.  The
// design: a block takes a tile of 32 queries and one slice of the rows; it
// streams 128-row x 32-column tiles of db (and the matching 32 x 32 query
// tile) through shared memory, and each thread keeps a 4-query x 4-row
// block of sums in registers.  Warp w holds every score of queries 4w ..
// 4w + 3 for the tile, so it merges them into those queries' running top-k
// (shared memory) by itself: it keeps only scores that beat the k-th best,
// and places them by rank.  The (B, N) score matrix is never written.  Row
// slices are sized so that one wave of blocks fills the card; each slice
// leaves a sorted top-k and a second kernel merges the slices of a query,
// one warp per query, one lane per slice.
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

#include "merge_slices.cuh"

#define BQ 32
#define BN 128
#define DK 32
#define THREADS 256
#define WARPS (THREADS / 32)
#define KMAX 128
#define MAX_SLICES 32

enum Metric { L2 = 0, DOT = 1 };

template <int METRIC>
__global__ void __launch_bounds__(THREADS)
    scan_topk_kernel(const float* __restrict__ q, const float* __restrict__ db,
                     const float* __restrict__ q_sq, const float* __restrict__ db_sq,
                     float* __restrict__ part_d, int* __restrict__ part_i, int B, int N,
                     int d, int k, int n_slices, int rows_per_slice, int final_out) {
  __shared__ __align__(16) float qs[DK][BQ + 4];
  __shared__ float cs[DK][BN + 1];
  extern __shared__ __align__(16) float dyn[];
  float* run_d = dyn;                                   // [BQ][k]
  int* run_i = (int*)(run_d + BQ * k);                  // [BQ][k]
  float* nx_d = (float*)(run_i + BQ * k);               // [WARPS][k]
  int* nx_i = (int*)(nx_d + WARPS * k);                 // [WARPS][k]
  float* sv_d = (float*)(nx_i + WARPS * k);             // [WARPS][BN]
  int* sv_i = (int*)(sv_d + WARPS * BN);                // [WARPS][BN]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BQ;
  const int slice = blockIdx.y;
  const int lo = slice * rows_per_slice;
  const int hi = min(N, lo + rows_per_slice);

  for (int r = tid; r < BQ * k; r += THREADS) {  // distinct (+inf, beyond-N) keys
    run_d[r] = INFINITY;
    run_i[r] = N + r % k;
  }
  float my_qsq[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gq = q0 + warp * 4 + i;
    my_qsq[i] = (METRIC == L2 && gq < B) ? q_sq[gq] : 0.f;
  }
  __syncthreads();

  float* wnx_d = nx_d + warp * k;
  int* wnx_i = nx_i + warp * k;
  float* wsv_d = sv_d + warp * BN;
  int* wsv_i = sv_i + warp * BN;

  for (int r0 = lo; r0 < hi; r0 += BN) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += DK) {
      const int c = k0 + lane;
      for (int r = warp; r < BQ; r += WARPS) {
        const int gq = q0 + r;
        qs[lane][r] = (gq < B && c < d) ? __ldg(q + (size_t)gq * d + c) : 0.f;
      }
      for (int r = warp; r < BN; r += WARPS) {
        const int gr = r0 + r;
        cs[lane][r] = (gr < hi && c < d) ? __ldg(db + (size_t)gr * d + c) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < DK; ++kk) {
        const float4 a4 = *reinterpret_cast<const float4*>(&qs[kk][warp * 4]);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
        float bb[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) bb[j] = cs[kk][lane + 32 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * bb[j];
      }
      __syncthreads();
    }

    // ---- warp w merges the tile's scores of its queries 4w .. 4w + 3
    float csq[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gr = r0 + lane + 32 * j;
      csq[j] = (METRIC == L2 && gr < hi) ? db_sq[gr] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = warp * 4 + i;
      if (q0 + qi >= B) break;  // warp-uniform
      float* rd = run_d + qi * k;
      int* ri = run_i + qi * k;
      const float kd = rd[k - 1];
      const int ki = ri[k - 1];
      float s[4];
      int id[4];
      unsigned m[4];
      int ns = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        id[j] = r0 + lane + 32 * j;
        if (METRIC == L2) s[j] = my_qsq[i] - 2.f * acc[i][j] + csq[j];
        else s[j] = -acc[i][j];
        const bool keep = id[j] < hi && lex_less(s[j], id[j], kd, ki);
        m[j] = __ballot_sync(0xffffffffu, keep);
        ns += __popc(m[j]);
      }
      if (ns == 0) continue;  // warp-uniform
      const unsigned below = (1u << lane) - 1u;
      int off = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (m[j] >> lane & 1u) {
          const int pos = off + __popc(m[j] & below);
          wsv_d[pos] = s[j];
          wsv_i[pos] = id[j];
        }
        off += __popc(m[j]);
      }
      __syncwarp();
      // rank of a survivor: running entries below it (the list is sorted:
      // binary search) + survivors below it; of a running entry: its index
      // + survivors below it.  Keys are unique, so the ranks are a
      // permutation and each of the k places fills once.
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

template <int METRIC>
static int launch(const float* q, const float* db, const float* q_sq, const float* db_sq,
                  float* part_d, int* part_i, float* out_d, int* out_i, int B, int N, int d,
                  int k, int max_slices, cudaStream_t stream) {
  auto kernel = scan_topk_kernel<METRIC>;
  const int dyn = (BQ * k + WARPS * k) * 8 + WARPS * BN * 8;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return (int)err;
  // slices: one wave of blocks over the card, at most one per 128-row tile
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
    kernel<<<grid, THREADS, dyn, stream>>>(q, db, q_sq, db_sq, out_d, out_i, B, N, d, k, 1,
                                           rows_per_slice, 1);
    return (int)cudaGetLastError();
  }
  kernel<<<grid, THREADS, dyn, stream>>>(q, db, q_sq, db_sq, part_d, part_i, B, N, d, k, s,
                                         rows_per_slice, 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  merge_slices_kernel<<<(B + WARPS - 1) / WARPS, THREADS, 0, stream>>>(part_d, part_i, out_d,
                                                                      out_i, B, k, s);
  return (int)cudaGetLastError();
}

// part_d / part_i: scratch of (B, max_slices, k) for the slices' lists.
extern "C" int scan_topk(const void* q, const void* db, const void* q_sq, const void* db_sq,
                         void* part_d, void* part_i, void* out_d, void* out_i, int B, int N,
                         int d, int k, int max_slices, int metric, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (k < 1 || k > KMAX || N < 1 || max_slices < 1 || max_slices > MAX_SLICES)
    return (int)cudaErrorInvalidValue;
  const float* qf = (const float*)q;
  const float* dbf = (const float*)db;
  const float* qsq = (const float*)q_sq;
  const float* dsq = (const float*)db_sq;
  float* pd = (float*)part_d;
  int* pi = (int*)part_i;
  float* od = (float*)out_d;
  int* oi = (int*)out_i;
  cudaStream_t s = (cudaStream_t)stream;
  switch (metric) {
    case L2: return launch<L2>(qf, dbf, qsq, dsq, pd, pi, od, oi, B, N, d, k, max_slices, s);
    case DOT: return launch<DOT>(qf, dbf, qsq, dsq, pd, pi, od, oi, B, N, d, k, max_slices, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
