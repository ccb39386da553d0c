// Exact brute-force chi-square scan + streaming top-k: kernel E of the port.
//
// Replaces the TPU kernel repro/kernels/chi2_topk.py (chi2_topk,
// pallas_call at :69), reached through ops.topk(..., "chi2").
//
// Contract (plain versions: repro_torch/kernels/ref.py chi2_topk_ref, and
// chi2_topk_dordered, which sums in this kernel's order):
//   q (B, d) f32, db (N, d) f32 -> out_d (B, k) f32, out_i (B, k) int32:
//   the k smallest sum_d (q - c)^2 / (q + c + 1e-12) in (score, id) order,
//   so ties go to the smaller id; +inf / -1 past N and for +inf scores.
//   Each term is t = q - c; t * t / ((q + c) + 1e-12) with IEEE division
//   (no fast math), and a pair's terms are added in d order, so the scores
//   are bitwise those of a d-ordered fp32 sum.
//
// What bounds it on an H100: operations.  Every (query, row) pair costs d
// terms (1.5e11 against ISS-595 at 1024 queries), each a full IEEE
// division (about 12 fp32 issues and one MUFU.RCP).  But the histograms are
// sparse (about 84% of ISS-595's elements are 0), and where the row element
// c is +0 or -0 the term is q * q / (q + 1e-12) bit for bit, for every
// float q (t = q - c and (q + c) + 1e-12 round to q's own values).  The
// design makes that case cost one FADD: lanes vary over queries and the
// row element is the operand the whole warp shares, so a zero c is a branch
// that is uniform across the warp.
//
//   * A pre-pass (chi2_stage_queries) writes each 128-query tile transposed,
//     qt[tile][kk][p], and beside it tt = q * q / (q + 1e-12), zero past B
//     and past d (padded to a multiple of 32).
//   * A block takes one query tile (lane l owns queries 4l .. 4l + 3) and
//     one slice of the rows, in tiles of 64 rows (warp w owns rows 8w ..
//     8w + 7): a 4 x 8 register block of sums a thread.  32-dim chunks of
//     the query tile, of tt and of the row tile are staged in shared memory
//     with cp.async, double buffered, the next chunk in flight while this
//     one computes.  For each (kk, row) the warp reads c by broadcast: if c
//     is 0 it adds tt (4 FADDs), else it computes the 4 full terms.  A
//     warp first votes on its rows' chunk: where no element is 0 (dense
//     data) it takes a copy of the loop with no test between the terms,
//     so the divisions of a whole unrolled step schedule together; the
//     terms and their order are the same on both copies.
//   * Top-k: a query's scores for a row tile lie in 8 threads (one lane of
//     each warp), so each query keeps a sorted running top-k in shared
//     memory, and after a row tile each thread tests its 32 scores against
//     its queries' k-th best, read once per tile.  Few pass after the first
//     tiles; when any thread of the block has one, the warps take turns and
//     each lane inserts its own queries' survivors (a lane owns distinct
//     queries, so no two lanes touch one list).
//   * Row slices are sized so that one wave of blocks fills the card; each
//     slice leaves a sorted top-k and merge_slices_kernel merges them.
// The (B, N) score matrix is never written.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "merge_slices.cuh"

#define BQ 128          // queries a tile: 4 a lane
#define BN 64           // rows a tile: 8 a warp
#define DK 32           // dims a stage
#define QR 4            // queries a thread
#define RR 8            // rows a thread
#define THREADS 256
#define WARPS (THREADS / 32)
#define CS_STRIDE (BN + 4)
#define KMAX 128
#define MAX_SLICES 32
#define EPS 1e-12f

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// 4 bytes from src, or zeros where `bytes` is 0 (nothing is read then)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// one term, with IEEE division: t = a - c; t * t / ((a + c) + EPS)
__device__ __forceinline__ float chi2_term(float a, float c) {
  const float t = a - c;
  return t * t / (a + c + EPS);
}

// qt / tt (q_tiles, d_pad, BQ): query p of tile t at dim kk, and its term
// against a zero row element
__global__ void chi2_stage_queries(const float* __restrict__ q, float* __restrict__ qt,
                                   float* __restrict__ tt, int B, int d, int d_pad,
                                   size_t n) {
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const int p = (int)(e % BQ);
    const int kk = (int)(e / BQ % d_pad);
    const int gq = (int)(e / ((size_t)BQ * d_pad)) * BQ + p;
    const float v = gq < B && kk < d ? q[(size_t)gq * d + kk] : 0.f;
    qt[e] = v;
    tt[e] = v * v / (v + EPS);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
    chi2_scan_kernel(const float* __restrict__ qt, const float* __restrict__ tt,
                     const float* __restrict__ db, float* __restrict__ part_d,
                     int* __restrict__ part_i, int B, int N, int d, int d_pad, int k,
                     int n_slices, int rows_per_slice, int final_out) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                          // [2][DK][BQ]
  float* ts = qs + 2 * DK * BQ;              // [2][DK][BQ]
  float* cs = ts + 2 * DK * BQ;              // [2][DK][CS_STRIDE]
  float* run_d = cs + 2 * DK * CS_STRIDE;    // [k][BQ]: rank r of slot p
  int* run_i = (int*)(run_d + k * BQ);       // [k][BQ]
  // slot p = i * 32 + l holds query 4l + i of the tile (conflict-free)

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int tile_q = blockIdx.x;
  const int q0 = tile_q * BQ;
  const int slice = blockIdx.y;
  const int lo = slice * rows_per_slice;
  const int hi = min(N, lo + rows_per_slice);
  const float* qt_t = qt + (size_t)tile_q * d_pad * BQ;
  const float* tt_t = tt + (size_t)tile_q * d_pad * BQ;

  for (int e = tid; e < BQ * k; e += THREADS) {  // distinct (+inf, beyond-N) keys
    run_d[e] = INFINITY;
    run_i[e] = N + e / BQ;
  }

  const int n_chunks = d_pad / DK;
  const int n_steps = (hi - lo + BN - 1) / BN * n_chunks;

  auto stage = [&](int step, int buf) {
    const int r0 = lo + step / n_chunks * BN, k0 = step % n_chunks * DK;
    const float* gq = qt_t + (size_t)k0 * BQ;
    const float* gt = tt_t + (size_t)k0 * BQ;
    float* sq = qs + buf * DK * BQ;
    float* st = ts + buf * DK * BQ;
    for (int e = tid; e < DK * BQ / 4; e += THREADS) {
      cp_async16(sq + 4 * e, gq + 4 * e);
      cp_async16(st + 4 * e, gt + 4 * e);
    }
    // lanes take 8 dims x 4 rows: every shared-memory bank once
    float* sc = cs + buf * DK * CS_STRIDE;
    for (int e = tid; e < DK * BN; e += THREADS) {
      const int l = e & 31, g = e >> 5;
      const int r = g % (BN / 4) * 4 + (l >> 3), kk = g / (BN / 4) * 8 + (l & 7);
      const int gr = r0 + r, gk = k0 + kk;
      const bool ok = gr < hi && gk < d;
      cp_async4(sc + kk * CS_STRIDE + r, ok ? db + (size_t)gr * d + gk : db, ok ? 4 : 0);
    }
    cp_async_commit();
  };

  float acc[QR][RR];
#pragma unroll
  for (int i = 0; i < QR; ++i)
#pragma unroll
    for (int j = 0; j < RR; ++j) acc[i][j] = 0.f;

  if (n_steps > 0) stage(0, 0);
  for (int step = 0; step < n_steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < n_steps) {
      stage(step + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sq = qs + buf * DK * BQ + lane * QR;
    const float* st = ts + buf * DK * BQ + lane * QR;
    const float* sc = cs + buf * DK * CS_STRIDE + warp * RR;
    // lane kk tests the warp's RR row elements at dim kk of the chunk
    const float4 z_lo = *reinterpret_cast<const float4*>(sc + lane * CS_STRIDE);
    const float4 z_hi = *reinterpret_cast<const float4*>(sc + lane * CS_STRIDE + 4);
    const bool no_zero = z_lo.x != 0.f && z_lo.y != 0.f && z_lo.z != 0.f && z_lo.w != 0.f &&
                         z_hi.x != 0.f && z_hi.y != 0.f && z_hi.z != 0.f && z_hi.w != 0.f;
    if (__all_sync(0xffffffffu, no_zero)) {
      // no element of the warp's rows in this chunk is 0 (dense data):
      // every term divides, with no branch between the terms
#pragma unroll 2
      for (int kk = 0; kk < DK; ++kk) {
        const float4 a4 = *reinterpret_cast<const float4*>(sq + kk * BQ);
        const float4 c_lo = *reinterpret_cast<const float4*>(sc + kk * CS_STRIDE);
        const float4 c_hi = *reinterpret_cast<const float4*>(sc + kk * CS_STRIDE + 4);
        const float a[QR] = {a4.x, a4.y, a4.z, a4.w};
        const float c[RR] = {c_lo.x, c_lo.y, c_lo.z, c_lo.w, c_hi.x, c_hi.y, c_hi.z, c_hi.w};
#pragma unroll
        for (int j = 0; j < RR; ++j)
#pragma unroll
          for (int i = 0; i < QR; ++i) acc[i][j] += chi2_term(a[i], c[j]);
      }
    } else {
#pragma unroll 2
      for (int kk = 0; kk < DK; ++kk) {
        const float4 a4 = *reinterpret_cast<const float4*>(sq + kk * BQ);
        const float4 t4 = *reinterpret_cast<const float4*>(st + kk * BQ);
        const float4 c_lo = *reinterpret_cast<const float4*>(sc + kk * CS_STRIDE);
        const float4 c_hi = *reinterpret_cast<const float4*>(sc + kk * CS_STRIDE + 4);
        const float a[QR] = {a4.x, a4.y, a4.z, a4.w};
        const float tz[QR] = {t4.x, t4.y, t4.z, t4.w};
        const float c[RR] = {c_lo.x, c_lo.y, c_lo.z, c_lo.w, c_hi.x, c_hi.y, c_hi.z, c_hi.w};
#pragma unroll
        for (int j = 0; j < RR; ++j) {
          if (c[j] == 0.f) {  // +0 or -0, the same for the whole warp
#pragma unroll
            for (int i = 0; i < QR; ++i) acc[i][j] += tz[i];
          } else {
#pragma unroll
            for (int i = 0; i < QR; ++i) acc[i][j] += chi2_term(a[i], c[j]);
          }
        }
      }
    }
    __syncthreads();  // this buffer is free for step + 2
    if ((step + 1) % n_chunks != 0) continue;

    // ---- the row tile is scored: merge its survivors into the top-k lists
    const int r0 = lo + step / n_chunks * BN + warp * RR;
    bool mine = false;
#pragma unroll
    for (int i = 0; i < QR; ++i) {
      const int p = i * 32 + lane;
      const float kd = run_d[(k - 1) * BQ + p];
      const int ki = run_i[(k - 1) * BQ + p];
      const bool q_ok = q0 + lane * QR + i < B;
#pragma unroll
      for (int j = 0; j < RR; ++j)
        mine |= q_ok && r0 + j < hi && lex_less(acc[i][j], r0 + j, kd, ki);
    }
    if (__syncthreads_or(mine)) {
      for (int w = 0; w < WARPS; ++w) {
        if (w == warp && mine) {
#pragma unroll
          for (int i = 0; i < QR; ++i) {
            if (q0 + lane * QR + i >= B) continue;
            float* rd = run_d + i * 32 + lane;
            int* ri = run_i + i * 32 + lane;
#pragma unroll
            for (int j = 0; j < RR; ++j) {
              const float s = acc[i][j];
              const int id = r0 + j;
              if (id >= hi || !lex_less(s, id, rd[(k - 1) * BQ], ri[(k - 1) * BQ])) continue;
              int pos = k - 1;
              while (pos > 0 && lex_less(s, id, rd[(pos - 1) * BQ], ri[(pos - 1) * BQ])) {
                rd[pos * BQ] = rd[(pos - 1) * BQ];
                ri[pos * BQ] = ri[(pos - 1) * BQ];
                --pos;
              }
              rd[pos * BQ] = s;
              ri[pos * BQ] = id;
            }
          }
        }
        __syncthreads();
      }
    }
#pragma unroll
    for (int i = 0; i < QR; ++i)
#pragma unroll
      for (int j = 0; j < RR; ++j) acc[i][j] = 0.f;
  }
  __syncthreads();

  for (int e = tid; e < BQ * k; e += THREADS) {
    const int r = e / BQ, p = e % BQ;
    const int gq = q0 + (p & 31) * QR + (p >> 5);
    if (gq >= B) continue;
    const float sd = run_d[e];
    if (final_out) {
      part_d[(size_t)gq * k + r] = sd;
      part_i[(size_t)gq * k + r] = isinf(sd) ? -1 : run_i[e];
    } else {
      const size_t o = ((size_t)gq * n_slices + slice) * k + r;
      part_d[o] = sd;
      part_i[o] = run_i[e];
    }
  }
}

// qt, tt: scratch of (ceil(B / 128), d_pad, 128) f32 each, d_pad = d
// rounded up to a multiple of 32 (at least 32); part_d / part_i: scratch of
// (B, max_slices, k) for the slices' lists.
extern "C" int chi2_topk(const void* q, const void* db, void* qt, void* tt, void* part_d,
                         void* part_i, void* out_d, void* out_i, int B, int N, int d, int k,
                         int max_slices, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (k < 1 || k > KMAX || N < 1 || d < 0 || max_slices < 1 || max_slices > MAX_SLICES)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int q_tiles = (B + BQ - 1) / BQ;
  const int d_pad = std::max(DK, (d + DK - 1) / DK * DK);
  const size_t n = (size_t)q_tiles * d_pad * BQ;
  chi2_stage_queries<<<(int)std::min<size_t>((n + THREADS - 1) / THREADS, 4096), THREADS, 0,
                       s>>>((const float*)q, (float*)qt, (float*)tt, B, d, d_pad, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int dyn = (4 * DK * BQ + 2 * DK * CS_STRIDE) * 4 + BQ * k * 8;
  err = cudaFuncSetAttribute(chi2_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return (int)err;
  // slices: one wave of blocks over the card, at most one per 64-row tile
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chi2_scan_kernel, THREADS, dyn);
  if (err != cudaSuccess) return (int)err;
  const int row_tiles = (N + BN - 1) / BN;
  int sl = std::max(1, per_sm * n_sm / q_tiles);
  sl = std::min(std::min(sl, max_slices), row_tiles);
  const int tiles_per_slice = (row_tiles + sl - 1) / sl;
  const int rows_per_slice = tiles_per_slice * BN;
  sl = (row_tiles + tiles_per_slice - 1) / tiles_per_slice;  // no empty slice
  const dim3 grid(q_tiles, sl);
  const float* qtf = (const float*)qt;
  const float* ttf = (const float*)tt;
  if (sl == 1) {
    chi2_scan_kernel<<<grid, THREADS, dyn, s>>>(qtf, ttf, (const float*)db, (float*)out_d,
                                                (int*)out_i, B, N, d, d_pad, k, 1,
                                                rows_per_slice, 1);
    return (int)cudaGetLastError();
  }
  chi2_scan_kernel<<<grid, THREADS, dyn, s>>>(qtf, ttf, (const float*)db, (float*)part_d,
                                              (int*)part_i, B, N, d, d_pad, k, sl,
                                              rows_per_slice, 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  merge_slices_kernel<<<(B + WARPS - 1) / WARPS, THREADS, 0, s>>>(
      (const float*)part_d, (const int*)part_i, (float*)out_d, (int*)out_i, B, k, sl);
  return (int)cudaGetLastError();
}
