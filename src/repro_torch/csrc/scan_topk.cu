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
//   |q|^2 and |c|^2 given as (B,) and (N,) vectors; dot is -q.c.  k <=
//   KMAX; a larger k takes rounds (kernels/common.py topk_rounds): lo_d /
//   lo_i, when given, are each query's exclusive lower key (score, id).
//
// Every score is one FFMA chain over d in ascending order from +0, padded
// with 0 * 0 terms to a multiple of 32, then the epilogue below: no split
// of d, no TF32, no tensor cores (the reference's products are IEEE fp32).
// The output is a function of the (score, id) pairs alone, so any tiling
// that keeps each chain gives the same bits.
//
// What bounds it on an H100: operations.  Every (query, row) pair costs d
// FFMAs (96 GFLOP for 1024 queries against MNIST-784: 1.44 ms at the fp32
// peak), while each row is read from memory about once.  An SM issues 4
// warp-FFMAs a clock but moves 128 bytes a clock from shared memory to
// registers, so the operands must come from registers: each thread keeps
// an 8-query x 8-row block of sums, 4 FFMAs for every float it loads.
// The design:
//   - a block of 256 threads, one an SM (250-254 registers a thread),
//     scores a tile of 128 queries against 128-row tiles of one slice of
//     the rows; warp (wq, wr) holds queries 32 wq .. 32 wq + 31 and rows 64
//     wr .. 64 wr + 63, lane (ly, lx) the queries ly + 4i and rows lx + 8j
//     of those;
//   - both tiles stream through shared memory in steps of 32 columns,
//     three stages deep (two where the top-k lists of k > 101 leave no
//     room): cp.async (16-byte copies where rows are 16-byte aligned,
//     4-byte ones otherwise, zeros past d, B and the slice) fills step s +
//     2 while step s computes, and the next row tile's first step loads
//     while this tile's top-k is merged.  Tiles stay row-major, as
//     cp.async copies them, with a row stride of 36 floats: a thread reads
//     4 columns of a row as one float4, and the 8 rows (or 4 queries) a
//     quarter-warp reads start in distinct bank groups;
//   - at the end of a row tile each thread tests its 64 scores against its
//     queries' k-th key (the running list's last entry); survivors are
//     written into a score tile that reuses the stages, and marked in a
//     per-query bit mask by warp ballot.  Each warp then merges the
//     survivors of 16 queries into their running top-k: up to 32 at k <=
//     32 are ranked in registers over keys shuffled in turn; more (the
//     first tile), or a longer list, are sorted by a bitonic network
//     across the warp and placed by binary search;
//   - row slices are sized so that one wave of blocks fills the card; each
//     slice leaves a sorted top-k and a second kernel merges the slices of
//     a query, one warp per query, one lane per slice.
// On the H100 the product loop runs at about 61% of the FFMA rate (the
// loads, their waits and the barriers take the rest), and the merges take
// about a tenth of the time: clock64 counts per phase, PERF.md.
// The (B, N) score matrix is never written.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "cp_async.cuh"
#include "merge_slices.cuh"

#define BQ 128
#define BN 128
#define DK 32
#define SK 36  // a staged row's stride in floats
#define STAGE_FLOATS ((BQ + BN) * SK)
#define THREADS 256
#define WARPS (THREADS / 32)
#define KMAX 128
#define MAX_SLICES 32

enum Metric { L2 = 0, DOT = 1 };

// copy columns k0 .. k0 + DK - 1 of the query tile and the row tile into a
// stage (zeros past d, past B and past the slice's end hi)
template <bool VEC16>
__device__ __forceinline__ void load_stage(float* st, const float* __restrict__ q,
                                           const float* __restrict__ db, int q0, int B,
                                           int r0, int hi, int d, int k0, int tid) {
  if (VEC16) {
#pragma unroll
    for (int t = 0; t < (BQ + BN) * DK / 4 / THREADS; ++t) {
      const int idx = tid + t * THREADS;
      const int r = idx / (DK / 4), c = k0 + idx % (DK / 4) * 4;
      const bool is_q = r < BQ;
      const int g = is_q ? q0 + r : r0 + r - BQ;
      const bool ok = (is_q ? g < B : g < hi) && c < d;
      const float* src = is_q ? q : db;
      cp_async16(st + r * SK + c - k0, ok ? src + (size_t)g * d + c : src, ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int t = 0; t < (BQ + BN) * DK / THREADS; ++t) {
      const int idx = tid + t * THREADS;
      const int r = idx / DK, c = k0 + idx % DK;
      const bool is_q = r < BQ;
      const int g = is_q ? q0 + r : r0 + r - BQ;
      const bool ok = (is_q ? g < B : g < hi) && c < d;
      const float* src = is_q ? q : db;
      cp_async4(st + r * SK + c - k0, ok ? src + (size_t)g * d + c : src, ok ? 4 : 0);
    }
  }
}

// the sums of one step: the thread's queries' rows at sa + 4i rows, its db
// rows at sb + 8j rows; each sum adds the columns in ascending order
__device__ __forceinline__ void step_sums(const float* sa, const float* sb, float (&acc)[8][8]) {
#pragma unroll
  for (int kq = 0; kq < DK; kq += 4) {
    float4 a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = *reinterpret_cast<const float4*>(sa + 4 * i * SK + kq);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 b = *reinterpret_cast<const float4*>(sb + 8 * j * SK + kq);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i][j] = __fmaf_rn(a[i].x, b.x, acc[i][j]);
        acc[i][j] = __fmaf_rn(a[i].y, b.y, acc[i][j]);
        acc[i][j] = __fmaf_rn(a[i].z, b.z, acc[i][j]);
        acc[i][j] = __fmaf_rn(a[i].w, b.w, acc[i][j]);
      }
    }
  }
}

// entries of the sorted list (ld, li)[0, n) below the key (d, i)
__device__ __forceinline__ int count_below(const float* ld, const int* li, int n, float d, int i) {
  int a = 0, b = n;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (lex_less(ld[mid], li[mid], d, i)) a = mid + 1;
    else b = mid;
  }
  return a;
}

// sort 128 (score, id) keys ascending across a warp: element 4 lane + j
// is (d[j], i[j]); a bitonic network, partners within a lane for strides
// 1 and 2, a shuffle away for the others.  Keys must be unique.
__device__ __forceinline__ void sort128(float (&d)[4], int (&i)[4], int lane) {
#pragma unroll
  for (int size = 2; size <= 128; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 4) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float od = __shfl_xor_sync(0xffffffffu, d[j], stride >> 2);
          const int oi = __shfl_xor_sync(0xffffffffu, i[j], stride >> 2);
          const int e = 4 * lane + j;
          const bool up = (e & size) == 0, low = (e & stride) == 0;
          // the lower element of an ascending pair keeps the smaller key
          if (lex_less(od, oi, d[j], i[j]) == (up == low)) {
            d[j] = od;
            i[j] = oi;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j & stride) continue;
          const bool up = ((4 * lane + j) & size) == 0;
          if (lex_less(d[j + stride], i[j + stride], d[j], i[j]) == up) {
            const float td = d[j];
            const int ti = i[j];
            d[j] = d[j + stride];
            i[j] = i[j + stride];
            d[j + stride] = td;
            i[j + stride] = ti;
          }
        }
      }
    }
  }
}

// merge ns survivors (wsv_d, wsv_i)[0, ns) into a query's sorted running
// top-k (rd, ri)[0, k): one warp; wnx: k places of scratch
__device__ __forceinline__ void merge_survivors(float* rd, int* ri, int k, float* wsv_d,
                                                int* wsv_i, int ns, float* wnx_d, int* wnx_i,
                                                int lane) {
  if (ns <= 32 && k <= 32) {
    // few survivors, a short list: a key a lane; a survivor counts the
    // running entries below it by binary search, and every lane the
    // survivors below its key over their keys, shuffled in turn
    const bool hs = lane < ns, hr = lane < k;
    const float sd = hs ? wsv_d[lane] : 0.f;
    const int si = hs ? wsv_i[lane] : 0;
    const float qd = hr ? rd[lane] : 0.f;
    const int qi = hr ? ri[lane] : 0;
    int rank_s = hs ? count_below(rd, ri, k, sd, si) : 0, rank_r = lane;
    for (int u = 0; u < ns; ++u) {
      const float ud = __shfl_sync(0xffffffffu, sd, u);
      const int ui = __shfl_sync(0xffffffffu, si, u);
      rank_s += lex_less(ud, ui, sd, si);
      rank_r += lex_less(ud, ui, qd, qi);
    }
    __syncwarp();  // every lane holds its running entry
    if (hs && rank_s < k) {
      rd[rank_s] = sd;
      ri[rank_s] = si;
    }
    if (hr && rank_r < k) {
      rd[rank_r] = qd;
      ri[rank_r] = qi;
    }
    __syncwarp();
    return;
  }
  // many survivors (the first tiles) or a long list: sort them (a
  // bitonic network, 4 a lane), keep the first m = min(ns, k), and place
  // each sorted survivor and each running entry by binary search in the
  // other list.  Keys are unique, so the ranks are a permutation and
  // each of the k places fills once.
  float sd[4];
  int si[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int e = 4 * lane + j;
    sd[j] = e < ns ? wsv_d[e] : INFINITY;
    si[j] = e < ns ? wsv_i[e] : 0x7fffffff;
  }
  sort128(sd, si, lane);
  const int m = min(ns, k);
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int e = 4 * lane + j;
    if (e < m) {
      wsv_d[e] = sd[j];
      wsv_i[e] = si[j];
      const int rank = e + count_below(rd, ri, k, sd[j], si[j]);
      if (rank < k) {
        wnx_d[rank] = sd[j];
        wnx_i[rank] = si[j];
      }
    }
  }
  __syncwarp();
  for (int r = lane; r < k; r += 32) {
    const int rank = r + count_below(wsv_d, wsv_i, m, rd[r], ri[r]);
    if (rank < k) {
      wnx_d[rank] = rd[r];
      wnx_i[rank] = ri[r];
    }
  }
  __syncwarp();
  for (int r = lane; r < k; r += 32) {
    rd[r] = wnx_d[r];
    ri[r] = wnx_i[r];
  }
  __syncwarp();
}

// merge the survivors of query ql in row tile rt (marked in its mask, their
// scores in its row of tile_s) into its running top-k: one warp
__device__ __forceinline__ void merge_query(int ql, int rt, int q0, int B, int k,
                                            const unsigned* mask, const float* tile_s,
                                            float* run_d, int* run_i, float* wsv_d, int* wsv_i,
                                            float* wnx_d, int* wnx_i, int lane) {
  if (q0 + ql >= B) return;  // warp-uniform
  unsigned m[BN / 32];
  int ns = 0;
#pragma unroll
  for (int j = 0; j < BN / 32; ++j) {
    m[j] = mask[ql * (BN / 32) + j];
    ns += __popc(m[j]);
  }
  if (ns == 0) return;  // warp-uniform
  const unsigned below = (1u << lane) - 1u;
  int off = 0;
#pragma unroll
  for (int j = 0; j < BN / 32; ++j) {
    if (m[j] >> lane & 1u) {
      const int pos = off + __popc(m[j] & below);
      wsv_d[pos] = tile_s[ql * BN + lane + 32 * j];
      wsv_i[pos] = rt + lane + 32 * j;
    }
    off += __popc(m[j]);
  }
  __syncwarp();
  merge_survivors(run_d + ql * k, run_i + ql * k, k, wsv_d, wsv_i, ns, wnx_d, wnx_i, lane);
}

// ROUNDS: the launch is a later round of a larger k (a lower key is given);
// the others compile without the lower-key test
template <int METRIC, bool ROUNDS, bool VEC16>
__global__ void __launch_bounds__(THREADS, 1)
    scan_topk_kernel(const float* __restrict__ q, const float* __restrict__ db,
                     const float* __restrict__ q_sq, const float* __restrict__ db_sq,
                     const float* __restrict__ lo_d, const int* __restrict__ lo_i,
                     float* __restrict__ part_d, int* __restrict__ part_i, int B, int N,
                     int d, int k, int n_slices, int rows_per_slice, int final_out, int n_st) {
  // n_st stages (2 or 3) of DK columns; the score tile reuses them.  With
  // 3 it leaves stage 0 free, and the next row tile's first step loads
  // while this tile's scores are tested and merged (early)
  const bool early = (n_st - 1) * STAGE_FLOATS >= BQ * BN;
  extern __shared__ __align__(16) float dyn[];
  float* stage = dyn;                                    // [n_st][BQ + BN][SK]
  float* tile_s = dyn + (early ? STAGE_FLOATS : 0);      // [BQ][BN]
  float* run_d = dyn + n_st * STAGE_FLOATS;              // [BQ][k]
  int* run_i = (int*)(run_d + BQ * k);                   // [BQ][k]
  float* nx_d = (float*)(run_i + BQ * k);                // [WARPS][k]
  int* nx_i = (int*)(nx_d + WARPS * k);                  // [WARPS][k]
  float* sv_d = (float*)(nx_i + WARPS * k);              // [WARPS][BN]
  int* sv_i = (int*)(sv_d + WARPS * BN);                 // [WARPS][BN]
  unsigned* mask = (unsigned*)(sv_i + WARPS * BN);       // [BQ][BN / 32]
  float* qsq_s = (float*)(mask + BQ * (BN / 32));        // [BQ]
  float* low_d = qsq_s + BQ;                             // [BQ]
  int* low_i = (int*)(low_d + BQ);                       // [BQ]
  float* csq_s = (float*)(low_i + BQ);                   // [BN]: |c|^2 of the row tile

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wq = warp % 4, wr = warp / 4;
  const int ly = lane >> 3, lx = lane & 7;
  const int q0 = blockIdx.x * BQ;
  const int slice = blockIdx.y;
  const int lo = slice * rows_per_slice;
  const int hi = min(N, lo + rows_per_slice);
  const int n_steps = (d + DK - 1) / DK;

  for (int r = tid; r < BQ * k; r += THREADS) {  // distinct (+inf, beyond-N) keys
    run_d[r] = INFINITY;
    run_i[r] = N + r % k;
  }
  for (int r = tid; r < BQ; r += THREADS) {
    const int gq = q0 + r;
    qsq_s[r] = (METRIC == L2 && gq < B) ? q_sq[gq] : 0.f;
    low_d[r] = (ROUNDS && gq < B) ? lo_d[gq] : 0.f;
    low_i[r] = (ROUNDS && gq < B) ? lo_i[gq] : 0;
  }
  __syncthreads();

  // this thread's fragments: queries wq*32 + ly + 4i, rows wr*64 + lx + 8j
  const int fa = (wq * 32 + ly) * SK;
  const int fb = (BQ + wr * 64 + lx) * SK;
  float* wnx_d = nx_d + warp * k;
  int* wnx_i = nx_i + warp * k;
  float* wsv_d = sv_d + warp * BN;
  int* wsv_i = sv_i + warp * BN;

  if (early) {
    if (lo < hi && n_steps > 0) load_stage<VEC16>(stage, q, db, q0, B, lo, hi, d, 0, tid);
    cp_async_commit();
  }
  for (int r0 = lo; r0 < hi; r0 += BN) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    // steps 0 .. n_st - 2 in flight before the first (step 0 of an early
    // tile already is), and the tile's |c|^2
    for (int p = early ? 1 : 0; p <= n_st - 2 && p < n_steps; ++p)
      load_stage<VEC16>(stage + p * STAGE_FLOATS, q, db, q0, B, r0, hi, d, p * DK, tid);
    if (METRIC == L2 && tid < BN) {
      const int gr = r0 + tid;
      cp_async4(csq_s + tid, gr < hi ? db_sq + gr : db_sq, gr < hi ? 4 : 0);
    }
    cp_async_commit();
    for (int s = 0; s < n_steps; ++s) {
      if (n_st == 3) cp_async_wait<1>();  // step s has landed; s + 1 may not have
      else cp_async_wait<0>();
      __syncthreads();                    // ... for every thread, and step s - 1 is done
      const int nx = s + n_st - 1;
      if (nx < n_steps)
        load_stage<VEC16>(stage + (nx % n_st) * STAGE_FLOATS, q, db, q0, B, r0, hi, d, nx * DK,
                          tid);
      cp_async_commit();
      const float* st = stage + (s % n_st) * STAGE_FLOATS;
      step_sums(st + fa, st + fb, acc);
    }
    cp_async_wait<0>();
    __syncthreads();  // every step is done
    if (early) {      // the next row tile's step 0, beside the score tile
      if (r0 + BN < hi && n_steps > 0)
        load_stage<VEC16>(stage, q, db, q0, B, r0 + BN, hi, d, 0, tid);
      cp_async_commit();
    }

    // ---- test the 64 scores against the queries' k-th keys; survivors go
    //      to tile_s and to the queries' masks
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int ql = wq * 32 + ly + 4 * i;
      const bool live = q0 + ql < B;
      const float kd = run_d[ql * k + k - 1];
      const int ki = run_i[ql * k + k - 1];
      unsigned word[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int rl = wr * 64 + lx + 8 * j;
        const int id = r0 + rl;
        float s;
        if (METRIC == L2) s = qsq_s[ql] - 2.f * acc[i][j] + csq_s[rl];
        else s = -acc[i][j];
        const bool keep = live && id < hi &&
                          (!ROUNDS || lex_less(low_d[ql], low_i[ql], s, id)) &&
                          lex_less(s, id, kd, ki);
        if (keep) tile_s[ql * BN + rl] = s;
        // byte ly of the ballot: rows 64 wr + 8j .. + 7 of query ql
        const unsigned bits = __ballot_sync(0xffffffffu, keep);
        word[j >> 2] |= ((bits >> (8 * ly)) & 0xffu) << (8 * (j & 3));
      }
      if (lx == 0) {
        mask[ql * (BN / 32) + 2 * wr] = word[0];
        mask[ql * (BN / 32) + 2 * wr + 1] = word[1];
      }
    }
    __syncthreads();

    // ---- warp w merges the survivors of queries w, w + 8, ...
    for (int t = 0; t < BQ / WARPS; ++t)
      merge_query(warp + WARPS * t, r0, q0, B, k, mask, tile_s, run_d, run_i, wsv_d, wsv_i,
                  wnx_d, wnx_i, lane);
    __syncthreads();  // tile_s is the next tile's stages
  }
  cp_async_wait<0>();

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

// shared memory of a stage, and of the top-k lists
static int stage_bytes() { return STAGE_FLOATS * 4; }
static int list_bytes(int k) {
  return (BQ * k + WARPS * k) * 8 + WARPS * BN * 8 + BQ * (BN / 32) * 4 + BQ * 12 + BN * 4;
}

template <int METRIC, bool ROUNDS, bool VEC16>
static int launch(const float* q, const float* db, const float* q_sq, const float* db_sq,
                  const float* lo_d, const int* lo_i, float* part_d, int* part_i, float* out_d,
                  int* out_i, int B, int N, int d, int k, int max_slices, cudaStream_t stream) {
  auto kernel = scan_topk_kernel<METRIC, ROUNDS, VEC16>;
  int dev = 0, n_sm = 0, smem_max = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return (int)err;
  // three stages where they fit beside the top-k lists (k <= 101), else two
  const int n_st = 3 * stage_bytes() + list_bytes(k) <= smem_max ? 3 : 2;
  const int dyn = n_st * stage_bytes() + list_bytes(k);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  // slices: one wave of blocks over the card, at most one per 128-row tile
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
    kernel<<<grid, THREADS, dyn, stream>>>(q, db, q_sq, db_sq, lo_d, lo_i, out_d, out_i, B, N, d,
                                           k, 1, rows_per_slice, 1, n_st);
    return (int)cudaGetLastError();
  }
  kernel<<<grid, THREADS, dyn, stream>>>(q, db, q_sq, db_sq, lo_d, lo_i, part_d, part_i, B, N,
                                         d, k, s, rows_per_slice, 0, n_st);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  merge_slices_kernel<<<(B + WARPS - 1) / WARPS, THREADS, 0, stream>>>(part_d, part_i, out_d,
                                                                      out_i, B, k, s);
  return (int)cudaGetLastError();
}

template <int METRIC, bool ROUNDS>
static int launch_vec(const float* q, const float* db, const float* qsq, const float* dsq,
                      const float* ld, const int* li, float* pd, int* pi, float* od, int* oi,
                      int B, int N, int d, int k, int max_slices, cudaStream_t s) {
  // 16-byte copies need every row of q and db on a 16-byte boundary
  if (d % 4 == 0 && ((uintptr_t)q & 15) == 0 && ((uintptr_t)db & 15) == 0)
    return launch<METRIC, ROUNDS, true>(q, db, qsq, dsq, ld, li, pd, pi, od, oi, B, N, d, k,
                                        max_slices, s);
  return launch<METRIC, ROUNDS, false>(q, db, qsq, dsq, ld, li, pd, pi, od, oi, B, N, d, k,
                                       max_slices, s);
}

// lo_d / lo_i (B,) may be null (no lower key); part_d / part_i: scratch of
// (B, max_slices, k) for the slices' lists.
extern "C" int scan_topk(const void* q, const void* db, const void* q_sq, const void* db_sq,
                         const void* lo_d, const void* lo_i, void* part_d, void* part_i,
                         void* out_d, void* out_i, int B, int N, int d, int k, int max_slices,
                         int metric, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (k < 1 || k > KMAX || N < 1 || max_slices < 1 || max_slices > MAX_SLICES)
    return (int)cudaErrorInvalidValue;
  const float* qf = (const float*)q;
  const float* dbf = (const float*)db;
  const float* qsq = (const float*)q_sq;
  const float* dsq = (const float*)db_sq;
  const float* ld = (const float*)lo_d;
  const int* li = (const int*)lo_i;
  float* pd = (float*)part_d;
  int* pi = (int*)part_i;
  float* od = (float*)out_d;
  int* oi = (int*)out_i;
  cudaStream_t s = (cudaStream_t)stream;
  switch (metric) {
    case L2:
      return ld ? launch_vec<L2, true>(qf, dbf, qsq, dsq, ld, li, pd, pi, od, oi, B, N, d, k,
                                       max_slices, s)
                : launch_vec<L2, false>(qf, dbf, qsq, dsq, ld, li, pd, pi, od, oi, B, N, d, k,
                                        max_slices, s);
    case DOT:
      return ld ? launch_vec<DOT, true>(qf, dbf, qsq, dsq, ld, li, pd, pi, od, oi, B, N, d, k,
                                        max_slices, s)
                : launch_vec<DOT, false>(qf, dbf, qsq, dsq, ld, li, pd, pi, od, oi, B, N, d, k,
                                         max_slices, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
