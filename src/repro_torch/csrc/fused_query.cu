// Fused candidate gather + exact distance + running top-k: kernel B of the
// port, the query's hot loop.
//
// Replaces the TPU kernel repro/kernels/fused_query.py (fused_gather_topk,
// pallas_call at :146, body _kernel at :45).
//
// Contract (plain version: repro_torch/kernels/ref.py fused_gather_topk_ref):
//   q (B, d) f32, ids (B, M) int32 with -1 marking empty slots, db (N, d)
//   f32 -> out_d (B, k) f32, out_i (B, k) int32: the k smallest scores in
//   (score, slot) lexicographic order, so ties keep the earliest slot like
//   the reference's lax.top_k; +inf / -1 where fewer than k slots score a
//   finite distance.  The metric (l2, dot negated, chi2, cosine) is a
//   template parameter.  Cosine divides the dot product by the two norms
//   where the reference normalizes both vectors first: the same value, other
//   rounding.  k <= KMAX; a larger k takes rounds (kernels/common.py
//   topk_rounds): lo_d / lo_s, when given, are each query's exclusive lower
//   key (score, slot) and a slot at or before it takes no place; last_s,
//   when given, receives each query's k-th slot, the next round's key.
//   The per-pair arithmetic and its order are pair_score.cuh's, which the
//   query-tiled scan (fused_scan.cu) shares.
//
// What bounds it on an H100: bytes.  Every valid slot reads one db row
// (d x 4 B, 3,136 B at d = 784) that nothing else in the block reuses, and
// the arithmetic is 3 flops per element for l2, far below the card's ridge
// point.  The rows (188 MB for MNIST-784) do not fit the 50 MB L2, so the
// floor is valid_slots x d x 4 B over the memory rate.  The design
// therefore moves each row exactly once and never writes the (B, M, d)
// gathered block: one block of 256 threads per query row, the query in
// shared memory; each warp takes candidate slots in turn, an empty slot
// (-1) issues no load; scores of a 256-slot tile land in shared memory and
// only those that beat the running k-th best are merged, by rank, into the
// running top-k kept in shared memory.
//
// chi2 (ISS-595, d = 595) ran at 3.2-3.4x that floor on an NVIDIA H100 80GB
// HBM3 at 700 W (PERF.md) when each lane loaded its elements straight into
// the term (l2 on the same rows ran at 1.03-1.06x), for two reasons
// measured apart: an IEEE division waits on its row element's load and the
// next load waits behind the division (dense rows, no element 0: 2.4x),
// and a term with x = y = 0 divides 0 by 1e-12, the division's slow path,
// on 71-80% of ISS-595's terms (another ~0.5 ms at M = 1920).  So under chi2 a warp's rows are staged in shared memory with
// cp.async one slot ahead of the slot being scored (pair_score.cuh
// staged_scores), and a row element of +-0 takes the query's own term,
// computed once per query (accum_chi2): the same bits, with no 0 / 1e-12.
// Kernel G runs the same loop over its pre-gathered rows.  l2, dot and
// cosine keep the direct loads (direct_scores): they run at 1.0-1.1x the
// floor, and over rows that mostly hit in L2 (the gather at M = N) the
// staged copy's extra shared-memory traffic made them slower.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pair_score.cuh"

#define THREADS 256
#define WARPS (THREADS / 32)
#define TILE 256
#define KMAX 128
// Small M (stage 2 of rpf+int8 scores M = k' = 40 slots a query): warp w
// scoring slots 32w .. 32w + 31 leaves 6 of 8 warps idle, and a warp's
// slots go one after another.  At M <= SPREAD_MAX_M a tile's valid slots
// are listed first and dealt over all the warps, each warp taking GROUP of
// them at once with their rows' loads in flight together (l2, dot and
// cosine; chi2 keeps its staged rows).  Above it the one-slot-a-lane
// layout runs as before; both give a pair the same bits.
// The crossover, GROUP and the blocks an SM are chip_split.py's measurements
// on an H100 (PERF.md).
#define SPREAD_MAX_M 128
#define GROUP 2
#define SPREAD_BLOCKS 8

__device__ __forceinline__ bool lex_less(float da, int sa, float db, int sb) {
  return da < db || (da == db && sa < sb);
}

// The small-M scores of the tile at base: the valid slots listed, then warp
// w takes listed positions w, w + WARPS, ... GROUP at a time; tile_d[slot -
// base] gets each valid slot's score and +inf the rest.  Ends before the
// caller's barrier, so tile_d is read only after it.
template <int METRIC, bool VEC4>
__device__ __forceinline__ void listed_scores(const float* qs, const int* ids_b,
                                              const float* __restrict__ db, int base, int M,
                                              int N, int d, float q_norm, float* tile_d) {
  __shared__ int list_slot[TILE], list_id[TILE];
  __shared__ int n_valid[WARPS];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int id = base + tid < M ? ids_b[base + tid] : -1;
  const unsigned ok = __ballot_sync(0xffffffffu, id >= 0);
  if (lane == 0) n_valid[warp] = __popc(ok);
  tile_d[tid] = INFINITY;
  __syncthreads();
  int off = 0, nv = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    off += w < warp ? n_valid[w] : 0;
    nv += n_valid[w];
  }
  if (id >= 0) {
    const int p = off + __popc(ok & ((1u << lane) - 1u));
    list_slot[p] = tid;
    list_id[p] = id;
  }
  __syncthreads();
  for (int p0 = warp; p0 < nv; p0 += WARPS * GROUP) {
    const int n = min(GROUP, (nv - p0 + WARPS - 1) / WARPS);  // positions of this round
    const float* rows[GROUP];
#pragma unroll
    for (int u = 0; u < GROUP; ++u)
      rows[u] = db + (size_t)min(list_id[u < n ? p0 + u * WARPS : p0], N - 1) * d;
    float a[GROUP], c[GROUP];
#pragma unroll
    for (int u = 0; u < GROUP; ++u) a[u] = c[u] = 0.f;
    group_partials<METRIC, VEC4, GROUP>(qs, rows, n, d, lane, a, c);
#pragma unroll
    for (int u = 0; u < GROUP; ++u) {
      const float s = warp_sum(a[u]);
      const float cc = METRIC == COSINE ? warp_sum(c[u]) : 0.f;
      if (lane == u && u < n) tile_d[list_slot[p0 + u * WARPS]] = finish<METRIC>(s, cc, q_norm);
    }
  }
}

// The kernel's body; SPREAD picks the small-M scores
template <int METRIC, bool VEC4, bool SPREAD>
__device__ __forceinline__ void gather_topk(const float* __restrict__ q,
                                            const int* __restrict__ ids,
                                            const float* __restrict__ db,
                                            const float* __restrict__ lo_d,
                                            const int* __restrict__ lo_s,
                                            float* __restrict__ out_d, int* __restrict__ out_i,
                                            int* __restrict__ last_s, int M, int N, int d,
                                            int k) {
  // dynamic: the query, chi2's own terms, then each warp's ring
  extern __shared__ __align__(16) float smem[];
  __shared__ float tile_d[TILE];
  __shared__ float surv_d[TILE];
  __shared__ int surv_s[TILE];
  __shared__ float run_d[KMAX], nxt_d[KMAX];
  __shared__ int run_s[KMAX], nxt_s[KMAX];
  __shared__ int n_surv;
  __shared__ float q_norm;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int* ids_b = ids + (size_t)b * M;
  const int dp = (d + 3) & ~3;
  float* qs = smem;
  float* tt = qs + dp;
  float* ring = tt + dp + warp * STAGES * stage_stride(d);  // chi2 only

  for (int c = tid; c < d; c += THREADS) {
    const float x = q[(size_t)b * d + c];
    qs[c] = x;
    if (METRIC == CHI2) tt[c] = own_term(x);
  }
  if (tid < k) {  // distinct (+inf, beyond-M) keys keep every rank unique
    run_d[tid] = INFINITY;
    run_s[tid] = M + tid;
  }
  if (tid == 0) n_surv = 0;
  __syncthreads();
  if (METRIC == COSINE) {
    if (warp == 0) {
      const float s = warp_sum(norm_partial(qs, d, lane));
      if (lane == 0) q_norm = sqrtf(s) + EPS;
    }
    __syncthreads();
  }
  const bool lower = lo_d != nullptr;
  const float low_d = lower ? lo_d[b] : 0.f;
  const int low_s = lower ? lo_s[b] : 0;

  for (int base = 0; base < M; base += TILE) {
    if constexpr (SPREAD) {
      listed_scores<METRIC, VEC4>(qs, ids_b, db, base, M, N, d, q_norm, tile_d);
    } else {
      // ---- score the tile: warp w owns slots base + 32w .. base + 32w + 31
      const int first = base + warp * 32;
      const int my_id = first + lane < M ? ids_b[first + lane] : -1;
      // an empty slot: no load, scores +inf
      const unsigned ok = __ballot_sync(0xffffffffu, my_id >= 0);
      auto row_of = [&](int i) {
        return db + (size_t)min(__shfl_sync(0xffffffffu, my_id, i), N - 1) * d;
      };
      if constexpr (METRIC == CHI2)
        tile_d[tid] = staged_scores<METRIC, VEC4>(qs, tt, ring, d, lane, ok, row_of);
      else
        tile_d[tid] = direct_scores<METRIC, VEC4>(qs, d, lane, ok, row_of, q_norm);
    }
    __syncthreads();

    // ---- keep only finite scores that beat the running k-th best
    {
      const float s = tile_d[tid];
      const int slot = base + tid;
      if (slot < M && isfinite(s) && (!lower || lex_less(low_d, low_s, s, slot)) &&
          lex_less(s, slot, run_d[k - 1], run_s[k - 1])) {
        const int pos = atomicAdd(&n_surv, 1);
        surv_d[pos] = s;
        surv_s[pos] = slot;
      }
    }
    __syncthreads();

    // ---- rank-merge survivors into the running top-k (keys are unique,
    //      so ranks are a permutation and each of the k places fills once)
    const int ns = n_surv;
    if (ns > 0) {
      if (tid < ns) {
        const float s = surv_d[tid];
        const int slot = surv_s[tid];
        int rank = 0;
        for (int j = 0; j < k; ++j) rank += lex_less(run_d[j], run_s[j], s, slot);
        for (int j = 0; j < ns; ++j) rank += lex_less(surv_d[j], surv_s[j], s, slot);
        if (rank < k) {
          nxt_d[rank] = s;
          nxt_s[rank] = slot;
        }
      }
      if (tid < k) {
        const float s = run_d[tid];
        const int slot = run_s[tid];
        int rank = tid;
        for (int j = 0; j < ns; ++j) rank += lex_less(surv_d[j], surv_s[j], s, slot);
        if (rank < k) {
          nxt_d[rank] = s;
          nxt_s[rank] = slot;
        }
      }
      __syncthreads();
      if (tid < k) {
        run_d[tid] = nxt_d[tid];
        run_s[tid] = nxt_s[tid];
      }
    }
    if (tid == 0) n_surv = 0;
    __syncthreads();
  }

  if (tid < k) {
    const float s = run_d[tid];
    out_d[(size_t)b * k + tid] = s;
    out_i[(size_t)b * k + tid] = isinf(s) ? -1 : ids_b[run_s[tid]];
    if (last_s != nullptr && tid == k - 1) last_s[b] = run_s[tid];
  }
}

#define KERNEL_ARGS                                                                        \
  const float *__restrict__ q, const int *__restrict__ ids, const float *__restrict__ db,  \
      const float *__restrict__ lo_d, const int *__restrict__ lo_s,                        \
      float *__restrict__ out_d, int *__restrict__ out_i, int *__restrict__ last_s, int M, \
      int N, int d, int k

template <int METRIC, bool VEC4>
__global__ void __launch_bounds__(THREADS) fused_gather_topk_kernel(KERNEL_ARGS) {
  gather_topk<METRIC, VEC4, false>(q, ids, db, lo_d, lo_s, out_d, out_i, last_s, M, N, d, k);
}

// the small-M shape, compiled for SPREAD_BLOCKS blocks an SM: at 8 (32
// registers a thread) a batch of 1,024 queries runs in one wave
template <int METRIC, bool VEC4>
__global__ void __launch_bounds__(THREADS, SPREAD_BLOCKS)
    fused_gather_topk_small_kernel(KERNEL_ARGS) {
  gather_topk<METRIC, VEC4, true>(q, ids, db, lo_d, lo_s, out_d, out_i, last_s, M, N, d, k);
}

template <int METRIC, bool VEC4, bool SPREAD>
static int launch(const float* q, const int* ids, const float* db, const float* lo_d,
                  const int* lo_s, float* out_d, int* out_i, int* last_s, int B, int M, int N,
                  int d, int k, cudaStream_t stream) {
  auto kernel = SPREAD ? fused_gather_topk_small_kernel<METRIC, VEC4>
                       : fused_gather_topk_kernel<METRIC, VEC4>;
  // the query; under chi2 its own terms and the rows' rings too
  const size_t smem = METRIC == CHI2 ? staged_smem_bytes(d, true, WARPS)
                                     : sizeof(float) * (size_t)((d + 3) & ~3);
  if (smem > 32 * 1024) {  // with the static tiles, past the 48 KB a block gets unasked
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<B, THREADS, smem, stream>>>(q, ids, db, lo_d, lo_s, out_d, out_i, last_s, M, N, d,
                                       k);
  return (int)cudaGetLastError();
}

template <int METRIC>
static int launch_metric(const float* q, const int* ids, const float* db, const float* lo_d,
                         const int* lo_s, float* out_d, int* out_i, int* last_s, int B, int M,
                         int N, int d, int k, cudaStream_t s) {
  constexpr bool direct = METRIC != CHI2;
  if (direct && M <= SPREAD_MAX_M) {
    if (d % 4 == 0)
      return launch<METRIC, true, direct>(q, ids, db, lo_d, lo_s, out_d, out_i, last_s, B, M,
                                          N, d, k, s);
    return launch<METRIC, false, direct>(q, ids, db, lo_d, lo_s, out_d, out_i, last_s, B, M,
                                         N, d, k, s);
  }
  if (d % 4 == 0)
    return launch<METRIC, true, false>(q, ids, db, lo_d, lo_s, out_d, out_i, last_s, B, M, N,
                                       d, k, s);
  return launch<METRIC, false, false>(q, ids, db, lo_d, lo_s, out_d, out_i, last_s, B, M, N,
                                      d, k, s);
}

// lo_d / lo_s (B,) may be null (no lower key); last_s (B,) may be null
extern "C" int fused_gather_topk(const void* q, const void* ids, const void* db,
                                 const void* lo_d, const void* lo_s, void* out_d, void* out_i,
                                 void* last_s, int B, int M, int N, int d, int k, int metric,
                                 void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (k < 1 || k > KMAX || d < 1) return (int)cudaErrorInvalidValue;
  // float4 reads of a staged row need it 16-byte aligned
  if (d % 4 == 0 && (uintptr_t)db % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const float* qf = (const float*)q;
  const int* ii = (const int*)ids;
  const float* dbf = (const float*)db;
  const float* ld = (const float*)lo_d;
  const int* ls = (const int*)lo_s;
  float* od = (float*)out_d;
  int* oi = (int*)out_i;
  int* os = (int*)last_s;
  cudaStream_t s = (cudaStream_t)stream;
  switch (metric) {
    case L2: return launch_metric<L2>(qf, ii, dbf, ld, ls, od, oi, os, B, M, N, d, k, s);
    case DOT: return launch_metric<DOT>(qf, ii, dbf, ld, ls, od, oi, os, B, M, N, d, k, s);
    case CHI2: return launch_metric<CHI2>(qf, ii, dbf, ld, ls, od, oi, os, B, M, N, d, k, s);
    case COSINE:
      return launch_metric<COSINE>(qf, ii, dbf, ld, ls, od, oi, os, B, M, N, d, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
