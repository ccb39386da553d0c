// Exact distance over pre-gathered candidate rows + masked running top-k:
// kernel G of the port.
//
// Replaces the TPU kernel repro/kernels/distance_topk.py (distance_topk,
// pallas_call at :73, body _kernel at :27), reached through
// ops.rerank_candidates.
//
// Contract (plain version: repro_torch/kernels/ref.py distance_topk_ref):
//   q (B, d) f32, cand (B, M, d) f32 rows already gathered per query, ids
//   (B, M) int32, mask (B, M) bool -> out_d (B, k) f32, out_i (B, k) int32:
//   the k smallest l2 or chi2 scores over the slots whose mask is set, in
//   (score, id) order, so ties go to the smaller id as the reference's
//   lexsort does (equal (score, id) pairs, repeats of one id, fall back to
//   the slot, which changes nothing in the output); +inf / -1 where fewer
//   than k slots are valid, or k > M.  chi2 is sum (q - c)^2 / (q + c +
//   1e-12) with IEEE division (no fast math), as kernels B and E.  k <=
//   KMAX; a larger k takes rounds (kernels/common.py topk_rounds): lo_d /
//   lo_i / lo_s, when given, are each query's exclusive lower key (score,
//   id, slot), and last_s, when given, receives each query's k-th slot
//   (its k-th id is in out_i), the next round's key.
//
// What bounds it on an H100: bytes.  Each valid slot's row (d x 4 B) is read
// once and nothing reuses it; the arithmetic is 3 flops an element for l2.
// A masked slot loads nothing (its score is +inf whatever its row holds), so
// the floor counts the valid slots' rows only.  The design is kernel B's
// (fused_query.cu) without the gather, and its scoring loop is B's
// (pair_score.cuh staged_scores): one block of 256 threads per query, the
// query (and chi2's own terms) in shared memory; each warp takes slots in
// turn, a slot's contiguous row staged in shared memory with cp.async one
// slot ahead of the one being scored, and read as float4 groups where d %
// 4 == 0 and the rows are 16-byte aligned, else one element a lane; a
// 256-slot tile's scores land in shared memory and those that beat the
// running k-th best merge, by rank, into the running top-k in shared
// memory.  So a pair's score is B's bit for bit, and chi2 on ISS-595 sheds
// what it cost B (fused_query.cu): the division waiting on loads, and 0 /
// 1e-12 on the slow path.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pair_score.cuh"

#define THREADS 256
#define WARPS (THREADS / 32)
#define TILE 256
#define KMAX 128

// (score, id, slot): the slot makes every key unique, so ranks are a
// permutation
__device__ __forceinline__ bool key_less(float da, int ia, int sa, float db, int ib,
                                         int sb) {
  return da < db || (da == db && (ia < ib || (ia == ib && sa < sb)));
}

// ROUNDS: the launch is a round of a larger k (a lower key or last_s is
// given); a single-round launch compiles without the lower-key test
template <int METRIC, bool VEC4, bool ROUNDS>
__global__ void __launch_bounds__(THREADS)
    distance_topk_kernel(const float* __restrict__ q, const float* __restrict__ cand,
                         const int* __restrict__ ids, const unsigned char* __restrict__ mask,
                         const float* __restrict__ lo_d, const int* __restrict__ lo_i,
                         const int* __restrict__ lo_s, float* __restrict__ out_d,
                         int* __restrict__ out_i, int* __restrict__ last_s, int M, int d,
                         int k) {
  // dynamic: the query, chi2's own terms, then each warp's ring
  extern __shared__ __align__(16) float smem[];
  __shared__ float tile_d[TILE];
  __shared__ int tile_i[TILE];
  __shared__ float surv_d[TILE];
  __shared__ int surv_i[TILE], surv_s[TILE];
  __shared__ float run_d[KMAX], nxt_d[KMAX];
  __shared__ int run_i[KMAX], run_s[KMAX], nxt_i[KMAX], nxt_s[KMAX];
  __shared__ int n_surv;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int* ids_b = ids + (size_t)b * M;
  const unsigned char* mask_b = mask + (size_t)b * M;
  const float* cand_b = cand + (size_t)b * M * d;
  const int dp = (d + 3) & ~3;
  float* qs = smem;
  float* tt = qs + dp;
  float* ring = tt + (METRIC == CHI2 ? dp : 0) + warp * STAGES * stage_stride(d);

  for (int c = tid; c < d; c += THREADS) {
    const float x = q[(size_t)b * d + c];
    qs[c] = x;
    if (METRIC == CHI2) tt[c] = own_term(x);
  }
  if (tid < k) {  // distinct (+inf, beyond-M) keys
    run_d[tid] = INFINITY;
    run_i[tid] = 0x7fffffff;
    run_s[tid] = M + tid;
  }
  if (tid == 0) n_surv = 0;
  __syncthreads();

  for (int base = 0; base < M; base += TILE) {
    // ---- score the tile: warp w owns slots base + 32w .. base + 32w + 31
    const int first = base + warp * 32;
    const bool my_ok = first + lane < M && mask_b[first + lane];
    // a masked slot: no load, +inf
    const unsigned ok = __ballot_sync(0xffffffffu, my_ok);
    tile_d[tid] = staged_scores<METRIC, VEC4>(
        qs, tt, ring, d, lane, ok,
        [&](int i) { return cand_b + (size_t)(first + i) * d; });
    tile_i[tid] = my_ok ? ids_b[first + lane] : 0;
    __syncthreads();

    // ---- keep only finite scores that beat the running k-th best
    {
      const float s = tile_d[tid];
      const int id = tile_i[tid];
      const int slot = base + tid;
      if (isfinite(s) && key_less(s, id, slot, run_d[k - 1], run_i[k - 1], run_s[k - 1]) &&
          (!ROUNDS || lo_d == nullptr || key_less(lo_d[b], lo_i[b], lo_s[b], s, id, slot))) {
        const int pos = atomicAdd(&n_surv, 1);
        surv_d[pos] = s;
        surv_i[pos] = id;
        surv_s[pos] = slot;
      }
    }
    __syncthreads();

    // ---- rank-merge survivors into the running top-k
    const int ns = n_surv;
    if (ns > 0) {
      if (tid < ns) {
        const float s = surv_d[tid];
        const int id = surv_i[tid], slot = surv_s[tid];
        int rank = 0;
        for (int j = 0; j < k; ++j) rank += key_less(run_d[j], run_i[j], run_s[j], s, id, slot);
        for (int j = 0; j < ns; ++j)
          rank += key_less(surv_d[j], surv_i[j], surv_s[j], s, id, slot);
        if (rank < k) {
          nxt_d[rank] = s;
          nxt_i[rank] = id;
          nxt_s[rank] = slot;
        }
      }
      if (tid < k) {
        const float s = run_d[tid];
        const int id = run_i[tid], slot = run_s[tid];
        int rank = tid;
        for (int j = 0; j < ns; ++j)
          rank += key_less(surv_d[j], surv_i[j], surv_s[j], s, id, slot);
        if (rank < k) {
          nxt_d[rank] = s;
          nxt_i[rank] = id;
          nxt_s[rank] = slot;
        }
      }
      __syncthreads();
      if (tid < k) {
        run_d[tid] = nxt_d[tid];
        run_i[tid] = nxt_i[tid];
        run_s[tid] = nxt_s[tid];
      }
    }
    if (tid == 0) n_surv = 0;
    __syncthreads();
  }

  if (tid < k) {
    const float s = run_d[tid];
    out_d[(size_t)b * k + tid] = s;
    out_i[(size_t)b * k + tid] = isinf(s) ? -1 : run_i[tid];
    if (ROUNDS && last_s != nullptr && tid == k - 1) last_s[b] = run_s[tid];
  }
}

template <int METRIC, bool VEC4, bool ROUNDS>
static int launch(const float* q, const float* cand, const int* ids,
                  const unsigned char* mask, const float* lo_d, const int* lo_i,
                  const int* lo_s, float* out_d, int* out_i, int* last_s, int B, int M, int d,
                  int k, cudaStream_t stream) {
  auto kernel = distance_topk_kernel<METRIC, VEC4, ROUNDS>;
  const size_t smem = staged_smem_bytes(d, METRIC == CHI2, WARPS);
  if (smem > 32 * 1024) {  // with the static tiles, past the 48 KB a block gets unasked
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<B, THREADS, smem, stream>>>(q, cand, ids, mask, lo_d, lo_i, lo_s, out_d, out_i,
                                       last_s, M, d, k);
  return (int)cudaGetLastError();
}

template <int METRIC, bool ROUNDS>
static int launch_vec(const float* q, const float* cand, const int* ids,
                      const unsigned char* mask, const float* ld, const int* li, const int* ls,
                      float* out_d, int* out_i, int* os, int B, int M, int d, int k,
                      cudaStream_t s) {
  if (d % 4 == 0 && (uintptr_t)cand % 16 == 0)
    return launch<METRIC, true, ROUNDS>(q, cand, ids, mask, ld, li, ls, out_d, out_i, os, B, M,
                                        d, k, s);
  return launch<METRIC, false, ROUNDS>(q, cand, ids, mask, ld, li, ls, out_d, out_i, os, B, M,
                                       d, k, s);
}

template <int METRIC>
static int launch_metric(const float* q, const float* cand, const int* ids,
                         const unsigned char* mask, const float* ld, const int* li,
                         const int* ls, float* out_d, int* out_i, int* os, int B, int M, int d,
                         int k, cudaStream_t s) {
  if (ld != nullptr || os != nullptr)
    return launch_vec<METRIC, true>(q, cand, ids, mask, ld, li, ls, out_d, out_i, os, B, M, d,
                                    k, s);
  return launch_vec<METRIC, false>(q, cand, ids, mask, ld, li, ls, out_d, out_i, os, B, M, d, k,
                                   s);
}

// lo_d / lo_i / lo_s (B,) may be null (no lower key); last_s (B,) may be null
extern "C" int distance_topk(const void* q, const void* cand, const void* ids,
                             const void* mask, const void* lo_d, const void* lo_i,
                             const void* lo_s, void* out_d, void* out_i, void* last_s, int B,
                             int M, int d, int k, int metric, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (k < 1 || k > KMAX || d < 1) return (int)cudaErrorInvalidValue;
  const float* qf = (const float*)q;
  const float* cf = (const float*)cand;
  const int* ii = (const int*)ids;
  const unsigned char* mm = (const unsigned char*)mask;
  const float* ld = (const float*)lo_d;
  const int* li = (const int*)lo_i;
  const int* ls = (const int*)lo_s;
  float* od = (float*)out_d;
  int* oi = (int*)out_i;
  int* os = (int*)last_s;
  cudaStream_t s = (cudaStream_t)stream;
  switch (metric) {
    case L2: return launch_metric<L2>(qf, cf, ii, mm, ld, li, ls, od, oi, os, B, M, d, k, s);
    case CHI2: return launch_metric<CHI2>(qf, cf, ii, mm, ld, li, ls, od, oi, os, B, M, d, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
