// Fused int8-row gather + dequantize + distance + running top-k': kernel C
// of the port, the coarse stage of the rpf+int8 backend.
//
// Replaces the TPU kernel repro/kernels/fused_query_int8.py
// (fused_gather_topk_int8, pallas_call at :152, body _kernel at :43).
//
// Contract (plain version: repro_torch/kernels/ref.py
// fused_gather_topk_int8_ref):
//   q (B, d) f32, ids (B, M) int32 with -1 marking empty slots, q8 (N, d)
//   int8, scale (N,) f32 -> out_d (B, k) f32, out_i (B, k) int32: the k
//   smallest scores of the dequantized rows (q8 * scale, one rounded
//   product) under the metric, in (score, slot) order so ties keep the
//   earliest slot like the reference's lax.top_k; +inf / -1 where fewer
//   than k slots score a finite distance.  k <= KMAX = 512; a larger k
//   takes rounds (kernels/common.py topk_rounds): lo_d / lo_s, when given,
//   are each query's exclusive lower key (score, slot), and last_s, when
//   given, receives each query's k-th slot, the next round's key.
//
// What bounds it on an H100: bytes.  Each valid slot reads d + 4 bytes
// (the int8 row and its scale) that nothing else in the block reuses, and
// the arithmetic is a handful of operations per element.  The design is
// kernel B's (csrc/fused_query.cu): one block of 256 threads per query, the
// query in shared memory, each warp takes slots in turn and its lanes read
// the row with coalesced 16-byte loads (16 int8 values) where the rows are
// 16-byte aligned (d % 16 == 0, as at d = 784), byte loads otherwise (d =
// 595); an empty slot issues no load; a tile's scores are merged by rank
// into the running top-k' kept in shared memory.  The fp32 row is never
// read and no dequantized block is ever written.
//
// Rounding: the dequantized value is __fmul_rn(q8, s), so nvcc cannot
// contract x - q8 * s into one FMA; it is rounded exactly as the
// reference's rows.astype(f32) * scale.  The only difference left is the
// order of the d-term sums.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define THREADS 256
#define TILE 256
#define KMAX 512
#define EPS 1e-12f

enum Metric { L2 = 0, DOT = 1, CHI2 = 2, COSINE = 3 };

template <int METRIC>
__device__ __forceinline__ void accum(float x, int v, float s, float& a, float& c) {
  const float y = __fmul_rn((float)v, s);
  if (METRIC == L2) {
    const float t = x - y;
    a += t * t;
  } else if (METRIC == DOT) {
    a += x * y;
  } else if (METRIC == CHI2) {
    const float t = x - y;
    a += t * t / (x + y + EPS);
  } else {
    a += x * y;
    c += y * y;
  }
}

__device__ __forceinline__ bool lex_less(float da, int sa, float db, int sb) {
  return da < db || (da == db && sa < sb);
}

template <int METRIC, bool VEC16>
__global__ void fused_gather_topk_int8_kernel(const float* __restrict__ q,
                                              const int* __restrict__ ids,
                                              const int8_t* __restrict__ q8,
                                              const float* __restrict__ scale,
                                              const float* __restrict__ lo_d,
                                              const int* __restrict__ lo_s,
                                              float* __restrict__ out_d,
                                              int* __restrict__ out_i,
                                              int* __restrict__ last_s, int M, int N,
                                              int d, int k) {
  extern __shared__ __align__(16) float qs[];
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

  for (int c = tid; c < d; c += THREADS) qs[c] = q[(size_t)b * d + c];
  for (int r = tid; r < k; r += THREADS) {  // distinct (+inf, beyond-M) keys
    run_d[r] = INFINITY;
    run_s[r] = M + r;
  }
  if (tid == 0) n_surv = 0;
  __syncthreads();
  if (METRIC == COSINE) {
    if (warp == 0) {
      float s = 0.f;
      for (int c = lane; c < d; c += 32) s += qs[c] * qs[c];
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) q_norm = sqrtf(s) + EPS;
    }
    __syncthreads();
  }
  const bool lower = lo_d != nullptr;
  const float low_d = lower ? lo_d[b] : 0.f;
  const int low_s = lower ? lo_s[b] : 0;

  for (int base = 0; base < M; base += TILE) {
    // ---- score the tile: warp w owns slots base + 32w .. base + 32w + 31
    const int first = base + warp * 32;
    const int my_id = first + lane < M ? ids_b[first + lane] : -1;
    float my_score = INFINITY;
    for (int i = 0; i < 32; ++i) {
      const int id = __shfl_sync(0xffffffffu, my_id, i);
      if (id < 0) continue;  // empty slot: no load, scores +inf
      const size_t row_id = (size_t)min(id, N - 1);
      const int8_t* row = q8 + row_id * d;
      const float s = __ldg(scale + row_id);
      float a = 0.f, cc = 0.f;
      if (VEC16) {
        const int4* r16 = reinterpret_cast<const int4*>(row);
        for (int c = lane; c < (d >> 4); c += 32) {
          const int4 v = __ldg(r16 + c);
          const int w[4] = {v.x, v.y, v.z, v.w};
          const float4* q4 = reinterpret_cast<const float4*>(qs + 16 * c);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 x = q4[j];
            const int u = w[j];
            accum<METRIC>(x.x, (int)(int8_t)(u & 0xff), s, a, cc);
            accum<METRIC>(x.y, (int)(int8_t)((u >> 8) & 0xff), s, a, cc);
            accum<METRIC>(x.z, (int)(int8_t)((u >> 16) & 0xff), s, a, cc);
            accum<METRIC>(x.w, (int)(int8_t)((u >> 24) & 0xff), s, a, cc);
          }
        }
      } else {
        for (int c = lane; c < d; c += 32) accum<METRIC>(qs[c], (int)__ldg(row + c), s, a, cc);
      }
      for (int o = 16; o > 0; o >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, o);
        if (METRIC == COSINE) cc += __shfl_xor_sync(0xffffffffu, cc, o);
      }
      if (lane == i) {
        if (METRIC == DOT) my_score = -a;
        else if (METRIC == COSINE) my_score = 1.f - a / (q_norm * (sqrtf(cc) + EPS));
        else my_score = a;
      }
    }
    tile_d[tid] = my_score;
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
        // the running list is sorted: binary-search the entries below
        int lo = 0, hi = k;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (lex_less(run_d[mid], run_s[mid], s, slot)) lo = mid + 1;
          else hi = mid;
        }
        int rank = lo;
        for (int j = 0; j < ns; ++j) rank += lex_less(surv_d[j], surv_s[j], s, slot);
        if (rank < k) {
          nxt_d[rank] = s;
          nxt_s[rank] = slot;
        }
      }
      for (int r = tid; r < k; r += THREADS) {
        const float s = run_d[r];
        const int slot = run_s[r];
        int rank = r;
        for (int j = 0; j < ns; ++j) rank += lex_less(surv_d[j], surv_s[j], s, slot);
        if (rank < k) {
          nxt_d[rank] = s;
          nxt_s[rank] = slot;
        }
      }
      __syncthreads();
      for (int r = tid; r < k; r += THREADS) {
        run_d[r] = nxt_d[r];
        run_s[r] = nxt_s[r];
      }
    }
    if (tid == 0) n_surv = 0;
    __syncthreads();
  }

  for (int r = tid; r < k; r += THREADS) {
    const float s = run_d[r];
    out_d[(size_t)b * k + r] = s;
    out_i[(size_t)b * k + r] = isinf(s) ? -1 : ids_b[run_s[r]];
    if (last_s != nullptr && r == k - 1) last_s[b] = run_s[r];
  }
}

template <int METRIC, bool VEC16>
static int launch(const float* q, const int* ids, const int8_t* q8, const float* scale,
                  const float* lo_d, const int* lo_s, float* out_d, int* out_i, int* last_s,
                  int B, int M, int N, int d, int k, cudaStream_t stream) {
  auto kernel = fused_gather_topk_int8_kernel<METRIC, VEC16>;
  const size_t smem = (size_t)d * sizeof(float);
  if (smem > 48 * 1024 - 16 * 1024) {  // static tiles take 11 KB of the 48
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<B, THREADS, smem, stream>>>(q, ids, q8, scale, lo_d, lo_s, out_d, out_i, last_s, M,
                                       N, d, k);
  return (int)cudaGetLastError();
}

template <int METRIC>
static int launch_metric(const float* q, const int* ids, const int8_t* q8, const float* sc,
                         const float* ld, const int* ls, float* od, int* oi, int* os, int B,
                         int M, int N, int d, int k, cudaStream_t s) {
  // 16-byte loads need every row on a 16-byte boundary
  if (d % 16 == 0 && ((uintptr_t)q8 & 15) == 0)
    return launch<METRIC, true>(q, ids, q8, sc, ld, ls, od, oi, os, B, M, N, d, k, s);
  return launch<METRIC, false>(q, ids, q8, sc, ld, ls, od, oi, os, B, M, N, d, k, s);
}

// lo_d / lo_s (B,) may be null (no lower key); last_s (B,) may be null
extern "C" int fused_gather_topk_int8(const void* q, const void* ids, const void* q8,
                                      const void* scale, const void* lo_d, const void* lo_s,
                                      void* out_d, void* out_i, void* last_s, int B, int M,
                                      int N, int d, int k, int metric, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (k < 1 || k > KMAX) return (int)cudaErrorInvalidValue;
  const float* qf = (const float*)q;
  const int* ii = (const int*)ids;
  const int8_t* q8b = (const int8_t*)q8;
  const float* sc = (const float*)scale;
  const float* ld = (const float*)lo_d;
  const int* ls = (const int*)lo_s;
  float* od = (float*)out_d;
  int* oi = (int*)out_i;
  int* os = (int*)last_s;
  cudaStream_t s = (cudaStream_t)stream;
  switch (metric) {
    case L2: return launch_metric<L2>(qf, ii, q8b, sc, ld, ls, od, oi, os, B, M, N, d, k, s);
    case DOT: return launch_metric<DOT>(qf, ii, q8b, sc, ld, ls, od, oi, os, B, M, N, d, k, s);
    case CHI2:
      return launch_metric<CHI2>(qf, ii, q8b, sc, ld, ls, od, oi, os, B, M, N, d, k, s);
    case COSINE:
      return launch_metric<COSINE>(qf, ii, q8b, sc, ld, ls, od, oi, os, B, M, N, d, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
