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
// the arithmetic is a handful of operations per element.  Reaching the
// byte rate takes about 25 KB of loads in flight on every SM (3.35 TB/s
// times the ~1 us latency of a loaded DRAM read, over 132 SMs).  The
// design:
//   - one block of 128 threads per query, the query in shared memory, and
//     at most 64 registers a thread, so that 8 blocks fit an SM and a
//     batch of up to 1,056 queries runs in one wave;
//   - the valid slots of each 256-slot tile are listed first, and the
//     warps take them in groups of 4: a warp issues all 4 slots' loads
//     (scale, and the lane's 16-byte chunks of the row: chunks lane and
//     lane + 32) before it converts and sums any of them, so 4 rows are
//     in flight per warp and no warp walks an empty slot; the next
//     tile's ids are loaded while this one is scored;
//   - an int8 value v becomes a float without the quarter-rate I2F for
//     three bytes of each word: the byte of w ^ 0x80808080 (v + 128) is
//     placed by PRMT in the mantissa of 2^23, and 2^23 + 128 is
//     subtracted; both steps are exact, so the float is (float)v.  Byte 0
//     keeps I2F.S8 (one instruction, on its own pipe);
//   - rows that are not 16-byte aligned (d % 16 != 0, as d = 595) are read
//     a byte a lane, one slot at a time, as are rows of more than 1024
//     bytes (d / 16 > 64 chunks); an empty slot issues no load;
//   - a tile's scores that beat the running k'-th key are merged by rank
//     into the running top-k' kept in shared memory.  The fp32 row is
//     never read and no dequantized block is ever written.
//
// Rounding: the dequantized value is __fmul_rn(v, s), so nvcc cannot
// contract x - v * s into one FMA; it is rounded exactly as the
// reference's rows.astype(f32) * scale.  Lane l sums its elements in row
// order (chunk l, then chunk l + 32; element l, l + 32, ... on the byte
// path) from +0, then the lanes are added by an xor butterfly (16, 8, 4,
// 2, 1), as in every earlier version of this kernel, so the bits are
// those of every earlier version.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define THREADS 128
#define WARPS (THREADS / 32)
#define TILE 256
#define GROUP 4       // slots whose loads a warp has in flight at once
#define MAX_CHUNKS 64  // 16-byte chunks of a row on the grouped path
#define KMAX 512
#define EPS 1e-12f

enum Metric { L2 = 0, DOT = 1, CHI2 = 2, COSINE = 3 };

template <int METRIC>
__device__ __forceinline__ void accum(float x, float v, float s, float& a, float& c) {
  const float y = __fmul_rn(v, s);
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

// byte j of wb = w ^ 0x80808080 as the float of w's int8 byte j, exactly
__device__ __forceinline__ float byte_value(unsigned wb, int j) {
  return __int_as_float(__byte_perm(wb, 0x4B000000u, 0x7540 + j)) - 8388736.0f;
}

// the 16 elements of one 16-byte chunk, in order; qc: the query's matching
// 16 floats
template <int METRIC>
__device__ __forceinline__ void accum_chunk(const float* qc, int4 v, float s, float& a,
                                            float& c) {
  const unsigned w[4] = {(unsigned)v.x ^ 0x80808080u, (unsigned)v.y ^ 0x80808080u,
                         (unsigned)v.z ^ 0x80808080u, (unsigned)v.w ^ 0x80808080u};
  const float4* q4 = reinterpret_cast<const float4*>(qc);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 x = q4[j];
    accum<METRIC>(x.x, byte_value(w[j], 0), s, a, c);
    accum<METRIC>(x.y, byte_value(w[j], 1), s, a, c);
    accum<METRIC>(x.z, byte_value(w[j], 2), s, a, c);
    accum<METRIC>(x.w, byte_value(w[j], 3), s, a, c);
  }
}

// one 16-byte chunk of each of GROUP rows against the same 16 query floats:
// the rows' sums are independent chains, each in element order
template <int METRIC>
__device__ __forceinline__ void accum_chunks(const float* qc, const int4 (&v)[GROUP],
                                             const float (&s)[GROUP], float (&a)[GROUP],
                                             float (&c)[GROUP]) {
  const float4* q4 = reinterpret_cast<const float4*>(qc);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 x = q4[j];
#pragma unroll
    for (int u = 0; u < GROUP; ++u) {
      const int vj = j == 0 ? v[u].x : j == 1 ? v[u].y : j == 2 ? v[u].z : v[u].w;
      const unsigned w = (unsigned)vj ^ 0x80808080u;
      accum<METRIC>(x.x, (float)(signed char)(vj & 0xff), s[u], a[u], c[u]);  // I2F.S8
      accum<METRIC>(x.y, byte_value(w, 1), s[u], a[u], c[u]);
      accum<METRIC>(x.z, byte_value(w, 2), s[u], a[u], c[u]);
      accum<METRIC>(x.w, byte_value(w, 3), s[u], a[u], c[u]);
    }
  }
}

// the lanes' partial sums -> the slot's score (every lane gets it)
template <int METRIC>
__device__ __forceinline__ float finish(float a, float cc, float q_norm) {
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    if (METRIC == COSINE) cc += __shfl_xor_sync(0xffffffffu, cc, o);
  }
  if (METRIC == DOT) return -a;
  if (METRIC == COSINE) return 1.f - a / (q_norm * (sqrtf(cc) + EPS));
  return a;
}

__device__ __forceinline__ bool lex_less(float da, int sa, float db, int sb) {
  return da < db || (da == db && sa < sb);
}

template <int METRIC, bool VEC16>
__global__ void __launch_bounds__(THREADS, 8)
    fused_gather_topk_int8_kernel(const float* __restrict__ q, const int* __restrict__ ids,
                                  const int8_t* __restrict__ q8,
                                  const float* __restrict__ scale,
                                  const float* __restrict__ lo_d, const int* __restrict__ lo_s,
                                  float* __restrict__ out_d, int* __restrict__ out_i,
                                  int* __restrict__ last_s, int M, int N, int d, int k) {
  extern __shared__ __align__(16) float qs[];
  __shared__ float tile_d[TILE];
  __shared__ float surv_d[TILE];
  __shared__ int surv_s[TILE];
  __shared__ float run_d[KMAX], nxt_d[KMAX];
  __shared__ int run_s[KMAX], nxt_s[KMAX];
  __shared__ int list_slot[TILE], list_id[TILE];  // the tile's valid slots
  __shared__ int n_valid[2 * WARPS];
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
  const float qn = METRIC == COSINE ? q_norm : 0.f;
  const int n_chunks = d >> 4;
  const bool grouped = VEC16 && n_chunks <= MAX_CHUNKS;
  const unsigned below = (1u << lane) - 1u;

  // thread t holds the ids of slots base + t and base + THREADS + t; the
  // next tile's are loaded while this one is scored
  int id0 = tid < M ? ids_b[tid] : -1;
  int id1 = THREADS + tid < M ? ids_b[THREADS + tid] : -1;

  for (int base = 0; base < M; base += TILE) {
    const int nb = base + TILE;
    const int nx0 = nb + tid < M ? ids_b[nb + tid] : -1;
    const int nx1 = nb + THREADS + tid < M ? ids_b[nb + THREADS + tid] : -1;

    // ---- list the tile's valid slots (slot order within each half)
    const unsigned m0 = __ballot_sync(0xffffffffu, id0 >= 0);
    const unsigned m1 = __ballot_sync(0xffffffffu, id1 >= 0);
    if (lane == 0) {
      n_valid[warp] = __popc(m0);
      n_valid[WARPS + warp] = __popc(m1);
    }
    tile_d[tid] = INFINITY;
    tile_d[THREADS + tid] = INFINITY;
    __syncthreads();
    int off0 = 0, nv = 0;
#pragma unroll
    for (int w = 0; w < 2 * WARPS; ++w) {
      off0 += w < warp ? n_valid[w] : 0;
      nv += n_valid[w];
    }
    int off1 = 0;
#pragma unroll
    for (int w = 0; w < WARPS + warp; ++w) off1 += n_valid[w];
    if (id0 >= 0) {
      const int p = off0 + __popc(m0 & below);
      list_slot[p] = tid;
      list_id[p] = id0;
    }
    if (id1 >= 0) {
      const int p = off1 + __popc(m1 & below);
      list_slot[p] = THREADS + tid;
      list_id[p] = id1;
    }
    __syncthreads();

    // ---- score the valid slots: warp w takes groups w, w + WARPS, ... of
    //      GROUP listed slots, issuing the group's loads before any of its
    //      sums; every lane ends with each slot's score
    if (grouped) {
      for (int g = warp * GROUP; g < nv; g += WARPS * GROUP) {
        int id[GROUP];
        float s[GROUP];
        int4 v0[GROUP], v1[GROUP];
#pragma unroll
        for (int u = 0; u < GROUP; ++u) {
          id[u] = g + u < nv ? list_id[g + u] : -1;
          s[u] = 0.f;
          v0[u] = v1[u] = make_int4(0, 0, 0, 0);
          if (id[u] >= 0) {
            const size_t row_id = (size_t)min(id[u], N - 1);
            const int4* r16 = reinterpret_cast<const int4*>(q8 + row_id * d);
            s[u] = __ldg(scale + row_id);
            if (lane < n_chunks) v0[u] = __ldg(r16 + lane);
            if (lane + 32 < n_chunks) v1[u] = __ldg(r16 + lane + 32);
          }
        }
        float a[GROUP], cc[GROUP];
#pragma unroll
        for (int u = 0; u < GROUP; ++u) a[u] = cc[u] = 0.f;
        if (lane < n_chunks) accum_chunks<METRIC>(qs + 16 * lane, v0, s, a, cc);
        if (lane + 32 < n_chunks) accum_chunks<METRIC>(qs + 16 * (lane + 32), v1, s, a, cc);
#pragma unroll
        for (int u = 0; u < GROUP; ++u) {
          const float score = finish<METRIC>(a[u], cc[u], qn);
          if (lane == u && g + u < nv) tile_d[list_slot[g + u]] = score;
        }
      }
    } else {
      for (int p = warp; p < nv; p += WARPS) {
        const int id = list_id[p];
        const size_t row_id = (size_t)min(id, N - 1);
        const int8_t* row = q8 + row_id * d;
        const float s = __ldg(scale + row_id);
        float a = 0.f, cc = 0.f;
        if (VEC16) {
          const int4* r16 = reinterpret_cast<const int4*>(row);
          for (int c = lane; c < n_chunks; c += 32)
            accum_chunk<METRIC>(qs + 16 * c, __ldg(r16 + c), s, a, cc);
        } else {
          for (int c = lane; c < d; c += 32)
            accum<METRIC>(qs[c], (float)__ldg(row + c), s, a, cc);
        }
        const float score = finish<METRIC>(a, cc, qn);
        if (lane == 0) tile_d[list_slot[p]] = score;
      }
    }
    id0 = nx0;
    id1 = nx1;
    __syncthreads();

    // ---- keep only finite scores that beat the running k-th best
    for (int t = tid; t < TILE; t += THREADS) {
      const float s = tile_d[t];
      const int slot = base + t;
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
      for (int t = tid; t < ns; t += THREADS) {
        const float s = surv_d[t];
        const int slot = surv_s[t];
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
  if (smem > 48 * 1024 - 16 * 1024) {  // static tiles take 13 KB of the 48
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // 8 blocks an SM need 8 x 15 KB of shared memory
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
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
