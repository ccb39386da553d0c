// Kernel B's per-pair score, shared by its gather (fused_query.cu) and its
// query-tiled scan (fused_scan.cu), so that both give a (query, row) pair
// the same bits.
//
// The order of a pair's sum.  The d elements are dealt to 32 lane classes:
// with W = 4 (d % 4 == 0) class l takes the float4 groups l, l + 32, l + 64,
// ... (elements 4g .. 4g + 3 of group g, x, y, z, w in turn); with W = 1
// class l takes the elements l, l + 32, ...  Each class's partial starts
// at +0 and adds accum<METRIC>(query element, row element) term by term in
// that order.  The 32 partials are then summed as the xor butterfly over
// offsets 16, 8, 4, 2, 1 sums them (warp_sum): level one adds classes l and
// l + 16, level two those results for l and l + 8, and so on.  IEEE
// addition is commutative, so every lane of the butterfly ends with the
// same bits, and a thread that holds the 32 partials one after another
// rebuilds that tree with tree_fold, taking the classes in bit-reversed
// order (0, 16, 8, 24, 4, ...) and keeping five partial sums.
//
// The gather (kernel B, and kernel G over pre-gathered rows) runs one class
// a lane, then warp_sum: B's l2, dot and cosine over rows read straight
// from device memory (direct_scores), B's chi2 and G over rows staged in
// shared memory (staged_scores); the scan runs a whole class for a tile of
// pairs at a time (accum in that order, then tree_fold).  Cosine's row
// norm sum(y * y) and query norm are taken apart from the pair, in the
// same orders (row_sq_partial, norm_partial).  The gather's chi2 adds a
// row element of +-0's term as the query's own (accum_chi2): the same bits
// as accum's.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

#define EPS 1e-12f

enum Metric { L2 = 0, DOT = 1, CHI2 = 2, COSINE = 3 };

// one term: a is the pair's partial, c cosine's sum(y * y)
template <int METRIC>
__device__ __forceinline__ void accum(float x, float y, float& a, float& c) {
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

// lane class `lane`'s partials of the pair (qs, row): a, and cosine's c
template <int METRIC, bool VEC4>
__device__ __forceinline__ void lane_partial(const float* qs, const float* row, int d, int lane,
                                             float& a, float& c) {
  if (VEC4) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const float4* q4 = reinterpret_cast<const float4*>(qs);
    for (int g = lane; g < (d >> 2); g += 32) {
      const float4 y = __ldg(r4 + g);
      const float4 x = q4[g];
      accum<METRIC>(x.x, y.x, a, c);
      accum<METRIC>(x.y, y.y, a, c);
      accum<METRIC>(x.z, y.z, a, c);
      accum<METRIC>(x.w, y.w, a, c);
    }
  } else {
    for (int e = lane; e < d; e += 32) accum<METRIC>(qs[e], __ldg(row + e), a, c);
  }
}

// lane_partial of G pairs (qs, rows[u]) at once, for u < n (the others add
// nothing and load nothing): each pair's terms in lane_partial's order, the
// rows' loads of a step issued before any of their terms
template <int METRIC, bool VEC4, int G>
__device__ __forceinline__ void group_partials(const float* qs, const float* const (&rows)[G],
                                               int n, int d, int lane, float (&a)[G],
                                               float (&c)[G]) {
  if (VEC4) {
    const float4* q4 = reinterpret_cast<const float4*>(qs);
    for (int g = lane; g < (d >> 2); g += 32) {
      float4 y[G];
#pragma unroll
      for (int u = 0; u < G; ++u)
        y[u] = u < n ? __ldg(reinterpret_cast<const float4*>(rows[u]) + g)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 x = q4[g];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        accum<METRIC>(x.x, y[u].x, a[u], c[u]);
        accum<METRIC>(x.y, y[u].y, a[u], c[u]);
        accum<METRIC>(x.z, y[u].z, a[u], c[u]);
        accum<METRIC>(x.w, y[u].w, a[u], c[u]);
      }
    }
  } else {
    for (int e = lane; e < d; e += 32) {
      float y[G];
#pragma unroll
      for (int u = 0; u < G; ++u) y[u] = u < n ? __ldg(rows[u] + e) : 0.f;
      const float x = qs[e];
#pragma unroll
      for (int u = 0; u < G; ++u) accum<METRIC>(x, y[u], a[u], c[u]);
    }
  }
}

// lane class `lane`'s partial of a row's sum(y * y), as accum<COSINE> adds it
template <bool VEC4>
__device__ __forceinline__ float row_sq_partial(const float* row, int d, int lane) {
  float c = 0.f;
  if (VEC4) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    for (int g = lane; g < (d >> 2); g += 32) {
      const float4 y = __ldg(r4 + g);
      c += y.x * y.x;
      c += y.y * y.y;
      c += y.z * y.z;
      c += y.w * y.w;
    }
  } else {
    for (int e = lane; e < d; e += 32) {
      const float y = __ldg(row + e);
      c += y * y;
    }
  }
  return c;
}

// lane `lane`'s partial of a query's |x|^2 (always one element a class)
__device__ __forceinline__ float norm_partial(const float* x, int d, int lane) {
  float s = 0.f;
  for (int e = lane; e < d; e += 32) s += x[e] * x[e];
  return s;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Fold the partial v of lane class brev5(p), the p-th in bit-reversed order,
// into a pair's five partial sums; at p = 31 it returns warp_sum's value.
__device__ __forceinline__ float tree_fold(float v, float (&stk)[5], int p) {
#pragma unroll
  for (int lvl = 0; lvl < 5; ++lvl) {
    if (!((p >> lvl) & 1)) {
      stk[lvl] = v;
      return v;
    }
    v = stk[lvl] + v;
  }
  return v;
}

// the pair's score from its summed a, cosine's summed c and the query norm
// sqrtf(|x|^2) + EPS
template <int METRIC>
__device__ __forceinline__ float finish(float a, float c, float q_norm) {
  if (METRIC == DOT) return -a;
  if (METRIC == COSINE) return 1.f - a / (q_norm * (sqrtf(c) + EPS));
  return a;
}

// The scores of a warp's 32 slots, each row read straight from device
// memory: lane i returns slot i's, +inf where bit i of `ok` is clear (no
// load).  row_of(i) is slot i's row (warp-uniform calls only).  Without a
// division the compiler runs a row's loads ahead of its terms, and many
// warps an SM cover the rest of their latency.
template <int METRIC, bool VEC4, typename RowOf>
__device__ __forceinline__ float direct_scores(const float* qs, int d, int lane, unsigned ok,
                                               RowOf row_of, float q_norm) {
  float my_score = INFINITY;
  for (int i = 0; i < 32; ++i) {
    if (!(ok >> i & 1u)) continue;
    float a = 0.f, c = 0.f;
    lane_partial<METRIC, VEC4>(qs, row_of(i), d, lane, a, c);
    a = warp_sum(a);
    if (METRIC == COSINE) c = warp_sum(c);
    if (lane == i) my_score = finish<METRIC>(a, c, q_norm);
  }
  return my_score;
}

// ---- the gather's chi2 term ------------------------------------------------
// IEEE division as PTX's div.rn.f32, which is what `/` compiles to without
// fast math; in asm, the compiler cannot fold the selects of accum_chi2
// into it
__device__ __forceinline__ float div_rn(float a, float b) {
  float r;
  asm("div.rn.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// the query element's own term, its term against a row element of +0 or -0
__device__ __forceinline__ float own_term(float x) { return x * x / (x + EPS); }

// accum<CHI2> where `own` stands in for a row element y of +0 or -0: the
// same bits (for y = +-0, t = x - y and (x + y) + EPS round to x's own
// values; tests/test_torch_chi2_order.py), but such a lane divides 1 by 1.
// Left to the full term it would divide 0 by 1e-12 wherever x is 0 too,
// and that takes the IEEE division's slow path: on ISS-595's rows 71-80%
// of a pair's terms, which a warp whose lanes span d then runs on almost
// every step
__device__ __forceinline__ void accum_chi2(float x, float y, float own, float& a) {
  const bool z = y == 0.f;
  const float t = x - y;
  const float r = div_rn(z ? 1.f : t * t, z ? 1.f : x + y + EPS);
  a += z ? own : r;
}

// ---- the gather's rows, staged through shared memory (B's chi2, and G) -----
// A warp scores the valid slots of its 32 one after another; each slot's
// row is copied into the warp's ring of STAGES buffers with cp.async,
// STAGES - 1 slots ahead of the one being scored, so that a row's loads
// never wait behind the terms of the row before.  A row moves in chunks of
// at most CHUNK elements (one for d <= CHUNK).  A chunk lands at its own
// offset modulo 16 bytes, so its aligned interior moves in 16-byte copies
// and at most 3 elements at either end in 4-byte ones.  CHUNK is a multiple
// of 128: each lane keeps its class across chunks, so the order of sums is
// lane_partial's.
#define STAGES 2
#define CHUNK 1024

// floats a ring buffer holds: a chunk and up to 3 of misalignment
__host__ __device__ inline int stage_stride(int d) {
  return ((d < CHUNK ? d : CHUNK) + 6) & ~3;
}

// a staging block's dynamic shared memory: the query and, under chi2, its
// own terms (each padded to 16 bytes), then `warps` rings
inline size_t staged_smem_bytes(int d, bool chi2, int warps) {
  const size_t dp = (size_t)(d + 3) & ~(size_t)3;
  return sizeof(float) * (dp * (chi2 ? 2 : 1) + (size_t)warps * STAGES * stage_stride(d));
}

__device__ __forceinline__ int misalign(const float* p) {
  return (int)(((uintptr_t)p >> 2) & 3);
}

// n floats from src to buf + misalign(src), over the warp's lanes
__device__ __forceinline__ void stage_chunk(float* buf, const float* src, int n, int lane) {
  float* dst = buf + misalign(src);
  const int head = min((4 - misalign(src)) & 3, n);
  const int n4 = (n - head) >> 2;
  const int tail = head + 4 * n4;
  if (lane < head) cp_async4(dst + lane, src + lane, 4);
  for (int g = lane; g < n4; g += 32) cp_async16(dst + head + 4 * g, src + head + 4 * g);
  if (tail + lane < n) cp_async4(dst + tail + lane, src + tail + lane, 4);
}

// lane class `lane`'s partial (l2 or chi2) over a staged chunk of n
// elements: qs, tt (chi2's own terms) and rs from the chunk's first
// element; float4 reads need rs 16-byte aligned (VEC4: d % 4 == 0 and
// aligned rows)
template <int METRIC, bool VEC4>
__device__ __forceinline__ void staged_partial(const float* qs, const float* tt, const float* rs,
                                               int n, int lane, float& a) {
  static_assert(METRIC == L2 || METRIC == CHI2, "staged rows serve l2 and chi2");
  float c = 0.f;  // accum's cosine sum, unused
  if (VEC4) {
    const float4* r4 = reinterpret_cast<const float4*>(rs);
    const float4* q4 = reinterpret_cast<const float4*>(qs);
    const float4* t4 = reinterpret_cast<const float4*>(tt);
    for (int g = lane; g < (n >> 2); g += 32) {
      const float4 y = r4[g];
      const float4 x = q4[g];
      if (METRIC == CHI2) {
        const float4 o = t4[g];
        accum_chi2(x.x, y.x, o.x, a);
        accum_chi2(x.y, y.y, o.y, a);
        accum_chi2(x.z, y.z, o.z, a);
        accum_chi2(x.w, y.w, o.w, a);
      } else {
        accum<METRIC>(x.x, y.x, a, c);
        accum<METRIC>(x.y, y.y, a, c);
        accum<METRIC>(x.z, y.z, a, c);
        accum<METRIC>(x.w, y.w, a, c);
      }
    }
  } else {
    for (int e = lane; e < n; e += 32) {
      if (METRIC == CHI2) accum_chi2(qs[e], rs[e], tt[e], a);
      else accum<METRIC>(qs[e], rs[e], a, c);
    }
  }
}

// direct_scores over rows staged in shared memory, for l2 and chi2: ring
// is the warp's STAGES x stage_stride(d) floats, 16-byte aligned; qs (and
// tt for chi2) the query in shared memory.
template <int METRIC, bool VEC4, typename RowOf>
__device__ __forceinline__ float staged_scores(const float* qs, const float* tt, float* ring,
                                               int d, int lane, unsigned ok, RowOf row_of) {
  const int stride = stage_stride(d);
  const int n_chunks = (d + CHUNK - 1) / CHUNK;
  unsigned to_copy = ok;  // slots whose rows are not all in flight
  int copy_chunk = 0, copy_buf = 0;
  auto copy_next = [&]() {  // one commit group a call, empty past the last
    if (to_copy) {
      const int i = __ffs(to_copy) - 1;
      const int e0 = copy_chunk * CHUNK;
      stage_chunk(ring + copy_buf * stride, row_of(i) + e0, min(CHUNK, d - e0), lane);
      if (++copy_chunk == n_chunks) {
        copy_chunk = 0;
        to_copy &= to_copy - 1;
      }
    }
    cp_async_commit();
    copy_buf = copy_buf + 1 == STAGES ? 0 : copy_buf + 1;
  };
  for (int s = 0; s < STAGES - 1; ++s) copy_next();

  float my_score = INFINITY, a = 0.f;
  unsigned to_score = ok;
  int chunk = 0, buf = 0;
  while (to_score) {
    copy_next();
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    const int i = __ffs(to_score) - 1;
    const int e0 = chunk * CHUNK;
    const float* rs = ring + buf * stride + misalign(row_of(i) + e0);
    staged_partial<METRIC, VEC4>(qs + e0, tt + e0, rs, min(CHUNK, d - e0), lane, a);
    if (++chunk == n_chunks) {
      chunk = 0;
      to_score &= to_score - 1;
      a = warp_sum(a);
      if (lane == i) my_score = a;
      a = 0.f;
    }
    __syncwarp();  // the buffer is refilled by the next copy_next
    buf = buf + 1 == STAGES ? 0 : buf + 1;
  }
  return my_score;
}
