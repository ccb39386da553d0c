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
// The gather runs one class a lane (lane_partial, then warp_sum); the scan
// runs a whole class for a tile of pairs at a time (accum in that order,
// then tree_fold).  Cosine's row norm sum(y * y) and query norm are taken
// apart from the pair, in the same orders (row_sq_partial, norm_partial).
#pragma once
#include <cuda_runtime.h>
#include <math.h>

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
