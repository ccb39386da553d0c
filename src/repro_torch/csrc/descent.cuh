// The K = 1 descent of one query through one tree, with multi-probe
// alternates: the code kernels A (forest_traverse.cu, the tree in device
// memory) and F (forest_traverse_smem.cu, the tree in shared memory) share,
// so the two are bitwise equal by construction.
//
// f_t / th_t / cb_t point at one tree's feat / thresh / child_base (device
// or shared memory), qb at the query's row, o at its P output slots.  Probe
// 0 is the primary leaf; probe p >= 1 re-descends with the decision flipped
// at the p-th smallest margin |q[feat] - thresh| of the primary path (a
// strict < scan, so ties go to the shallower depth); -1 once no finite
// margin is left.  The float operations are the reference's exactly
// (`xv >= t`, and `fabsf(xv - t)` only at internal nodes, nothing to
// contract into an FMA).  The primary path's margins stay in a per-thread
// array (local memory, L1-cached) of DESCENT_MAX_DEPTH levels; the wrappers
// refuse deeper trees.
#pragma once
#include <math.h>

#define DESCENT_MAX_DEPTH 128

__device__ __forceinline__ void descend_one(const int* __restrict__ f_t,
                                            const float* __restrict__ th_t,
                                            const int* __restrict__ cb_t,
                                            const float* __restrict__ qb,
                                            int* __restrict__ o, int max_depth,
                                            int P) {
  float margin[DESCENT_MAX_DEPTH];
  int node = 0;
  int t = 0;
  for (; t < max_depth; ++t) {
    const int cb = cb_t[node];
    if (cb < 0) break;  // at a leaf: every deeper level keeps the node
    const float th = th_t[node];
    const float xv = qb[f_t[node]];
    margin[t] = fabsf(xv - th);
    node = cb + (xv >= th ? 1 : 0);
  }
  for (int u = t; u < max_depth; ++u) margin[u] = INFINITY;
  o[0] = node;

  for (int p = 1; p < P; ++p) {
    // next-smallest margin; strict < keeps the shallower depth on ties
    float best = INFINITY;
    int flip = -1;
    for (int u = 0; u < max_depth; ++u) {
      if (margin[u] < best) {
        best = margin[u];
        flip = u;
      }
    }
    if (!(best < INFINITY)) {  // no finite margin left: this and later -1
      for (; p < P; ++p) o[p] = -1;
      break;
    }
    margin[flip] = INFINITY;
    int alt = 0;
    for (int u = 0; u < max_depth; ++u) {
      const int cb = cb_t[alt];
      if (cb < 0) break;
      const float xv = qb[f_t[alt]];
      bool right = xv >= th_t[alt];
      if (u == flip) right = !right;
      alt = cb + (right ? 1 : 0);
    }
    o[p] = alt;
  }
}
