// Forest descent with multi-probe alternates: kernel A of the port.
//
// Replaces the TPU kernel repro/kernels/forest_traverse_hbm.py
// (forest_traverse_hbm, pallas_call at :158, body _kernel at :49).
//
// Contract (plain version: repro_torch/kernels/ref.py forest_traverse_ref):
//   feat int32, thresh f32, child_base int32, each (L, max_nodes) row-major;
//   q (B, d) f32 -> out (L, B, P) int32.  Probe 0 is the primary leaf; probe
//   p >= 1 re-descends with the decision flipped at the p-th smallest margin
//   |q[b, feat] - thresh| of the primary path (ties to the shallower depth);
//   -1 once no finite margin is left.  The float operations are the
//   reference's exactly (`xv >= t`, and `fabsf(xv - t)` only at internal
//   nodes, nothing to contract into an FMA), so the result is bitwise equal
//   to the plain version.
//
// What bounds it on an H100: latency, not bandwidth.  Each level is a chain
// of dependent loads -- the node's child_base / feat / thresh, then q[b, feat]
// -- 16 B per (tree, query, level reached), a few tens of MB for a whole
// 1024-query batch over 80 trees.  So the floor is about (levels reached) x
// (device-memory latency) per thread, and the design keeps as many chains in
// flight as possible: one thread per (tree, query), a grid of (ceil(B/128),
// L) blocks, no shared memory, so tens of thousands of independent descents
// overlap their latencies.  The TPU kernel's VMEM->SMEM bounce and record
// double buffer were DMA mechanics with no counterpart here.  The primary
// path's margins stay in a per-thread array (local memory, L1-cached) whose
// size is the compile-time cap MAX_DEPTH; the wrapper refuses deeper trees.
#include <cuda_runtime.h>
#include <math.h>

#define MAX_DEPTH 128
#define THREADS 128

__global__ void forest_traverse_kernel(const int* __restrict__ feat,
                                       const float* __restrict__ thresh,
                                       const int* __restrict__ child_base,
                                       const float* __restrict__ q,
                                       int* __restrict__ out, int n_nodes,
                                       int B, int d, int max_depth, int P) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  const int l = blockIdx.y;
  if (b >= B) return;
  const size_t tree = (size_t)l * n_nodes;
  const int* f_t = feat + tree;
  const float* th_t = thresh + tree;
  const int* cb_t = child_base + tree;
  const float* qb = q + (size_t)b * d;
  int* o = out + ((size_t)l * B + b) * P;

  float margin[MAX_DEPTH];
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

extern "C" int forest_traverse(const void* feat, const void* thresh,
                               const void* child_base, const void* q,
                               void* out, int L, int n_nodes, int B, int d,
                               int max_depth, int P, void* stream) {
  if (L == 0 || B == 0) return (int)cudaSuccess;
  dim3 grid((B + THREADS - 1) / THREADS, L);
  forest_traverse_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)feat, (const float*)thresh, (const int*)child_base,
      (const float*)q, (int*)out, n_nodes, B, d, max_depth, P);
  return (int)cudaGetLastError();
}
