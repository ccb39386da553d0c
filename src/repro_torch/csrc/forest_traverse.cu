// Forest descent with multi-probe alternates: kernel A of the port.
//
// Replaces the TPU kernel repro/kernels/forest_traverse_hbm.py
// (forest_traverse_hbm, pallas_call at :158, body _kernel at :49).
//
// Contract (plain version: repro_torch/kernels/ref.py forest_traverse_ref):
//   feat int32, thresh f32, child_base int32, each (L, max_nodes) row-major;
//   q (B, d) f32 -> out (L, B, P) int32, the descent of descent.cuh (shared
//   with kernel F, forest_traverse_smem.cu) for every (tree, query), bitwise
//   equal to the plain version.
//
// What bounds it on an H100: latency, not bandwidth.  Each level is a chain
// of dependent loads -- the node's child_base / feat / thresh, then q[b, feat]
// -- 16 B per (tree, query, level reached), a few tens of MB for a whole
// 1024-query batch over 80 trees.  So the floor is about (levels reached) x
// (device-memory latency) per thread, and the design keeps as many chains in
// flight as possible: one thread per (tree, query), a grid of (ceil(B/128),
// L) blocks, no shared memory, so tens of thousands of independent descents
// overlap their latencies.  The TPU kernel's VMEM->SMEM bounce and record
// double buffer were DMA mechanics with no counterpart here.
#include <cuda_runtime.h>

#include "descent.cuh"

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
  descend_one(feat + tree, thresh + tree, child_base + tree, q + (size_t)b * d,
              out + ((size_t)l * B + b) * P, max_depth, P);
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
