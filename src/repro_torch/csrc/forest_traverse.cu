// Forest descent with multi-probe alternates: kernel A of the port.
//
// Replaces the TPU kernel repro/kernels/forest_traverse_hbm.py
// (forest_traverse_hbm, pallas_call at :158, body _kernel at :49).
//
// Contract (plain version: repro_torch/kernels/ref.py forest_traverse_ref):
//   feat int32, thresh f32, child_base int32, each (L, max_nodes) row-major;
//   q (B, d) f32 -> out (L, B, P) int32, the descent of descent.cuh (shared
//   with kernel F, forest_traverse_smem.cu) for every (tree, query), bitwise
//   equal to the plain version, for any max_depth and any P.
//
// What bounds it on an H100: scattered 4-byte loads, not bandwidth and not
// one chain's latency.  Each level loads the node's child_base / feat /
// thresh together, then q[b, feat], 16 B per (tree, query, level reached);
// below the first few levels no two threads of a warp share a 32-byte
// sector, so the sectors moved from L2 (and the L1 wavefronts) set the
// pace, and the design moves fewer of them.  One thread descends one
// (tree, query) through descent.cuh: no margin array in local memory, and
// alternates that start at their flips (no second walk of the shared
// prefix) and run interleaved.  A block takes 512 or 1024 queries of one
// tree, so the tree's upper levels, which all its queries walk, are read
// from L1 by four to eight times as many threads as in 128-query blocks.
// Measured on an H100 (PERF.md, chip_split.py): 128-query blocks, and
// lanes over trees with the queries' rows in shared memory, ran slower; so
// did the tree's top levels copied into shared memory.  A packed 16-byte
// node record (one sector a level instead of three) would save 4-20% more
// but needs a second copy of the forest.  The TPU kernel's VMEM->SMEM
// bounce and record double buffer were DMA mechanics with no counterpart
// here.
#include <cuda_runtime.h>

#include "descent.cuh"

// queries a block, all on one tree: 512 for the primary descent alone, 1024
// with alternates, each the faster at its P (chip_split.py)
#define THREADS_OF(NA) ((NA) == 0 ? 512 : 1024)

template <int NA, int THREADS>
__global__ void __launch_bounds__(THREADS)
    forest_traverse_kernel(const int* __restrict__ feat, const float* __restrict__ thresh,
                           const int* __restrict__ child_base, const float* __restrict__ q,
                           int* __restrict__ out, int n_nodes, int B, int d, int max_depth,
                           int P) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  const int l = blockIdx.y;
  const size_t off = (size_t)l * n_nodes;
  const float* qb = q + (size_t)b * d;
  int* o = out + ((size_t)l * B + b) * P;
  if (b >= B) return;
  descend_one<NA>(GlobalTree{feat + off, thresh + off, child_base + off}, qb, o, max_depth, P);
}

extern "C" int forest_traverse(const void* feat, const void* thresh, const void* child_base,
                               const void* q, void* out, int L, int n_nodes, int B, int d,
                               int max_depth, int P, void* stream) {
  if (L == 0 || B == 0) return (int)cudaSuccess;
  if (n_nodes < 1 || P < 1 || L > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(NA)                                                                           \
  forest_traverse_kernel<NA, THREADS_OF(NA)>                                                 \
      <<<dim3((B + THREADS_OF(NA) - 1) / THREADS_OF(NA), L), THREADS_OF(NA), 0, s>>>(        \
          (const int*)feat, (const float*)thresh, (const int*)child_base, (const float*)q,   \
          (int*)out, n_nodes, B, d, max_depth, P)
  DESCENT_DISPATCH(P, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}
