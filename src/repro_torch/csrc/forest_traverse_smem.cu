// Single-tree descent with the tree resident in shared memory: kernel F of
// the port.
//
// Replaces the TPU kernel repro/kernels/forest_traverse.py (forest_traverse,
// pallas_call at :118, body _kernel at :40), reached through
// ops.traverse_tree(kernel="smem" | "auto").
//
// Contract (plain version: repro_torch/kernels/ref.py
// forest_traverse_tree_ref):
//   feat int32, thresh f32, child_base int32, each (n_nodes,); q (B, d) f32
//   -> out (B, P) int32, the descent of descent.cuh (the code kernel A,
//   forest_traverse.cu, runs), so the leaves are bitwise equal to kernel A's
//   and to the plain version.
//
// What bounds it on an H100: latency.  A descent is a chain of dependent
// loads, one level after another.  The TPU kernel put the tree in scalar
// memory; here each block copies the tree's three arrays (12 B a node) into
// dynamic shared memory, so the node record of a level is a shared-memory
// load (~30 cycles) instead of a device-memory one.  What remains in device
// memory is q[b, feat], one dependent load a level.  The copy is cp.async,
// so every thread has its whole share of the tree in flight at once.  A
// block of THREADS threads descends THREADS queries; a tree near the cap
// (227 KB of opt-in shared memory, 19,370 nodes) leaves room for one block
// per SM, so a 1024-query batch fills only 8 SMs: the kernel is built for
// trees reused by few queries, not for throughput.
#include <cuda_runtime.h>

#include "descent.cuh"

#define THREADS 128

__device__ __forceinline__ void copy_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

template <int NA>
__global__ void __launch_bounds__(THREADS)
    forest_traverse_smem_kernel(const int* __restrict__ feat,
                                const float* __restrict__ thresh,
                                const int* __restrict__ child_base,
                                const float* __restrict__ q,
                                int* __restrict__ out, int n_nodes, int B, int d,
                                int max_depth, int P) {
  extern __shared__ int tree[];
  int* s_feat = tree;
  float* s_thresh = (float*)(tree + n_nodes);
  int* s_child = tree + 2 * n_nodes;
  for (int i = threadIdx.x; i < n_nodes; i += THREADS) {
    copy_async4(s_feat + i, feat + i);
    copy_async4(s_thresh + i, thresh + i);
    copy_async4(s_child + i, child_base + i);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  descend_one<NA>(SharedTree{s_feat, s_thresh, s_child}, q + (size_t)b * d,
                  out + (size_t)b * P, max_depth, P);
}

extern "C" int forest_traverse_smem(const void* feat, const void* thresh,
                                    const void* child_base, const void* q,
                                    void* out, int n_nodes, int B, int d,
                                    int max_depth, int P, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (n_nodes < 1 || P < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n_nodes * 12;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(NA)                                                                       \
  do {                                                                                   \
    if (smem > 48 * 1024) {                                                              \
      err = cudaFuncSetAttribute(forest_traverse_smem_kernel<NA>,                        \
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem); \
      if (err != cudaSuccess) return (int)err;                                           \
    }                                                                                    \
    forest_traverse_smem_kernel<NA><<<(B + THREADS - 1) / THREADS, THREADS, smem, s>>>(  \
        (const int*)feat, (const float*)thresh, (const int*)child_base, (const float*)q, \
        (int*)out, n_nodes, B, d, max_depth, P);                                         \
  } while (0)
  DESCENT_DISPATCH(P, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}
