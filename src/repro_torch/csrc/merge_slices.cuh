// The merge of row slices that kernels D (scan_topk.cu) and E
// (chi2_topk.cu) share, and the (score, id) order both keep.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

__device__ __forceinline__ bool lex_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// Merge the n_slices sorted top-k lists of each query: one warp per query,
// lane l walks slice l; each step the warp takes the smallest (score, id)
// head (lane breaks the ties of +inf padding).
__global__ void merge_slices_kernel(const float* __restrict__ part_d,
                                    const int* __restrict__ part_i,
                                    float* __restrict__ out_d, int* __restrict__ out_i,
                                    int B, int k, int n_slices) {
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (b >= B) return;  // warp-uniform
  const size_t base = ((size_t)b * n_slices + lane) * k;
  int ptr = 0;
  float hd = INFINITY;
  int hi = 0x7fffffff;
  if (lane < n_slices) {
    hd = part_d[base];
    hi = part_i[base];
  }
  for (int r = 0; r < k; ++r) {
    float bd = hd;
    int bi = hi, bl = lane;
    for (int o = 16; o > 0; o >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      const int ol = __shfl_xor_sync(0xffffffffu, bl, o);
      if (od < bd || (od == bd && (oi < bi || (oi == bi && ol < bl)))) {
        bd = od;
        bi = oi;
        bl = ol;
      }
    }
    if (lane == 0) {
      out_d[(size_t)b * k + r] = bd;
      out_i[(size_t)b * k + r] = isinf(bd) ? -1 : bi;
    }
    if (lane == bl) {
      ++ptr;
      if (ptr < k) {
        hd = part_d[base + ptr];
        hi = part_i[base + ptr];
      } else {
        hd = INFINITY;
        hi = 0x7fffffff;
      }
    }
  }
}

