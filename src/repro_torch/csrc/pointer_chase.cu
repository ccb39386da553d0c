// A fixed pointer chase: the yardstick of kernel A's chain bound, not a
// port of any TPU kernel.
//
// One thread follows next[] for `hops` dependent 4-byte loads and writes
// where it ended, so (time(hops) - time(1)) / (hops - 1) is the latency of
// one dependent load from wherever next[] lives (device memory after an L2
// flush, L2 when warm).  The loads bypass L1 (ld.global.cg), so a warm
// chain reads L2 and not whatever an SM's L1 kept of it.  A descent level of kernel A needs at least one such load
// (its node record, from L2 once the forest is cached), so this latency
// times the levels of a thread's chain bounds the descent from below;
// unlike a chase through kernel A itself, it does not move when kernel A
// changes.
#include <cuda_runtime.h>

__global__ void pointer_chase_kernel(const int* __restrict__ next, int hops,
                                     int* __restrict__ out) {
  int i = 0;
  for (int h = 0; h < hops; ++h) i = __ldcg(next + i);
  out[0] = i;
}

extern "C" int pointer_chase(const void* next, int hops, void* out, void* stream) {
  if (hops < 0) return (int)cudaErrorInvalidValue;
  pointer_chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((const int*)next, hops, (int*)out);
  return (int)cudaGetLastError();
}
