// Weighted multi-hot embedding bag: kernel H of the port.
//
// Replaces the TPU kernel repro/kernels/embedding_bag.py (embedding_bag,
// pallas_call at :54, body _kernel at :31), reached through
// ops.embedding_bag.
//
// Contract (plain version: repro_torch/kernels/ref.py embedding_bag_ref):
//   ids (B, H) int32, weights (B, H) f32, table (V, D) f32 -> out (B, D)
//   f32, out[b] = sum over h of weights[b, h] * table[ids[b, h]].  The sum
//   runs in h order in fp32, and the product w * row is rounded on its own
//   (__fmul_rn, no FMA) and taken for every slot: padding is id 0 with
//   weight 0, as in the reference, so a row holding a NaN or an inf
//   propagates as it does there.  An id outside [0, V) is clamped, as the
//   reference's gather clamps it.
//
// What bounds it on an H100: bytes.  Each slot reads one table row (D x 4 B,
// 256 B at the MIND width D = 64) and does 2 flops an element with it.  The
// design: one warp per bag, 8 bags a block; the lanes split D into 16-byte
// chunks (scalars when D % 4 != 0 or the table is not 16-byte aligned) and
// each lane keeps its chunk's sum in registers over all H slots.  The
// lanes read 32 slots' ids and weights at once and pass them round with
// shuffles, so the row loads of consecutive slots do not wait on each
// other; nothing but the (B, D) output is written.  At D = 64 half the
// warp's lanes hold a chunk: the loads in flight, not the lanes, set the
// rate.
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define WARPS (THREADS / 32)

template <bool VEC4>
__global__ void __launch_bounds__(THREADS)
    embedding_bag_kernel(const int* __restrict__ ids, const float* __restrict__ w,
                         const float* __restrict__ table, float* __restrict__ out, int B,
                         int H, int V, int D) {
  const int bag = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (bag >= B) return;  // warp-uniform
  const int* ids_b = ids + (size_t)bag * H;
  const float* w_b = w + (size_t)bag * H;
  const int width = VEC4 ? D / 4 : D;  // chunks of a row
  for (int c0 = 0; c0 < width; c0 += 32) {
    const int c = c0 + lane;
    const bool active = c < width;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int h0 = 0; h0 < H; h0 += 32) {
      const int my_id = h0 + lane < H ? min(max(__ldg(ids_b + h0 + lane), 0), V - 1) : 0;
      const float my_w = h0 + lane < H ? __ldg(w_b + h0 + lane) : 0.f;
      const int n = min(32, H - h0);
#pragma unroll 8
      for (int j = 0; j < n; ++j) {
        const int id = __shfl_sync(0xffffffffu, my_id, j);
        const float wj = __shfl_sync(0xffffffffu, my_w, j);
        if (!active) continue;
        if (VEC4) {
          const float4 r = __ldg(reinterpret_cast<const float4*>(table + (size_t)id * D) + c);
          acc.x += __fmul_rn(wj, r.x);
          acc.y += __fmul_rn(wj, r.y);
          acc.z += __fmul_rn(wj, r.z);
          acc.w += __fmul_rn(wj, r.w);
        } else {
          acc.x += __fmul_rn(wj, __ldg(table + (size_t)id * D + c));
        }
      }
    }
    if (active) {
      if (VEC4) reinterpret_cast<float4*>(out + (size_t)bag * D)[c] = acc;
      else out[(size_t)bag * D + c] = acc.x;
    }
  }
}

extern "C" int embedding_bag(const void* ids, const void* weights, const void* table,
                             void* out, int B, int H, int V, int D, void* stream) {
  if (B == 0 || D == 0) return (int)cudaSuccess;
  if (V < 1 || H < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (B + WARPS - 1) / WARPS;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec4 = D % 4 == 0 && (uintptr_t)table % 16 == 0 && (uintptr_t)out % 16 == 0;
  if (vec4)
    embedding_bag_kernel<true><<<blocks, THREADS, 0, s>>>(
        (const int*)ids, (const float*)weights, (const float*)table, (float*)out, B, H, V, D);
  else
    embedding_bag_kernel<false><<<blocks, THREADS, 0, s>>>(
        (const int*)ids, (const float*)weights, (const float*)table, (float*)out, B, H, V, D);
  return (int)cudaGetLastError();
}
