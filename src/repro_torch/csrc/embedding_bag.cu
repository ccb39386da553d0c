// Weighted multi-hot embedding bag: kernel H of the port.
//
// Replaces the TPU kernel repro/kernels/embedding_bag.py (embedding_bag,
// pallas_call at :54, body _kernel at :31), reached through
// ops.embedding_bag.
//
// Contract (plain version: repro_torch/kernels/ref.py embedding_bag_ref):
//   ids (B, H) int32, weights (B, H) f32, table (V, D) f32 -> out (B, D)
//   f32, out[b] = sum over h of weights[b, h] * table[ids[b, h]] in fp32.
//   The product w * row is rounded on its own (__fmul_rn, no FMA) and taken
//   for every slot: padding is id 0 with weight 0, as in the reference, so a
//   row holding a NaN or an inf propagates as it does there.  An id outside
//   [0, V) is clamped, as the reference's gather clamps it.
//
// Sum order (fixed, not the reference's h order): a bag's H slots are cut
// into wpb contiguous ranges, one per warp; a lane sums every R-th slot of
// its warp's range in h order (R rows a warp-step, below); the R partial
// sums are added pairwise (a butterfly over the lanes of one column), then
// the wpb warps' sums in warp order.
//
// What bounds it on an H100: bytes at many bags, latency at few.  Each slot
// reads one table row (256 B at the MIND width D = 64) and does 2 flops an
// element with it; at 512 bags the whole call is a few MB and the time is
// the chain of dependent device-memory round trips (ids, then rows).  The
// design: the row is split into 16-byte chunks (scalars when D % 4 != 0 or
// the table is not 16-byte aligned) over lpr lanes, the next power of two
// at or above the chunk count (16 at D = 64), so a warp-step covers R = 32
// / lpr slots and every lane works.  Each lane issues U = 8 row loads into
// registers before it adds any of them in, so 16 rows a warp are in flight
// at D = 64.  Ids and weights are read 32 at a time, one a lane, and passed
// round with shuffles.  The launch shape comes from B and the card's SM
// count (launch_shape, below): at few bags a bag is split over wpb = 2, 4
// or 8 warps of one block, which meet in shared memory, so 512 bags fill
// the card with 256 blocks and each warp's rows go out in one batch; at
// many bags one warp takes a bag.  Nothing but the (B, D) output is written.
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define WARPS (THREADS / 32)
#define U 8             // warp-steps whose row loads a lane keeps in flight
#define SMEM_MAX 49152  // the reduction's shared memory: WARPS * D floats

template <bool VEC4>
__global__ void __launch_bounds__(THREADS)
    embedding_bag_kernel(const int* __restrict__ ids, const float* __restrict__ w,
                         const float* __restrict__ table, float* __restrict__ out, int B,
                         int H, int V, int D, int wpb) {
  extern __shared__ __align__(16) float parts[];  // [WARPS][D] when wpb > 1
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gw = blockIdx.x * WARPS + warp;
  const int bag = gw / wpb, part = gw % wpb;  // a bag's warps share a block
  const bool live = bag < B;                  // warp-uniform
  const int width = VEC4 ? D / 4 : D;         // chunks of a row
  int lpr = 1;                                // lanes a row
  while (lpr < width && lpr < 32) lpr <<= 1;
  const int R = 32 / lpr;                     // slots a warp-step
  const int sub = lane / lpr, col = lane % lpr;
  // the warp's slots [hs, he): whole warp-steps, as even as they split
  const int steps = (H + R - 1) / R;
  const int per_warp = (steps + wpb - 1) / wpb;
  const int hs = min(H, part * per_warp * R), he = min(H, (part + 1) * per_warp * R);
  const int* ids_b = ids + (size_t)bag * H;
  const float* w_b = w + (size_t)bag * H;
  float* my_part = parts + warp * D;

  for (int c0 = 0; c0 < width; c0 += lpr) {
    const int c = c0 + col;
    const bool active = live && c < width;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int h0 = hs; live && h0 < he; h0 += 32) {
      const int n = min(32, he - h0);
      const int my_id = lane < n ? min(max(__ldg(ids_b + h0 + lane), 0), V - 1) : 0;
      const float my_w = lane < n ? __ldg(w_b + h0 + lane) : 0.f;
      for (int j0 = 0; j0 < n; j0 += U * R) {
        float4 r[U];
        float wv[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = j0 + u * R + sub;
          const int id = __shfl_sync(0xffffffffu, my_id, j & 31);
          wv[u] = __shfl_sync(0xffffffffu, my_w, j & 31);
          r[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (active && j < n) {
            if (VEC4) r[u] = __ldg(reinterpret_cast<const float4*>(table + (size_t)id * D) + c);
            else r[u].x = __ldg(table + (size_t)id * D + c);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (!active || j0 + u * R + sub >= n) continue;
          acc.x += __fmul_rn(wv[u], r[u].x);
          if (VEC4) {
            acc.y += __fmul_rn(wv[u], r[u].y);
            acc.z += __fmul_rn(wv[u], r[u].z);
            acc.w += __fmul_rn(wv[u], r[u].w);
          }
        }
      }
    }
    for (int o = lpr; o < 32; o <<= 1) {  // the R partial sums, pairwise
      acc.x += __shfl_xor_sync(0xffffffffu, acc.x, o);
      acc.y += __shfl_xor_sync(0xffffffffu, acc.y, o);
      acc.z += __shfl_xor_sync(0xffffffffu, acc.z, o);
      acc.w += __shfl_xor_sync(0xffffffffu, acc.w, o);
    }
    if (!active || sub != 0) continue;
    if (wpb == 1) {
      if (VEC4) reinterpret_cast<float4*>(out + (size_t)bag * D)[c] = acc;
      else out[(size_t)bag * D + c] = acc.x;
    } else if (VEC4) {
      reinterpret_cast<float4*>(my_part)[c] = acc;
    } else {
      my_part[c] = acc.x;
    }
  }
  if (wpb == 1) return;  // uniform over the launch
  __syncthreads();
  if (!live || part != 0) return;
  // the bag's first warp adds the wpb warps' sums in warp order
  for (int e = lane; e < D; e += 32) {
    float s = my_part[e];
    for (int p = 1; p < wpb; ++p) s += my_part[p * D + e];
    out[(size_t)bag * D + e] = s;
  }
}

__global__ void empty_kernel() {}

// Warps a bag and blocks for B bags of H slots and width D on the current
// device.  A bag takes the fewest warps (1, 2, 4 or 8) that give the card
// WARPS warps an SM, but never so many that a warp's share of the slots
// falls under half a batch (U / 2 warp-steps), and only while the block's
// partial sums (WARPS * D floats) fit in SMEM_MAX: at 512 bags of 50 slots
// and D = 64 on 132 SMs, 4 warps a bag and 256 blocks; at 262,144 bags, 1.
static cudaError_t launch_shape(int B, int H, int D, int* wpb, int* blocks) {
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int width = D % 4 == 0 ? D / 4 : D;
  int lpr = 1;
  while (lpr < width && lpr < 32) lpr <<= 1;
  const int steps = (H + 32 / lpr - 1) / (32 / lpr);
  int w = 1;
  while (w < WARPS && (long long)B * w < (long long)WARPS * n_sm && WARPS * D * 4 <= SMEM_MAX &&
         (steps + 2 * w - 1) / (2 * w) >= U / 2)
    w <<= 1;
  *wpb = w;
  *blocks = (int)(((long long)B * w + WARPS - 1) / WARPS);
  return cudaSuccess;
}

extern "C" int embedding_bag(const void* ids, const void* weights, const void* table,
                             void* out, int B, int H, int V, int D, void* stream) {
  if (B == 0 || D == 0) return (int)cudaSuccess;
  if (V < 1 || H < 0) return (int)cudaErrorInvalidValue;
  int wpb = 1, blocks = 0;
  cudaError_t err = launch_shape(B, H, D, &wpb, &blocks);
  if (err != cudaSuccess) return (int)err;
  const int smem = wpb == 1 ? 0 : WARPS * D * 4;  // within SMEM_MAX
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec4 = D % 4 == 0 && (uintptr_t)table % 16 == 0 && (uintptr_t)out % 16 == 0;
  if (vec4)
    embedding_bag_kernel<true><<<blocks, THREADS, smem, s>>>(
        (const int*)ids, (const float*)weights, (const float*)table, (float*)out, B, H, V, D,
        wpb);
  else
    embedding_bag_kernel<false><<<blocks, THREADS, smem, s>>>(
        (const int*)ids, (const float*)weights, (const float*)table, (float*)out, B, H, V, D,
        wpb);
  return (int)cudaGetLastError();
}

// The launch shape embedding_bag takes for (B, H, D): shape[0] warps a bag,
// shape[1] blocks.
extern "C" int embedding_bag_shape(int B, int H, int D, int* shape) {
  return (int)launch_shape(B, H, D, shape, shape + 1);
}

// An empty kernel on the blocks embedding_bag launches for (B, H, D): the
// launch latency floor chip_smoke.py times beside kernel H.
extern "C" int embedding_bag_empty(int B, int H, int D, void* stream) {
  int wpb = 1, blocks = 0;
  cudaError_t err = launch_shape(B, H, D, &wpb, &blocks);
  if (err != cudaSuccess) return (int)err;
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  empty_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
