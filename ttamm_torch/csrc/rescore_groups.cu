// Exact scores of each query's selected 128-item groups.
//
// Replaces the TPU kernel `rescore_groups` (ttamm_tpu/ops/pallas/fused_mips.py,
// kernel body `_rescore_kernel`): phase 3 of the fused no-slab search. For
// query b and selected group j, out[b, j*128 + l] = sum_d bf16(q[b, d]) *
// bf16(items[gids[b, j], l, d]), summed in f32. bf16 x bf16 products are exact
// in f32, so the result differs from any other f32 summation only in the
// order of the additions.
//
// What bounds it on Hopper: device-memory bandwidth. Each (query, group) pair
// reads one contiguous [128, D] block (64 KB in f32 at D = 128) and does two
// flops per element read, far below the card's flop-to-byte balance. Only the
// candidates actually needed are read: B * KG * 128 * D elements.
//
// What the design does about it: one block per (query, group) pair. The
// query row is rounded once into shared memory; each warp walks its items
// with consecutive lanes on consecutive d, so every row read is coalesced,
// and finishes each dot product with a shuffle reduction. An out-of-range
// group id writes NaN scores rather than reading outside the corpus.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 128;
constexpr int kThreads = 128;  // 4 warps, 32 items each

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float bf16_round(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rescore_kernel(const T* __restrict__ q, const T* __restrict__ items,
               const int32_t* __restrict__ gids, float* __restrict__ out,
               int num_groups, int dim, int kg) {
  extern __shared__ float q_row[];  // [dim]
  const int64_t pair = blockIdx.x;  // b * kg + j
  const int64_t b = pair / kg;
  float* o = out + pair * kGroup;

  for (int d = threadIdx.x; d < dim; d += kThreads) {
    q_row[d] = bf16_round(q[b * dim + d]);
  }
  __syncthreads();

  const int32_t g = gids[pair];
  if (g < 0 || g >= num_groups) {
    for (int l = threadIdx.x; l < kGroup; l += kThreads) o[l] = __int_as_float(0x7fc00000);
    return;
  }
  const T* group = items + static_cast<int64_t>(g) * kGroup * dim;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int l = warp; l < kGroup; l += kThreads / 32) {
    const T* row = group + static_cast<int64_t>(l) * dim;
    float acc = 0.0f;
    for (int d = lane; d < dim; d += 32) {
      acc += q_row[d] * bf16_round(row[d]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) o[l] = acc;
  }
}

template <typename T>
int launch(const void* q, const void* items, const int32_t* gids, float* out,
           int batch, int num_groups, int dim, int kg, cudaStream_t stream) {
  const int64_t blocks = static_cast<int64_t>(batch) * kg;
  const int smem = dim * static_cast<int>(sizeof(float));
  rescore_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(items), gids, out,
      num_groups, dim, kg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: [batch, dim]; items: [num_groups, 128, dim] (the corpus viewed
// group-major), both float32 (is_bf16 = 0) or both bfloat16 (is_bf16 = 1);
// gids: i32 [batch, kg]; out: f32 [batch, kg * 128]. All contiguous.
extern "C" int ttamm_rescore_groups(const void* q, const void* items,
                                    const int32_t* gids, float* out, int batch,
                                    int num_groups, int dim, int kg,
                                    int is_bf16, cudaStream_t stream) {
  if (is_bf16) {
    return launch<__nv_bfloat16>(q, items, gids, out, batch, num_groups, dim, kg, stream);
  }
  return launch<float>(q, items, gids, out, batch, num_groups, dim, kg, stream);
}
