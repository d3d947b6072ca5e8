// Exact per-row top-k for float32 rows: k rounds of successor extraction.
//
// Replaces the TPU kernel `small_k_topk` (ttamm_tpu/ops/pallas/topk.py,
// kernel body `_topk_kernel`), which runs k rounds of max-extract over a
// VMEM-resident block and masks each extracted lane.
//
// What bounds it on Hopper: every round reads the whole row once, so a row
// costs k * W key compares and one block-wide reduction per round. At the
// search shapes (W = 782 .. 15,625, k = 20 .. 24, 1,024 rows) that is
// compare- and latency-bound, not bandwidth-bound: the input is read from
// device memory only once.
//
// What the design does about it: one block per row keeps the row's int32 keys
// in shared memory when they fit (W <= kSmemMaxWidth; wider rows are re-read
// through L2 each round), and no per-element mask is stored at any width:
// round t takes the best element strictly after round t-1's (key, index) pair
// in (key descending, index ascending) order. That is the same sequence the
// TPU's mask-and-repeat produces, so ties go to the lowest index.
//
// Keys are the monotone int32 image of the f32 bits (topk_keys.cuh): the
// values returned are the input bits, so -inf, finfo(f32).min and -3e38 come
// back bit for bit. NaN is not a supported input, as on the TPU.

#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_keys.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemMaxWidth = 48 * 1024;  // 192 KiB of int32 keys

template <bool kSmem>
__global__ void __launch_bounds__(kThreads)
small_k_topk_kernel(const float* __restrict__ x, float* __restrict__ vals,
                    int32_t* __restrict__ idx, int width, int k) {
  extern __shared__ int32_t row_keys[];
  __shared__ int32_t red_key[kWarps];
  __shared__ int32_t red_idx[kWarps];
  __shared__ int32_t last_key;
  __shared__ int32_t last_idx;

  const int64_t row = blockIdx.x;
  const float* xr = x + row * width;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if (kSmem) {
    for (int i = threadIdx.x; i < width; i += kThreads) {
      row_keys[i] = f32_key(xr[i]);
    }
    __syncthreads();
  }

  // (INT32_MAX, -1) ranks before every element, so round 0 admits all.
  int32_t prev_key = INT32_MAX;
  int32_t prev_idx = -1;
  for (int t = 0; t < k; ++t) {
    // "No candidate": ranks after every real key (INT32_MIN is a NaN image).
    int32_t best_key = INT32_MIN;
    int32_t best_idx = INT32_MAX;
    for (int i = threadIdx.x; i < width; i += kThreads) {
      const int32_t key = kSmem ? row_keys[i] : f32_key(__ldg(xr + i));
      const bool after_prev = key < prev_key || (key == prev_key && i > prev_idx);
      if (after_prev && ranks_before(key, i, best_key, best_idx)) {
        best_key = key;
        best_idx = i;
      }
    }
    warp_best(best_key, best_idx);
    if (lane == 0) {
      red_key[warp] = best_key;
      red_idx[warp] = best_idx;
    }
    __syncthreads();
    if (warp == 0) {
      best_key = lane < kWarps ? red_key[lane] : INT32_MIN;
      best_idx = lane < kWarps ? red_idx[lane] : INT32_MAX;
      warp_best(best_key, best_idx);
      if (lane == 0) {
        vals[row * k + t] = key_f32(best_key);
        idx[row * k + t] = best_idx;
        last_key = best_key;
        last_idx = best_idx;
      }
    }
    __syncthreads();
    prev_key = last_key;
    prev_idx = last_idx;
  }
}

}  // namespace

extern "C" const char* ttamm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: f32 [batch, width] contiguous; vals: f32 [batch, k]; idx: i32 [batch, k].
// Requires 0 < k <= width (checked by the Python wrapper).
extern "C" int ttamm_small_k_topk(const float* x, float* vals, int32_t* idx,
                                  int batch, int width, int k,
                                  cudaStream_t stream) {
  if (width <= kSmemMaxWidth) {
    const int smem = width * static_cast<int>(sizeof(int32_t));
    const cudaError_t err = cudaFuncSetAttribute(
        small_k_topk_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    small_k_topk_kernel<true><<<batch, kThreads, smem, stream>>>(
        x, vals, idx, width, k);
  } else {
    small_k_topk_kernel<false><<<batch, kThreads, 0, stream>>>(
        x, vals, idx, width, k);
  }
  return static_cast<int>(cudaGetLastError());
}
