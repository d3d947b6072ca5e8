// Exact per-row top-k of float32 rows whose cost does not grow with k.
//
// Replaces the TPU kernel `small_k_topk` (ttamm_tpu/ops/pallas/topk.py,
// kernel body `_topk_kernel`), which runs k rounds of max-extract over a
// VMEM-resident block and masks each extracted lane.
//
// What bounds it on Hopper: one read of the row from device memory (4 B a
// key) and one write of k values and ids; at the search shapes (W = 782 ..
// 15,625, k = 20 .. 24, 1,024 rows) that is 3 .. 64 MB, one to twenty
// microseconds. A k-round extraction (the TPU design, and the first port)
// instead costs k * W compares and 2k block barriers a row.
//
// What the design does about it. One block per row reads the row once (into
// shared memory up to 48K keys; wider rows are re-read through L2) as
// monotone int32 keys (topk_keys.cuh) and runs the bound-and-rank steps of
// bound_rank.cuh with the column as the index: the k-th largest thread
// maximum L bounds the k-th key from below (k <= threads holding keys;
// otherwise no bound), the keys >= L are compacted into shared memory (on
// random rows of 15,625: 23-26 at k = 24) and ranked by counting, with an
// ordered selection for rows tied at the top and a radix select over the
// whole row for a weak bound.
//
// The block has 128 threads up to 6,144 keys (the eval's 782 groups and
// 2,560 .. 5,120 candidates), 256 up to 12,288 and 512 beyond (15,625 at 2M
// items). One warp per row, with no block barrier, was measured against an
// earlier cut of this kernel (NVIDIA H100 80GB HBM3, 700 W, 1,024 random
// rows, k = 20): 6.7 us against 7.8 at W = 782, but 14.1 / 16.4 against
// 10.9 / 11.1 us at 2,560 / 3,072, and its bound has only 32 maxima
// (k <= 32). This kernel then read 3.8 / 11.5 / 12.4 us, so the warp form
// was not kept.
//
// Values come back as the input bits, so -inf, finfo(f32).min and -3e38
// survive and -0.0 ranks below +0.0. NaN is not a supported input, as on
// the TPU.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bound_rank.cuh"

namespace {

constexpr int kSmemMaxWidth = 48 * 1024;  // 192 KiB of int32 keys
constexpr int kLoadBatch = 8;             // row loads in flight per thread

// Reads keys tid, tid + kThreads, ... of a row, kLoadBatch loads in flight
// per thread, and hands each to f(index, key).
template <int kThreads, class F>
__device__ __forceinline__ void read_row(const float* __restrict__ xr, int width, int tid, F f) {
  for (int base = tid; base < width; base += kThreads * kLoadBatch) {
    float v[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int i = base + u * kThreads;
      v[u] = i < width ? __ldg(xr + i) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int i = base + u * kThreads;
      if (i < width) f(i, f32_key(v[u]));
    }
  }
}

// At least 1,536 threads of blocks per SM (3 of 512 with 48K keys each in
// shared memory): at most 42 registers a thread.
template <int kThreads, bool kSmem>
__global__ void __launch_bounds__(kThreads, 1536 / kThreads)
small_k_topk_kernel(const float* __restrict__ x, float* __restrict__ vals,
                    int32_t* __restrict__ idx, int width, int k) {
  extern __shared__ int32_t row_keys[];  // width keys when kSmem
  __shared__ RowScratch<kThreads / 32> s;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int64_t row = blockIdx.x;
  const float* xr = x + row * width;
  auto key_at = [&](int i) -> int32_t {
    return kSmem ? row_keys[i] : f32_key(__ldg(xr + i));
  };

  int32_t thread_max = INT32_MIN;  // INT32_MIN (a NaN image): no key
  read_row<kThreads>(xr, width, tid, [&](int i, int32_t key) {
    if (kSmem) row_keys[i] = key;
    thread_max = max(thread_max, key);
  });
  if (tid < 2) s.count[tid] = 0;
  __syncthreads();

  // 1. L = the k-th largest thread maximum, if k threads hold keys
  int32_t t = INT32_MIN;
  int rem;
  if (k <= min(width, kThreads)) {
    t = radix_select([&](auto f) { f(thread_max, tid < width); }, k, s.hist, s.sh, rem);
  }
  // 2. the keys >= L, and how many are > L
  for (int base = 0; base < width; base += kThreads) {
    const int i = base + tid;
    const int32_t key = i < width ? key_at(i) : INT32_MIN;
    const bool cand = i < width && key >= t;
    const unsigned b = __ballot_sync(kFull, cand);
    const unsigned b_gt = __ballot_sync(kFull, cand && key > t);
    if (b) {
      int first = 0;
      if (lane == __ffs(b) - 1) {
        first = atomicAdd(&s.count[0], __popc(b));
        if (b_gt) atomicAdd(&s.count[1], __popc(b_gt));
      }
      first = __shfl_sync(kFull, first, __ffs(b) - 1);
      const int pos = first + __popc(b & lanes_below(lane));
      if (cand && pos < kCandCap) {
        s.ck[pos] = key;
        s.ci[pos] = i;
      }
    }
  }
  __syncthreads();
  // 3. rank the candidates, or select in index order and sort
  finish_row<kThreads>(
      s, t, width, k,
      [&](auto f) {
        for (int base = 0; base < width; base += kThreads) {
          const int i = base + tid;
          const bool v = i < width;
          f(v ? key_at(i) : 0, v);
        }
      },
      key_at, SameIndex(), vals + row * k, idx + row * k);
}

template <int kThreads>
int launch(const float* x, float* vals, int32_t* idx, int batch, int width, int k,
           cudaStream_t stream) {
  if (width <= kSmemMaxWidth) {
    const int smem = width * static_cast<int>(sizeof(int32_t));
    const cudaError_t err = cudaFuncSetAttribute(
        small_k_topk_kernel<kThreads, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    small_k_topk_kernel<kThreads, true><<<batch, kThreads, smem, stream>>>(x, vals, idx, width, k);
  } else {
    small_k_topk_kernel<kThreads, false><<<batch, kThreads, 0, stream>>>(x, vals, idx, width, k);
  }
  return static_cast<int>(cudaGetLastError());
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
  if (width <= 6 * 1024) return launch<128>(x, vals, idx, batch, width, k, stream);
  if (width <= 12 * 1024) return launch<256>(x, vals, idx, batch, width, k, stream);
  return launch<512>(x, vals, idx, batch, width, k, stream);
}
