// Candidate selection and final top-k of the group-pruned exact search.
//
// Replaces the TPU kernel `select_topk_from_groups`
// (ttamm_tpu/ops/pallas/topk.py, kernel body `_select_topk_kernel`): given
// the float32 score slab [B, NG*128] (item n at column n) and each row's KG
// selected group ids, return the top k of the KG*128 candidates, ordered by
// value descending, ties to the lower candidate position (group rank j, then
// lane), pad lanes (global id >= num_items) scoring finfo(f32).min. The
// result is bit-identical to gathering the KG group rows and taking a stable
// descending top-k, which is the kernel's plain version.
//
// The TPU kernel gathers the groups with a one-hot bf16x3 MXU product (a TPU
// workaround for the lack of a fast dynamic gather); here every group row is
// read directly, which is exact by construction.
//
// What bounds it on Hopper: device-memory bandwidth for the reads (B * KG *
// 512 bytes of the slab, one contiguous 512-byte row per selected group) and,
// at the eval's k ~ 21, the latency of k block-wide reductions per row.
//
// What the design does about it: one block of 256 threads per query row. The
// KG <= 32 group rows go straight from the slab into registers with 16-byte
// loads (each warp reads one 512-byte group row, coalesced): at most 16 keys
// a thread, nothing staged in shared memory and no candidate buffer in
// device memory. Each of the k rounds is a register scan, a warp-shuffle
// argmax and one exchange of the 8 warp winners; the winner's owner marks it
// taken (INT32_MIN, below every real key), so no per-element mask is stored.

#include <cfloat>
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_keys.cuh"

namespace {

constexpr int kGroup = 128;
constexpr int kVecPerGroup = kGroup / 4;  // float4 loads per group row
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroups = 32;
constexpr int kVecPerThread = kMaxGroups * kVecPerGroup / kThreads;  // 4
constexpr int kKeysPerThread = kVecPerThread * 4;                    // 16

// Candidate position of a thread's s-th key: thread t holds the float4s
// t, t + 256, ..., i.e. positions 4 * (t + 256 * (s / 4)) + s % 4, in
// ascending order within the thread.
__device__ __forceinline__ int32_t key_pos(int s) {
  return 4 * (static_cast<int>(threadIdx.x) + (s / 4) * kThreads) + (s % 4);
}

__global__ void __launch_bounds__(kThreads)
select_topk_kernel(const float* __restrict__ scores,
                   const int32_t* __restrict__ gids, float* __restrict__ vals,
                   int32_t* __restrict__ ids, int64_t width, int num_groups,
                   int kg, int k, int64_t num_items) {
  __shared__ int32_t row_gids[kMaxGroups];
  __shared__ int32_t red_key[kWarps];
  __shared__ int32_t red_pos[kWarps];
  __shared__ int32_t win_pos;

  const int64_t row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x < kg) row_gids[threadIdx.x] = gids[row * kg + threadIdx.x];
  __syncthreads();

  // Load the selected group rows as keys. A pad lane, or every lane of a
  // group id outside [0, NG), is finfo(f32).min; a slot past the KG * 128
  // candidates holds no candidate.
  const int32_t pad_key = f32_key(-FLT_MAX);
  const float4* srow = reinterpret_cast<const float4*>(scores + row * width);
  const int nvec = kg * kVecPerGroup;
  int32_t key[kKeysPerThread];
#pragma unroll
  for (int i = 0; i < kVecPerThread; ++i) {
    const int v = threadIdx.x + i * kThreads;
    if (v < nvec) {
      const int32_t g = row_gids[v / kVecPerGroup];
      const int lane4 = v % kVecPerGroup;
      const bool ok = g >= 0 && g < num_groups;
      const float4 x = ok ? __ldg(srow + static_cast<int64_t>(g) * kVecPerGroup + lane4)
                          : make_float4(-FLT_MAX, -FLT_MAX, -FLT_MAX, -FLT_MAX);
      const int64_t item0 = static_cast<int64_t>(g) * kGroup + 4 * lane4;
      const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        key[4 * i + c] = ok && item0 + c < num_items ? f32_key(xs[c]) : pad_key;
      }
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) key[4 * i + c] = INT32_MIN;
    }
  }

  for (int t = 0; t < k; ++t) {
    // Positions ascend within the thread, so a strict '>' keeps the lowest
    // position among equal keys.
    int32_t best_key = INT32_MIN;
    int32_t best_pos = INT32_MAX;
#pragma unroll
    for (int s = 0; s < kKeysPerThread; ++s) {
      if (key[s] > best_key) {
        best_key = key[s];
        best_pos = key_pos(s);
      }
    }
    warp_best(best_key, best_pos);
    if (lane == 0) {
      red_key[warp] = best_key;
      red_pos[warp] = best_pos;
    }
    __syncthreads();
    if (warp == 0) {
      best_key = lane < kWarps ? red_key[lane] : INT32_MIN;
      best_pos = lane < kWarps ? red_pos[lane] : INT32_MAX;
      warp_best(best_key, best_pos);
      if (lane == 0) {
        vals[row * k + t] = key_f32(best_key);
        ids[row * k + t] = row_gids[best_pos / kGroup] * kGroup + best_pos % kGroup;
        win_pos = best_pos;
      }
    }
    __syncthreads();
    const int32_t taken = win_pos;
#pragma unroll
    for (int s = 0; s < kKeysPerThread; ++s) {
      if (key_pos(s) == taken) key[s] = INT32_MIN;
    }
  }
}

}  // namespace

// scores: f32 [batch, width] contiguous, 16-byte aligned, width % 128 == 0;
// gids: i32 [batch, kg]; vals: f32 [batch, k]; ids: i32 [batch, k] (global
// item ids). Requires 0 < kg <= 32 and 0 < k <= kg * 128 (checked by the
// Python wrapper, and again here).
extern "C" int ttamm_select_topk_from_groups(const float* scores,
                                             const int32_t* gids, float* vals,
                                             int32_t* ids, int batch,
                                             int64_t width, int kg, int k,
                                             int64_t num_items,
                                             cudaStream_t stream) {
  if (kg < 1 || kg > kMaxGroups || k < 1 || k > kg * kGroup || width % kGroup != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  select_topk_kernel<<<batch, kThreads, 0, stream>>>(
      scores, gids, vals, ids, width, static_cast<int>(width / kGroup), kg, k,
      num_items);
  return static_cast<int>(cudaGetLastError());
}
