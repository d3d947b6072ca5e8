// Order-preserving int32 keys of float32 scores and their tie rule, shared
// by the top-k kernels (small_k_topk.cu, select_topk.cu, through
// bound_rank.cuh).
//
// Keys are the monotone int32 image of the f32 bits (u < 0 ? u ^ 0x7FFFFFFF
// : u), the TPU kernels' `_f32_keys`: comparisons and tie-breaks are exact
// integer operations, and a value comes back from its key bit for bit, so
// -inf, finfo(f32).min and -3e38 survive. NaN is not a supported input (its
// keys interleave with the reals); INT32_MIN is the image of a NaN and
// serves as "no candidate".

#pragma once

#include <stdint.h>

namespace {

__device__ __forceinline__ int32_t f32_key(float x) {
  const int32_t u = __float_as_int(x);
  return u < 0 ? (u ^ 0x7FFFFFFF) : u;
}

__device__ __forceinline__ float key_f32(int32_t k) {
  return __int_as_float(k < 0 ? (k ^ 0x7FFFFFFF) : k);
}

// True when (ka, ia) ranks before (kb, ib): larger key first, then lower index.
__device__ __forceinline__ bool ranks_before(int32_t ka, int32_t ia,
                                             int32_t kb, int32_t ib) {
  return ka > kb || (ka == kb && ia < ib);
}

}  // namespace
