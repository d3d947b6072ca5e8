// The dense Adam / AdamW update of a list of tensors in one pass.
//
// Replaces no Pallas kernel. On the TPU, XLA fuses the dense optimizer of
// ttamm_tpu/train/optim.py (`dense_opt_update`) into elementwise loops over
// the parameters and their moments; this kernel does that on the card. It
// takes the place of the port's composition of eleven torch._foreach_*
// passes (ttamm_torch/train/optim.py, kept as the plain version in
// ttamm_torch/ops/kernels.py), which reads and writes the parameters, m, v
// and two temporaries about 26 times a step.
//
// What bounds it on Hopper: device-memory bandwidth. Each element needs its
// parameter, gradient, m and v read once and its parameter, m and v written
// once, 28 bytes; at the default configuration's dense targets (the dense
// mimic tables user_aug [199450, 128] and item_aug [99881, 128] f32, and the
// towers' 16 tensors: 38.5M elements) that is 1.079 GB a step, 0.322 ms at
// 3.35 TB/s. The arithmetic (two divisions and a square root an element)
// hides under the loads.
//
// What the design does about it: one launch for the whole list, no
// temporaries. Each tensor's four pointers and its element count go in the
// kernel's argument block, as PyTorch's multi_tensor_apply passes its
// metadata, with the prefix sums of the tensors' chunk counts; a block
// finds its tensor by a binary search over those sums (the same for every
// thread of the block, so each read of the argument block is a broadcast)
// and updates one chunk of kChunk elements. The two large tables and the
// few dozen small tower tensors go in one grid; a list longer than
// kMaxTensors takes one launch for every kMaxTensors of its tensors. Each
// thread loads its kVecs 16-byte vectors of p, g, m and v (16 loads in
// flight a thread) before any arithmetic or store. Measured at the default
// list (NVIDIA H100, 700 W), each a source edit of one first form with
// streaming loads and stores: 2 or 8 vectors a thread and 128 or 512
// threads within 0.3 % of it, a cap of 64 registers (4 blocks an SM) 17 %
// slower, plain loads and stores (these) 1.7 % faster. A tensor whose four pointers are not all 16-byte aligned (a view
// at an offset) is updated element by element, and so is the ragged tail
// of a tensor whose element count is not a multiple of 4 (biases, gates).
//
// The arithmetic is the composition's on the card, bit for bit: each
// _foreach_ op rounded as PyTorch's foreach functors round it, in the same
// order, through the _rn intrinsics, which nvcc does not contract. PyTorch's
// functors compute `a + alpha * b` (the add with alpha) and `a + value * (b
// * c)` (addcmul) in one expression, which nvcc contracts into an FMA on the
// outer product (checked on the card: scripts/dense_adam_timing.py --probe);
// the kernel writes those FMAs out with __fmaf_rn. The operations, in order:
// Adam's L2 decay g + wd * p (one FMA), AdamW's p * first, m * b1, m + (1 -
// b1) * g (one FMA), v * b2, v + (1 - b2) * (g * g) (one FMA on the rounded
// square), v / bc2 (IEEE division), a correctly rounded sqrt, + eps, m /
// denom, * step_size, p + update.
//
// The step's scalars (first = 1 - lr * wd, step_size = -lr / (1 - b1^t), bc2
// = 1 - b2^t; train/optim.py dense_scalars) are read through a pointer to
// one step's row in device memory, not by value: a launch captured into a
// CUDA graph freezes its by-value arguments, and the multi-step train call
// replays one captured step many times, each replay at its own step. The
// constants b1, 1 - b1, b2, 1 - b2, eps and wd go by value, each rounded to
// f32 from the double as PyTorch converts a Python scalar.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDenseThreads = 256;
constexpr int kVecs = 4;                             // float4s a thread a chunk
constexpr int kChunk = kDenseThreads * kVecs * 4;    // elements a block
constexpr int kScalarSteps = kChunk / kDenseThreads;  // elements a thread, unaligned
// Tensors a launch: the argument block stays under the classic 4 KB limit
// of a kernel's parameters (64 x 40 bytes of pointers and counts, the
// prefix sums and the flags).
constexpr int kMaxTensors = 64;

enum Decay { kNoDecay = 0, kDecoupled = 1, kL2 = 2 };

struct DenseAdamArgs {
  float* p[kMaxTensors];
  float* m[kMaxTensors];
  float* v[kMaxTensors];
  const float* g[kMaxTensors];
  int64_t n[kMaxTensors];
  int32_t first_chunk[kMaxTensors + 1];  // tensor t's chunks: [first_chunk[t], first_chunk[t + 1])
  uint8_t aligned[kMaxTensors];          // all four pointers 16-byte aligned
  const float* scalars;                  // first, step_size, bc2
  float b1, one_minus_b1, b2, one_minus_b2, eps, wd;
  int count;
};

struct Step {
  float first, step_size, bc2;
};

template <int kDecay>
__device__ __forceinline__ void adam_element(float& p, float& m, float& v, float g,
                                             const DenseAdamArgs& a, const Step& s) {
  if (kDecay == kL2) g = __fmaf_rn(a.wd, p, g);
  if (kDecay == kDecoupled) p = __fmul_rn(p, s.first);
  m = __fmaf_rn(a.one_minus_b1, g, __fmul_rn(m, a.b1));
  v = __fmaf_rn(a.one_minus_b2, __fmul_rn(g, g), __fmul_rn(v, a.b2));
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), a.eps);
  p = __fadd_rn(p, __fmul_rn(__fdiv_rn(m, denom), s.step_size));
}

template <int kDecay>
__device__ __forceinline__ void adam_vec(float4& p, float4& m, float4& v, const float4& g,
                                         const DenseAdamArgs& a, const Step& s) {
  adam_element<kDecay>(p.x, m.x, v.x, g.x, a, s);
  adam_element<kDecay>(p.y, m.y, v.y, g.y, a, s);
  adam_element<kDecay>(p.z, m.z, v.z, g.z, a, s);
  adam_element<kDecay>(p.w, m.w, v.w, g.w, a, s);
}

template <int kDecay>
__device__ __forceinline__ void adam_at(const DenseAdamArgs& a, int t, int64_t i, const Step& s) {
  float p = a.p[t][i], m = a.m[t][i], v = a.v[t][i];
  adam_element<kDecay>(p, m, v, a.g[t][i], a, s);
  a.p[t][i] = p;
  a.m[t][i] = m;
  a.v[t][i] = v;
}

template <int kDecay>
__global__ void __launch_bounds__(kDenseThreads)
dense_adam_kernel(const __grid_constant__ DenseAdamArgs a) {
  const int block = static_cast<int>(blockIdx.x);
  int t = 0, hi = a.count - 1;  // the last tensor whose first chunk is <= block
  while (t < hi) {
    const int mid = (t + hi + 1) >> 1;
    if (a.first_chunk[mid] <= block) t = mid;
    else hi = mid - 1;
  }
  const int64_t start = static_cast<int64_t>(block - a.first_chunk[t]) * kChunk;
  const int64_t n = a.n[t];
  const Step s{__ldg(a.scalars), __ldg(a.scalars + 1), __ldg(a.scalars + 2)};
  if (!a.aligned[t]) {
#pragma unroll 4
    for (int k = 0; k < kScalarSteps; ++k) {
      const int64_t i = start + k * kDenseThreads + threadIdx.x;
      if (i < n) adam_at<kDecay>(a, t, i, s);
    }
    return;
  }
  const int64_t n4 = n >> 2;
  float4* p4 = reinterpret_cast<float4*>(a.p[t]);
  float4* m4 = reinterpret_cast<float4*>(a.m[t]);
  float4* v4 = reinterpret_cast<float4*>(a.v[t]);
  const float4* g4 = reinterpret_cast<const float4*>(a.g[t]);
  float4 p[kVecs], m[kVecs], v[kVecs], g[kVecs];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int64_t i = (start >> 2) + k * kDenseThreads + threadIdx.x;
    if (i < n4) {
      p[k] = p4[i];
      g[k] = g4[i];
      m[k] = m4[i];
      v[k] = v4[i];
    }
  }
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int64_t i = (start >> 2) + k * kDenseThreads + threadIdx.x;
    if (i < n4) {
      adam_vec<kDecay>(p[k], m[k], v[k], g[k], a, s);
      p4[i] = p[k];
      m4[i] = m[k];
      v4[i] = v[k];
    }
  }
  // the ragged tail (n % 4 elements) lies in the tensor's last chunk
  const int64_t tail = n4 << 2;
  if (tail < n && tail >= start && tail < start + kChunk && threadIdx.x < n - tail)
    adam_at<kDecay>(a, t, tail + threadIdx.x, s);
}

// One launch over tensors [0, count) of the lists (count <= kMaxTensors).
int launch(float* const* p, float* const* m, float* const* v, const float* const* g,
           const int64_t* n, int count, const float* scalars, float b1, float one_minus_b1,
           float b2, float one_minus_b2, float eps, float wd, int decay, cudaStream_t stream) {
  DenseAdamArgs a;
  int64_t chunks = 0;
  for (int t = 0; t < count; ++t) {
    a.p[t] = p[t];
    a.m[t] = m[t];
    a.v[t] = v[t];
    a.g[t] = g[t];
    a.n[t] = n[t];
    a.aligned[t] = ((reinterpret_cast<uintptr_t>(p[t]) | reinterpret_cast<uintptr_t>(m[t]) |
                     reinterpret_cast<uintptr_t>(v[t]) | reinterpret_cast<uintptr_t>(g[t])) &
                    15) == 0;
    a.first_chunk[t] = static_cast<int32_t>(chunks);
    chunks += (n[t] + kChunk - 1) / kChunk;
  }
  a.first_chunk[count] = static_cast<int32_t>(chunks);
  a.scalars = scalars;
  a.b1 = b1;
  a.one_minus_b1 = one_minus_b1;
  a.b2 = b2;
  a.one_minus_b2 = one_minus_b2;
  a.eps = eps;
  a.wd = wd;
  a.count = count;
  const auto blocks = static_cast<unsigned int>(chunks);
  if (decay == kDecoupled)
    dense_adam_kernel<kDecoupled><<<blocks, kDenseThreads, 0, stream>>>(a);
  else if (decay == kL2)
    dense_adam_kernel<kL2><<<blocks, kDenseThreads, 0, stream>>>(a);
  else
    dense_adam_kernel<kNoDecay><<<blocks, kDenseThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Tensors a launch of ttamm_dense_adam: a list of `count` tensors takes
// ceil(count / this) launches.
extern "C" int ttamm_dense_adam_tensors_a_launch() { return kMaxTensors; }

// p, m and v updated in place from g over `count` >= 1 tensors, one launch
// for every kMaxTensors of them: each tensor `n[t]` > 0 contiguous float32
// elements, no two of the 4 x count tensors overlapping. `scalars`: the
// step's three f32 scalars (first, step_size, bc2) in device memory.
// `decay`: 0 none, 1 AdamW's decoupled decay (p * first), 2 Adam's L2 decay
// folded into g. Refuses the whole list, before any launch, if one of its
// arguments is out of range.
extern "C" int ttamm_dense_adam(float* const* p, float* const* m, float* const* v,
                                const float* const* g, const int64_t* n, int count,
                                const float* scalars, float b1, float one_minus_b1, float b2,
                                float one_minus_b2, float eps, float wd, int decay,
                                cudaStream_t stream) {
  if (count < 1 || decay < kNoDecay || decay > kL2) return static_cast<int>(cudaErrorInvalidValue);
  int64_t chunks = 0;  // of the launch that tensor t falls in
  for (int t = 0; t < count; ++t) {
    if (t % kMaxTensors == 0) chunks = 0;
    if (n[t] < 1) return static_cast<int>(cudaErrorInvalidValue);
    chunks += (n[t] + kChunk - 1) / kChunk;
    if (chunks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int lo = 0; lo < count; lo += kMaxTensors) {
    const int part = count - lo < kMaxTensors ? count - lo : kMaxTensors;
    const int rc = launch(p + lo, m + lo, v + lo, g + lo, n + lo, part, scalars, b1, one_minus_b1,
                          b2, one_minus_b2, eps, wd, decay, stream);
    if (rc != 0) return rc;
  }
  return 0;
}
