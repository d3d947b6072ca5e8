// Per-128-item-group maxima of Q . I^T without writing the score slab.
//
// Replaces the TPU kernel `groupmax_matmul` (ttamm_tpu/ops/pallas/fused_mips.py,
// kernel body `_groupmax_kernel`): phase 1 of the fused no-slab search. The
// [B, N] score slab (8 MB per query at N = 2M in f32) never reaches device
// memory; only the [B, N/128] maxima are written.
//
// Semantics kept from the TPU kernel: both operands are rounded to bf16
// (round-to-nearest-even) and multiplied with f32 accumulation; rows at or
// beyond `num_items` score -3e38 before the max, so a group holding only pad
// rows reports -3e38 and a tail group's maximum covers its real rows only.
// Any B and N are accepted (ragged edges are masked here); D is padded to a
// multiple of 16 with zeros in shared memory.
//
// What bounds it on Hopper: 2*B*N*D flops on the tensor cores against one
// read of the corpus (N*D*itemsize bytes) per 64-query tile. Query tiles of
// the same corpus stripe are adjacent in blockIdx.x, so they run together and
// the stripe is served from L2 after its first read.
//
// What the design does about it: each block stages one 64-query tile in
// shared memory once, then streams its stripe of 128-item groups through
// shared memory (16-byte vector loads, rounded to bf16 on the way, rows
// padded against bank conflicts); eight warps run bf16 WMMA tiles (16x16x16,
// f32 accumulate), spill the 64x128 f32 tile to shared memory and reduce
// each query's group maximum with warp shuffles. Loads are synchronous and
// unpipelined: simple and right first (cp.async/TMA, wgmma and a deeper
// pipeline are later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kGroup = 128;           // items per group
constexpr int kTileQ = 64;            // queries per block
constexpr int kGroupsPerBlock = 8;    // groups streamed per block
constexpr int kThreads = 256;         // 8 warps
constexpr int kRowsPerWarp = kTileQ / (kThreads / 32);
// Row padding of the shared tiles (8 bf16 = 16 B; 4 f32 = 16 B): with
// unpadded 256-byte rows every row of a fragment load hits the same banks.
constexpr int kPadBf16 = 8;
constexpr int kPadF32 = 4;
constexpr int kLdS = kGroup + kPadF32;
constexpr float kPadScore = -3.0e38f;

__device__ __forceinline__ __nv_bfloat16 to_bf16(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 v) { return v; }

// Eight consecutive elements (16-byte aligned for bf16, 32 for f32) as
// eight bf16 packed in a uint4, rounded to nearest even.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint4 load8(const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  return make_uint4(pack2(a.x, a.y), pack2(a.z, a.w), pack2(b.x, b.y), pack2(b.z, b.w));
}

// Stage rows [row0, row0 + rows) of a [n_rows, dim] matrix into a bf16
// shared tile with leading dimension ld, zero-filling rows past n_rows and
// columns past dim. Vector loads when dim % 8 == 0 (rows stay aligned).
template <typename T>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* tile, const T* __restrict__ src,
                                           int64_t row0, int rows, int64_t n_rows,
                                           int dim, int dp, int ld) {
  if (dim % 8 == 0) {
    const int vecs = dp / 8;
    for (int v = threadIdx.x; v < rows * vecs; v += kThreads) {
      const int r = v / vecs;
      const int c = (v - r * vecs) * 8;
      const int64_t sr = row0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (sr < n_rows && c < dim) val = load8(src + sr * dim + c);
      *reinterpret_cast<uint4*>(tile + r * ld + c) = val;
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
    for (int e = threadIdx.x; e < rows * dp; e += kThreads) {
      const int r = e / dp;
      const int c = e - r * dp;
      const int64_t sr = row0 + r;
      tile[r * ld + c] = (sr < n_rows && c < dim) ? to_bf16(src[sr * dim + c]) : zero;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
groupmax_kernel(const T* __restrict__ q, const T* __restrict__ items,
                float* __restrict__ out, int batch, int64_t n_rows,
                int64_t num_items, int dim, int dp, int num_groups) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = dp + kPadBf16;
  __nv_bfloat16* q_tile = reinterpret_cast<__nv_bfloat16*>(smem);  // [kTileQ, ld]
  __nv_bfloat16* i_tile = q_tile + kTileQ * ld;                     // [kGroup, ld]
  float* s_tile = reinterpret_cast<float*>(i_tile + kGroup * ld);   // [kTileQ, kLdS]

  const int q0 = blockIdx.x * kTileQ;
  const int g_begin = blockIdx.y * kGroupsPerBlock;
  const int g_end = min(g_begin + kGroupsPerBlock, num_groups);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warp_m = warp >> 1;        // 16-row strip of the query tile
  const int warp_n = (warp & 1) * 4;   // first of this warp's 4 16-item columns

  stage_tile(q_tile, q, q0, kTileQ, batch, dim, dp, ld);

  for (int g = g_begin; g < g_end; ++g) {
    const int64_t row0 = static_cast<int64_t>(g) * kGroup;
    __syncthreads();  // q_tile staged; previous group's tiles consumed
    stage_tile(i_tile, items, row0, kGroup, n_rows, dim, dp, ld);
    __syncthreads();

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);
    for (int kk = 0; kk < dp; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, q_tile + warp_m * 16 * ld + kk, ld);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // B[k][n] = item[n][k]: the item tile read column-major.
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(b, i_tile + (warp_n + j) * 16 * ld + kk, ld);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(s_tile + warp_m * 16 * kLdS + (warp_n + j) * 16,
                              acc[j], kLdS, wmma::mem_row_major);
    }
    __syncthreads();

    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      float m = kPadScore;
      for (int c = lane; c < kGroup; c += 32) {
        const float s = (row0 + c < num_items) ? s_tile[r * kLdS + c] : kPadScore;
        m = fmaxf(m, s);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      }
      if (lane == 0 && q0 + r < batch) {
        out[static_cast<int64_t>(q0 + r) * num_groups + g] = m;
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* items, float* out, int batch,
           int64_t n_rows, int64_t num_items, int dim, cudaStream_t stream) {
  const int dp = (dim + 15) / 16 * 16;
  const int num_groups = static_cast<int>((n_rows + kGroup - 1) / kGroup);
  const int smem = (kTileQ + kGroup) * (dp + kPadBf16) * static_cast<int>(sizeof(__nv_bfloat16)) +
                   kTileQ * kLdS * static_cast<int>(sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      groupmax_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((batch + kTileQ - 1) / kTileQ,
                  (num_groups + kGroupsPerBlock - 1) / kGroupsPerBlock);
  groupmax_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(items), out, batch,
      n_rows, num_items, dim, dp, num_groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: [batch, dim], items: [n_rows, dim], both float32 (is_bf16 = 0) or both
// bfloat16 (is_bf16 = 1), contiguous. out: f32 [batch, ceil(n_rows / 128)].
// Shape limits (dim <= 496, the shared-memory bound; grid size) are checked
// by the Python wrapper.
extern "C" int ttamm_groupmax_matmul(const void* q, const void* items,
                                     float* out, int batch, int64_t n_rows,
                                     int64_t num_items, int dim, int is_bf16,
                                     cudaStream_t stream) {
  if (is_bf16) {
    return launch<__nv_bfloat16>(q, items, out, batch, n_rows, num_items, dim, stream);
  }
  return launch<float>(q, items, out, batch, n_rows, num_items, dim, stream);
}
