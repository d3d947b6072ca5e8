// Per-category second moments for the category-alignment loss, and their
// gradient.
//
// Replace the TPU kernel `segment_second_moments` (ttamm_tpu/ops/pallas/
// category_stats.py, bodies `_m2_fwd_kernel` and `_m2_bwd_kernel`):
//   forward  M2[c] = sum_{n : cat(n) = c} bf16(x_n) bf16(x_n)^T   f32 [C, D, D]
//   backward dx_n  = bf16(H_c) bf16(x_n),  c = cat(n),  H = G + G^T   f32 [N, D]
// Operands are rounded to bf16 and sums kept in f32, as on the TPU; bf16 x
// bf16 products are exact in f32, so any two implementations differ only in
// the order of the f32 additions. Rows whose category id is outside [0, C)
// add nothing forward and get a zero gradient.
//
// The TPU kernel keeps a [C, D, D] f32 accumulator (4 MB at C = 64, D = 128)
// in VMEM while it streams the rows; one Hopper block has at most 227 KB of
// shared memory. So the Python wrapper groups the rows by category first (a
// stable argsort of the ids: `order`, and each category's run `offsets`), and
// the kernels read the rows through that permutation:
//
// - forward: one block per (category, 32 x 32 output tile) streams that
//   category's rows through shared memory in chunks of 64 and keeps the tile
//   in registers (2 x 2 per thread). No atomics: every output is written by
//   one thread, in row order.
// - backward: the rows of each category are cut into chunks of 32 (the
//   wrapper's `chunk_offsets`), and one block per (chunk, 64-column tile of
//   dx) holds that category's H tile in shared memory (rows padded by one
//   float, so lanes walking a column hit distinct banks) and writes dx back in
//   the original row order. Chunks balance the work whatever the category
//   sizes; the last "category" C (the ids outside [0, C)) writes zeros.
//
// What bounds them on Hopper: bytes (x read once, M2 or H read once, dx
// written once: ~10 MB for 12,288 x 128 rows and C = 64), against 2 N D^2 =
// 4e8 multiply-adds. These simple kernels run the products on the f32 FMA
// units; tensor-core (wgmma) tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// forward
constexpr int kFwdTile = 32;   // output tile side
constexpr int kFwdChunk = 64;  // rows per shared-memory chunk
// backward
constexpr int kBwdCols = 64;   // dx columns per block
constexpr int kBwdRows = 32;   // rows per chunk (one block)

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(kThreads)
m2_fwd_kernel(const float* __restrict__ x, const int32_t* __restrict__ order,
              const int32_t* __restrict__ offsets, float* __restrict__ m2, int dim,
              int tiles) {
  __shared__ float xi[kFwdChunk][kFwdTile];
  __shared__ float xj[kFwdChunk][kFwdTile];
  const int c = blockIdx.y;
  const int i0 = (blockIdx.x / tiles) * kFwdTile;
  const int j0 = (blockIdx.x % tiles) * kFwdTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int begin = offsets[c];
  const int end = offsets[c + 1];
  float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};

  for (int base = begin; base < end; base += kFwdChunk) {
    for (int e = threadIdx.x; e < kFwdChunk * kFwdTile; e += kThreads) {
      const int r = e / kFwdTile;
      const int col = e % kFwdTile;
      float vi = 0.0f, vj = 0.0f;
      if (base + r < end) {
        const float* row = x + static_cast<int64_t>(order[base + r]) * dim;
        if (i0 + col < dim) vi = bf16_round(row[i0 + col]);
        if (j0 + col < dim) vj = bf16_round(row[j0 + col]);
      }
      xi[r][col] = vi;
      xj[r][col] = vj;
    }
    __syncthreads();
    const int rows = min(kFwdChunk, end - base);
    for (int r = 0; r < rows; ++r) {
      const float a0 = xi[r][ty], a1 = xi[r][ty + 16];
      const float b0 = xj[r][tx], b1 = xj[r][tx + 16];
      acc[0][0] = fmaf(a0, b0, acc[0][0]);
      acc[0][1] = fmaf(a0, b1, acc[0][1]);
      acc[1][0] = fmaf(a1, b0, acc[1][0]);
      acc[1][1] = fmaf(a1, b1, acc[1][1]);
    }
    __syncthreads();
  }
  float* out = m2 + static_cast<int64_t>(c) * dim * dim;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int i = i0 + ty + 16 * a;
      const int j = j0 + tx + 16 * b;
      if (i < dim && j < dim) out[static_cast<int64_t>(i) * dim + j] = acc[a][b];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
m2_bwd_kernel(const float* __restrict__ x, const float* __restrict__ h,
              const int32_t* __restrict__ order, const int32_t* __restrict__ offsets,
              const int32_t* __restrict__ chunk_offsets, float* __restrict__ dx,
              int num_categories, int dim) {
  extern __shared__ float smem[];
  float* hs = smem;                             // [kBwdCols][dim + 1]
  float* xs = smem + kBwdCols * (dim + 1);      // [kBwdRows][dim]
  __shared__ int s_cat;

  const int chunk = blockIdx.x;
  if (chunk >= chunk_offsets[num_categories + 1]) return;  // past the last chunk
  if (threadIdx.x == 0) {
    // the category whose chunks contain this one: chunk_offsets is
    // non-decreasing with C + 2 entries
    int lo = 0, hi = num_categories;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (chunk_offsets[mid] <= chunk) lo = mid; else hi = mid - 1;
    }
    s_cat = lo;
  }
  __syncthreads();
  const int c = s_cat;
  const int begin = offsets[c] + (chunk - chunk_offsets[c]) * kBwdRows;
  const int rows = min(kBwdRows, offsets[c + 1] - begin);
  const int e0 = blockIdx.y * kBwdCols;
  const int el = threadIdx.x % kBwdCols;  // this thread's dx column in the tile
  const int r0 = threadIdx.x / kBwdCols;  // and its first row (then every 4th)
  constexpr int kRowStep = kThreads / kBwdCols;

  if (c == num_categories) {  // ids outside [0, C): zero gradient
    for (int r = r0; r < rows; r += kRowStep) {
      if (e0 + el < dim) dx[static_cast<int64_t>(order[begin + r]) * dim + e0 + el] = 0.0f;
    }
    return;
  }
  const float* hc = h + static_cast<int64_t>(c) * dim * dim;
  for (int e = threadIdx.x; e < kBwdCols * dim; e += kThreads) {
    const int row = e / dim;
    const int d = e % dim;
    hs[row * (dim + 1) + d] =
        e0 + row < dim ? bf16_round(hc[static_cast<int64_t>(e0 + row) * dim + d]) : 0.0f;
  }
  for (int e = threadIdx.x; e < kBwdRows * dim; e += kThreads) {
    const int r = e / dim;
    const int d = e % dim;
    xs[r * dim + d] =
        r < rows ? bf16_round(x[static_cast<int64_t>(order[begin + r]) * dim + d]) : 0.0f;
  }
  __syncthreads();
  if (e0 + el >= dim) return;
  float acc[kBwdRows / kRowStep];
#pragma unroll
  for (int k = 0; k < kBwdRows / kRowStep; ++k) acc[k] = 0.0f;
  const float* hrow = hs + el * (dim + 1);
  for (int d = 0; d < dim; ++d) {
    const float hv = hrow[d];
#pragma unroll
    for (int k = 0; k < kBwdRows / kRowStep; ++k) {
      acc[k] = fmaf(hv, xs[(r0 + k * kRowStep) * dim + d], acc[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kBwdRows / kRowStep; ++k) {
    const int r = r0 + k * kRowStep;
    if (r < rows) dx[static_cast<int64_t>(order[begin + r]) * dim + e0 + el] = acc[k];
  }
}

}  // namespace

// x: f32 [n, dim]; order: i32 [n], the row ids grouped by category;
// offsets: i32 [C + 1], category c's run is order[offsets[c]:offsets[c+1]];
// m2: f32 [C, dim, dim]. All contiguous, C > 0.
extern "C" int ttamm_segment_second_moments(const float* x, const int32_t* order,
                                            const int32_t* offsets, float* m2,
                                            int num_categories, int dim,
                                            cudaStream_t stream) {
  const int tiles = (dim + kFwdTile - 1) / kFwdTile;
  const dim3 grid(static_cast<unsigned int>(tiles * tiles),
                  static_cast<unsigned int>(num_categories));
  m2_fwd_kernel<<<grid, kThreads, 0, stream>>>(x, order, offsets, m2, dim, tiles);
  return static_cast<int>(cudaGetLastError());
}

// x: f32 [n, dim]; h: f32 [C, dim, dim] (symmetric); order: i32 [n];
// offsets: i32 [C + 2] (run C holds the ids outside [0, C)); chunk_offsets:
// i32 [C + 2], category c's chunks of 32 rows are blocks
// [chunk_offsets[c], chunk_offsets[c+1]); max_chunks bounds their total;
// dx: f32 [n, dim]. dim <= 512.
extern "C" int ttamm_segment_second_moments_bwd(const float* x, const float* h,
                                                const int32_t* order,
                                                const int32_t* offsets,
                                                const int32_t* chunk_offsets, float* dx,
                                                int num_categories, int dim,
                                                int max_chunks, cudaStream_t stream) {
  const int smem = (kBwdCols * (dim + 1) + kBwdRows * dim) * static_cast<int>(sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      m2_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>(max_chunks),
                  static_cast<unsigned int>((dim + kBwdCols - 1) / kBwdCols));
  m2_bwd_kernel<<<grid, kThreads, smem, stream>>>(x, h, order, offsets, chunk_offsets, dx,
                                                  num_categories, dim);
  return static_cast<int>(cudaGetLastError());
}
