// Embedding-row gather and in-place row scatter for sparse-row Adam.
//
// Replace the TPU kernels `gather_rows` and `scatter_set_rows`
// (ttamm_tpu/ops/pallas/rows.py, bodies `_gather_kernel` and
// `_scatter_set_kernel`): out[r] = table[idx[r]], and table[idx[r]] = rows[r]
// in place. On the TPU each lane is one async row DMA between HBM and a VMEM
// block. The sparse-row Adam update reads the m, v and weight rows of the
// touched table rows through the gather and writes them back through the
// scatter (3 + 3 launches per table per step).
//
// What bounds them on Hopper: device-memory bandwidth. They do no arithmetic;
// the least they can move is each index once, each source row once and each
// destination row once (12,288 x 128 f32 rows: 6.3 MB in and 6.3 MB out).
//
// What the design does about it: one warp per row, 16-byte vector loads and
// stores (a 128-wide f32 row is one float4 per lane), so every row moves in
// fully coalesced 512-byte transactions, and 8 rows per 256-thread block keep
// enough independent loads in flight. Any N; rows need D % 4 == 0 and 16-byte
// aligned tensors (checked by the Python wrapper).
//
// Indices are trusted to lie in [0, rows): a gather lane outside it writes a
// NaN row instead of reading outside the table, and a scatter lane outside it
// writes nothing. Duplicate scatter indices race (one lane's row wins); the
// caller sends every duplicate lane to the table's scratch row, which is never
// read (coalesce_row_grads), exactly as on the TPU.
//
// The masked forms replace `gather_rows(masked=True)` and
// `scatter_set_rows(masked=True)` (rows.py, bodies `_gather_kernel_masked` and
// `_scatter_set_kernel_masked`): the shard-local row update of a row-sharded
// table (ttamm_torch/parallel/sparse_update.py), where idx < 0 marks a lane
// whose row another shard owns, or a capacity-padding lane. Such a lane issues
// no read and no write: the masked gather leaves its output row as it was
// (uninitialised; callers never read it), and the masked scatter writes
// nothing for it. Lanes of the masked scatter that target one row carry
// identical bytes (every lane of a duplicate run holds the run's coalesced
// update), so their race is benign and no scratch row is needed. The scatter
// kernel already writes nothing for idx < 0, so the masked scatter launches
// it through the same entry point (the Python wrapper counts it apart).
//
// The TPU kernels sort their blocks into skip / full / mixed classes
// (`_block_classes`), because predicating every lane costs its scalar unit
// ~35% per update there. Not carried: one warp moves one row, so `i < 0` is a
// branch taken by the whole warp together, and a masked lane costs one index
// load and no row traffic. The masked lanes come contiguous (sorted lanes),
// so whole blocks of masked warps exit at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

template <bool kMasked>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float* __restrict__ table, const int32_t* __restrict__ idx,
                   float* __restrict__ out, int64_t n, int64_t rows, int dim) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (r >= n) return;
  const int lane = threadIdx.x & 31;
  const int vecs = dim >> 2;
  const int32_t i = idx[r];
  float4* dst = reinterpret_cast<float4*>(out + r * dim);
  if (i < 0 || i >= rows) {
    if (kMasked) return;  // a masked lane: no read, no write
    const float nan = __int_as_float(0x7fc00000);
    for (int v = lane; v < vecs; v += 32) dst[v] = make_float4(nan, nan, nan, nan);
    return;
  }
  const float4* src = reinterpret_cast<const float4*>(table + static_cast<int64_t>(i) * dim);
  for (int v = lane; v < vecs; v += 32) dst[v] = __ldg(src + v);
}

__global__ void __launch_bounds__(kThreads)
scatter_set_rows_kernel(float* __restrict__ table, const int32_t* __restrict__ idx,
                        const float* __restrict__ rows_in, int64_t n, int64_t rows,
                        int dim) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (r >= n) return;
  const int32_t i = idx[r];
  if (i < 0 || i >= rows) return;
  const int lane = threadIdx.x & 31;
  const int vecs = dim >> 2;
  const float4* src = reinterpret_cast<const float4*>(rows_in + r * dim);
  float4* dst = reinterpret_cast<float4*>(table + static_cast<int64_t>(i) * dim);
  for (int v = lane; v < vecs; v += 32) dst[v] = __ldg(src + v);
}

unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kRowsPerBlock - 1) / kRowsPerBlock);
}

}  // namespace

// table: f32 [rows, dim]; idx: i32 [n]; out: f32 [n, dim]. Contiguous,
// 16-byte aligned, dim % 4 == 0, n > 0.
extern "C" int ttamm_gather_rows(const float* table, const int32_t* idx, float* out,
                                 int64_t n, int64_t rows, int dim, cudaStream_t stream) {
  gather_rows_kernel<false><<<blocks_for(n), kThreads, 0, stream>>>(table, idx, out, n, rows,
                                                                     dim);
  return static_cast<int>(cudaGetLastError());
}

// As ttamm_gather_rows; a lane with idx < 0 (or >= rows) leaves its out row
// unwritten.
extern "C" int ttamm_gather_rows_masked(const float* table, const int32_t* idx, float* out,
                                        int64_t n, int64_t rows, int dim,
                                        cudaStream_t stream) {
  gather_rows_kernel<true><<<blocks_for(n), kThreads, 0, stream>>>(table, idx, out, n, rows,
                                                                    dim);
  return static_cast<int>(cudaGetLastError());
}

// table: f32 [rows, dim], written in place; idx: i32 [n]; rows_in: f32
// [n, dim]. Same layout requirements as the gather.
extern "C" int ttamm_scatter_set_rows(float* table, const int32_t* idx, const float* rows_in,
                                      int64_t n, int64_t rows, int dim,
                                      cudaStream_t stream) {
  scatter_set_rows_kernel<<<blocks_for(n), kThreads, 0, stream>>>(table, idx, rows_in, n,
                                                                    rows, dim);
  return static_cast<int>(cudaGetLastError());
}
