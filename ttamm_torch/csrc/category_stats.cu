// Per-category second moments for the category-alignment loss, and their
// gradient.
//
// Replace the TPU kernel `segment_second_moments` (ttamm_tpu/ops/pallas/
// category_stats.py, bodies `_m2_fwd_kernel` and `_m2_bwd_kernel`):
//   forward  M2[c] = sum_{n : cat(n) = c} bf16(x_n) bf16(x_n)^T   f32 [C, D, D]
//   backward dx_n  = bf16(H_c) bf16(x_n),  c = cat(n),  H = G + G^T   f32 [N, D]
// Operands are rounded to bf16 and the results are f32, as on the TPU. bf16 x
// bf16 products are exact, so two implementations differ only in how they
// round the sums. The forward sums in f64 and rounds each M2 entry to f32
// once: its M2 is the exact sum rounded, the same bits whatever the order
// or the chunking. (The bf16 tensor cores, `mma.sync` bf16 -> f32, truncate
// each 16-product sum toward zero: an M2 biased by up to an ulp, off from the
// rounded exact sum in ~9-22% of entries, which the backward's bf16(H) turns
// into bf16-ulp gradient steps.) Rows whose category id is outside [0, C) add
// nothing forward and get a zero gradient.
//
// The TPU kernel keeps a [C, D, D] f32 accumulator (4 MB at C = 64, D = 128)
// in VMEM while its sequential grid streams the rows; a Hopper block has at
// most 227 KB of shared memory and blocks run in no order. So the rows are
// grouped once per loss call (`group_count_kernel` and `group_scatter_kernel`
// below; their plain version is `_group_by_category` in
// ttamm_torch/ops/kernels.py): a stable sort of the ids gives
// `order`, each category's run `offsets` [C + 2] (run C holds the ids outside
// [0, C)), and a work list of row chunks: category c's run is cut into chunks
// of R = kChunkRows rows, chunks [chunk_offsets[c], chunk_offsets[c + 1]), and
// `chunk_cat[j]` names chunk j's category (C + 1 past the last chunk). Chunk j
// of category c covers order[begin, begin + rows) with
// begin = offsets[c] + (j - chunk_offsets[c]) * R. Any skew of the category
// sizes becomes blocks of at most R rows, spread over every SM.
//
// - forward, pass 1 (`m2_chunk_kernel`): one block per chunk gathers its rows
//   through `order` with 16-byte loads, rounds each to bf16 once and stages
//   them in shared memory ([rows][D rounded up to 32] bf16, each row padded
//   by 16 bytes: the 4 rows a warp's operand load reads, and the 8 an
//   `ldmatrix` reads, fall in distinct banks). The block's 16 warps compute
//   the chunk's partial Xc^T Xc on the f64 tensor cores (`mma.sync.m16n8k8` f64,
//   the bf16 values widened exactly; both operands read from the one staged
//   tile), a 32 x 32 output tile ti <= tj per warp at a time, written at
//   (i, j) and (j, i) to an f64 scratch slot of the chunk; a category of one
//   chunk rounds its tile to f32 and writes M2[c] itself.
// - forward, pass 2 (`m2_reduce_kernel`): M2[c] is the f64 sum of its chunks'
//   partials in chunk order, rounded to f32 once (16-byte loads, all
//   categories and column blocks in one grid); empty categories are written
//   as 0. The order of every addition is fixed (no atomics).
// - backward (`m2_bwd_kernel`): one block per (chunk, 64-column tile of dx)
//   stages the chunk's bf16 rows and the category's bf16 rows H_c[e0:e0+64],
//   computes dXc = Xc H_c^T on the bf16 tensor cores (`mma.sync.m16n8k16`
//   bf16 -> f32 on `ldmatrix` loads, without .trans: the product reads H as
//   stored, so it needs no symmetry; each MMA's 16-product sum is added to
//   the running f32 sum with one round-to-nearest add, `mma_add`), stages
//   the f32 tile in shared memory and writes each dx row back to its
//   original position with 16-byte stores; chunks of run C write zeros.
//
// What bounds them on Hopper: bytes. x is read once (6.3 MB at 12,288 x 128
// rows), M2 or H once (4.2 MB at C = 64), dx written once, against
// 2 N D^2 = 0.4 GFLOP a direction (~0.4 us at the bf16 peak; the forward
// halves it by symmetry, ~3 us at the 67 TFLOP/s f64 tensor-core peak). What
// the grid adds: each chunk's partial (D^2 f64) written and read back through
// the 50 MB L2, and H_c read once per chunk of c (from L2), the gather
// latency of one chunk, and the reduction pass.
//
// Domain: D <= 512 (the staged rows of a 128-row chunk and a 64-row H tile fit
// a block's 227 KB), any C > 0 and N >= 0.
// D % 4 != 0 (or an unaligned tensor) takes scalar loads and stores; columns
// from D up to the next multiple of 32 and rows past a chunk's end are zeros
// in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // the backward's and the reduction's blocks
constexpr int kWarps = kThreads / 32;
constexpr int kChunkThreads = 512;  // the forward's chunk blocks (one a chunk: more loads in flight)
constexpr int kChunkRows = 128;     // R (M2_CHUNK_ROWS in ttamm_torch/ops/kernels.py)
constexpr int kTile = 32;           // a warp's output tile: 32 x 32 (2 x 4 m16n8k8 forward,
                                    // 2 x 4 m16n8k16 backward)
constexpr int kRowPad = 8;          // bf16 a staged row carries past its width
constexpr int kUnroll = 8;          // 16-byte loads in flight per thread while staging
constexpr int kBwdCols = 64;        // dx columns per backward block
constexpr int kOutStride = kBwdCols + 8;  // f32 per staged dx row (conflict-free float2 writes)
constexpr int kReduceVec = 4;       // M2 entries per reduction thread
static_assert(kChunkRows % kTile == 0 && (kChunkRows / kTile) * (kBwdCols / kTile) <= kWarps,
              "the backward gives each warp at most one output tile");

__host__ __device__ __forceinline__ int round_up(int v, int m) { return (v + m - 1) / m * m; }

__device__ __forceinline__ uint2 pack_bf16x4(float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 r;
  r.x = *reinterpret_cast<const uint32_t*>(&lo);
  r.y = *reinterpret_cast<const uint32_t*>(&hi);
  return r;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// acc += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, f32
// out. The tensor core aligns the 16 exact products to the largest and
// truncates their sum; that sum goes into fresh registers and is added to
// acc with one round-to-nearest f32 add, so the running total is never
// truncated (chaining acc through the MMAs would truncate it at every step).
__device__ __forceinline__ void mma_add(float (&acc)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  float d[4];
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
#pragma unroll
  for (int v = 0; v < 4; ++v) acc[v] += d[v];
}

// Stage rows [0, rows_pad) of bf16(src[row(r), 0:dim]) into dst (row stride
// `stride`, `width` columns): rows from `count` and columns from `dim` are 0.
template <int Threads, typename RowFn>
__device__ __forceinline__ void stage_bf16(const float* __restrict__ src, RowFn row, int count,
                                           int rows_pad, int dim, int width, int stride,
                                           bool vec4, __nv_bfloat16* dst) {
  if (vec4) {
    const int units = width / 4;
    const int total = rows_pad * units;
    for (int e0 = threadIdx.x; e0 < total; e0 += Threads * kUnroll) {
      float4 v[kUnroll];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {  // every load issued before any store
        const int e = e0 + q * Threads;
        const int r = e / units;
        const int col = (e - r * units) * 4;
        v[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (e < total && r < count && col < dim) {
          v[q] = __ldg(reinterpret_cast<const float4*>(src + row(r) * dim + col));
        }
      }
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const int e = e0 + q * Threads;
        if (e < total) {
          const int r = e / units;
          const int col = (e - r * units) * 4;
          *reinterpret_cast<uint2*>(dst + r * stride + col) = pack_bf16x4(v[q]);
        }
      }
    }
  } else {
    const int total = rows_pad * width;
    for (int e = threadIdx.x; e < total; e += Threads) {
      const int r = e / width;
      const int col = e - r * width;
      const float v = r < count && col < dim ? src[row(r) * dim + col] : 0.0f;
      dst[r * stride + col] = __float2bfloat16_rn(v);
    }
  }
}

struct Chunk {
  int cat, begin, rows;
};

// Chunk j of the work list; cat > C past the last chunk (rows then unset).
__device__ __forceinline__ Chunk chunk_at(int j, const int32_t* __restrict__ offsets,
                                          const int32_t* __restrict__ chunk_offsets,
                                          const int32_t* __restrict__ chunk_cat,
                                          int num_categories) {
  Chunk ch;
  ch.cat = chunk_cat[j];
  if (ch.cat > num_categories) return ch;
  ch.begin = offsets[ch.cat] + (j - chunk_offsets[ch.cat]) * kChunkRows;
  ch.rows = min(kChunkRows, offsets[ch.cat + 1] - ch.begin);
  return ch;
}

// acc (16 x 8 f64) += a (16 x 8) * b (8 x 8) on the f64 tensor cores. Lane
// (g, t) = (l / 4, l % 4) holds a at rows g, g + 8 and columns t, t + 4
// (a0 = [g][t], a1 = [g + 8][t], a2 = [g][t + 4], a3 = [g + 8][t + 4]), b
// at rows t, t + 4 of column g, and acc rows g (lo) and g + 8 (hi) at
// columns 2t, 2t + 1.
__device__ __forceinline__ void dmma(double (&lo)[2], double (&hi)[2], const double (&a)[4],
                                     double b0, double b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(lo[0]), "+d"(lo[1]), "+d"(hi[0]), "+d"(hi[1])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
}

__global__ void __launch_bounds__(kChunkThreads)
m2_chunk_kernel(const float* __restrict__ x, const int64_t* __restrict__ order,
                const int32_t* __restrict__ offsets, const int32_t* __restrict__ chunk_offsets,
                const int32_t* __restrict__ chunk_cat, float* __restrict__ m2,
                double* __restrict__ partial, int num_categories, int dim, int vec4) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int64_t s_rows[kChunkRows];
  const int j = blockIdx.x;
  const Chunk ch = chunk_at(j, offsets, chunk_offsets, chunk_cat, num_categories);
  if (ch.cat >= num_categories) return;  // the ids outside [0, C), or past the last chunk
  for (int r = threadIdx.x; r < ch.rows; r += kChunkThreads) s_rows[r] = order[ch.begin + r];
  __syncthreads();

  const int width = round_up(dim, kTile);
  const int stride = width + kRowPad;
  const int depth = round_up(ch.rows, 8);  // the product's K: rows, zero-padded
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  stage_bf16<kChunkThreads>(x, [&](int r) { return s_rows[r]; }, ch.rows, depth, dim, width, stride,
                            vec4, xs);
  __syncthreads();

  const int64_t dd = static_cast<int64_t>(dim) * dim;
  const bool alone = chunk_offsets[ch.cat + 1] - chunk_offsets[ch.cat] == 1;
  float* out = m2 + ch.cat * dd;
  double* part = partial + j * dd;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int tiles = width / kTile;
  // M2 is symmetric: the warps take the 32 x 32 tiles (ti, tj), ti <= tj, and
  // each value is written at (i, j) and (j, i)
  for (int tile = warp; tile < tiles * (tiles + 1) / 2; tile += kChunkThreads / 32) {
    int ti = 0, rest = tile;
    while (rest >= tiles - ti) rest -= tiles - ti++;
    const int tj = ti + rest;
    const int i0 = ti * kTile;
    const int j0 = tj * kTile;
    double acc[4][4][2] = {};  // [8-row group m][8-column group n]: rows i0 + 8m + g
    // A[i][k] = Xc[k][i] and B[k][j] = Xc[k][j]: lane (g, t) reads rows
    // k0 + t and k0 + 4 + t at columns i0 + 8m + g and j0 + 8n + g (16 bytes
    // of 4 rows a warp load, in distinct banks)
    const __nv_bfloat16* col_a = xs + t * stride + i0 + g;
    const __nv_bfloat16* col_b = xs + t * stride + j0 + g;
    for (int k0 = 0; k0 < depth; k0 += 8) {
      double a[2][4], b[2][4];  // [k half][8-row group]
#pragma unroll
      for (int q = 0; q < 2; ++q) {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          a[q][m] = static_cast<double>(__bfloat162float(col_a[(k0 + 4 * q) * stride + 8 * m]));
          b[q][m] = static_cast<double>(__bfloat162float(col_b[(k0 + 4 * q) * stride + 8 * m]));
        }
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const double frag[4] = {a[0][2 * p], a[0][2 * p + 1], a[1][2 * p], a[1][2 * p + 1]};
#pragma unroll
        for (int n = 0; n < 4; ++n) dmma(acc[2 * p][n], acc[2 * p + 1][n], frag, b[0][n], b[1][n]);
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int i = i0 + 8 * m + g;
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int col = j0 + 8 * n + 2 * t + v;
          if (i >= dim || col >= dim) continue;
          if (alone) {
            const float value = __double2float_rn(acc[m][n][v]);
            out[static_cast<int64_t>(i) * dim + col] = value;
            if (ti != tj) out[static_cast<int64_t>(col) * dim + i] = value;
          } else {
            part[static_cast<int64_t>(i) * dim + col] = acc[m][n][v];
            if (ti != tj) part[static_cast<int64_t>(col) * dim + i] = acc[m][n][v];
          }
        }
      }
    }
  }
}

// M2[c] = the f64 sum of category c's chunk partials in chunk order, rounded
// to f32 once; 0 for an empty category; left as written by its chunk for a
// category of one chunk.
__global__ void __launch_bounds__(kThreads)
m2_reduce_kernel(const double* __restrict__ partial, const int32_t* __restrict__ chunk_offsets,
                 float* __restrict__ m2, int64_t dd) {
  const int c = blockIdx.y;
  const int first = chunk_offsets[c];
  const int count = chunk_offsets[c + 1] - first;
  if (count == 1) return;
  const int64_t e = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kReduceVec;
  if (e >= dd) return;
  const double* src = partial + first * dd + e;
  float* out = m2 + c * dd + e;
  if (dd % kReduceVec == 0) {
    double s[kReduceVec] = {};
#pragma unroll 4
    for (int q = 0; q < count; ++q) {  // loads run ahead; the adds keep chunk order
      const double2 lo = __ldcg(reinterpret_cast<const double2*>(src + q * dd));
      const double2 hi = __ldcg(reinterpret_cast<const double2*>(src + q * dd + 2));
      s[0] += lo.x;
      s[1] += lo.y;
      s[2] += hi.x;
      s[3] += hi.y;
    }
    *reinterpret_cast<float4*>(out) = make_float4(__double2float_rn(s[0]), __double2float_rn(s[1]),
                                                  __double2float_rn(s[2]), __double2float_rn(s[3]));
  } else {
    for (int v = 0; v < kReduceVec && e + v < dd; ++v) {
      double s = 0.0;
      for (int q = 0; q < count; ++q) s += __ldcg(src + q * dd + v);
      out[v] = __double2float_rn(s);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
m2_bwd_kernel(const float* __restrict__ x, const float* __restrict__ h,
              const int64_t* __restrict__ order, const int32_t* __restrict__ offsets,
              const int32_t* __restrict__ chunk_offsets, const int32_t* __restrict__ chunk_cat,
              float* __restrict__ dx, int num_categories, int dim, int vec4) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int64_t s_rows[kChunkRows];
  const Chunk ch = chunk_at(blockIdx.x, offsets, chunk_offsets, chunk_cat, num_categories);
  if (ch.cat > num_categories) return;  // past the last chunk
  for (int r = threadIdx.x; r < ch.rows; r += kThreads) s_rows[r] = order[ch.begin + r];
  const int e0 = blockIdx.y * kBwdCols;
  const int cols = min(kBwdCols, dim - e0);
  float* staged = reinterpret_cast<float*>(smem);  // [rows][kOutStride] f32 dx tile

  if (ch.cat < num_categories) {
    const int width = round_up(dim, kTile);
    const int stride = width + kRowPad;
    const int rows_pad = round_up(ch.rows, kTile);
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* hs = xs + kChunkRows * stride;  // [kBwdCols][stride]: H_c[e0 + e, :]
    __syncthreads();
    stage_bf16<kThreads>(x, [&](int r) { return s_rows[r]; }, ch.rows, rows_pad, dim, width,
                         stride, vec4, xs);
    const float* hc = h + ch.cat * static_cast<int64_t>(dim) * dim;
    stage_bf16<kThreads>(hc, [&](int r) { return static_cast<int64_t>(e0 + r); }, cols, kBwdCols,
                         dim, width, stride, vec4, hs);
    __syncthreads();

    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int lrow = lane % 8, lq0 = (lane / 8) % 2, lq1 = lane / 16;
    const int r0 = warp / 2 * kTile;  // this warp's tile: rows r0.., dx columns n0..
    const int n0 = warp % 2 * kTile;
    const bool busy = r0 < rows_pad && n0 < cols;
    float acc[2][4][4] = {};
    if (busy) {
      const int depth = round_up(dim, 16);
      for (int k0 = 0; k0 < depth; k0 += 16) {
        // A = Xc (rows r, depth d) as staged; B[d][e] = H[e][d], staged [e][d]
        uint32_t a[2][4], b[4][2], q[4];
        const __nv_bfloat16* arow = xs + (r0 + lrow + 8 * lq0) * stride + k0 + 8 * lq1;
        ldsm_x4(a[0], arow);
        ldsm_x4(a[1], arow + 16 * stride);
        const __nv_bfloat16* brow = hs + (n0 + lrow + 8 * lq1) * stride + k0 + 8 * lq0;
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          ldsm_x4(q, brow + 16 * p * stride);
          b[2 * p][0] = q[0];
          b[2 * p][1] = q[1];
          b[2 * p + 1][0] = q[2];
          b[2 * p + 1][1] = q[3];
        }
#pragma unroll
        for (int m = 0; m < 2; ++m) {
#pragma unroll
          for (int n = 0; n < 4; ++n) mma_add(acc[m][n], a[m], b[n][0], b[n][1]);
        }
      }
    }
    __syncthreads();  // the staged operands are dead: the dx tile takes their place
    if (busy) {
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = r0 + 16 * m + g + 8 * hh;
            *reinterpret_cast<float2*>(staged + r * kOutStride + n0 + 8 * n + 2 * t) =
                make_float2(acc[m][n][2 * hh], acc[m][n][2 * hh + 1]);
          }
        }
      }
    }
  }
  __syncthreads();
  // each row back to its place; run C (ids outside [0, C)) writes zeros
  const bool zero = ch.cat == num_categories;
  constexpr int kUnits = kBwdCols / 4;
  for (int e = threadIdx.x; e < ch.rows * kUnits; e += kThreads) {
    const int r = e / kUnits;
    const int col = (e % kUnits) * 4;
    if (col >= cols) continue;
    float* dst = dx + s_rows[r] * dim + e0 + col;
    const float4 v = zero ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                          : *reinterpret_cast<const float4*>(staged + r * kOutStride + col);
    if (vec4) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      const float w[4] = {v.x, v.y, v.z, v.w};
      for (int q = 0; q < 4 && col + q < cols; ++q) dst[q] = w[q];
    }
  }
}

// The grouping (see the top of this file): a stable counting sort of the
// category keys (ids outside [0, C) -> key C) in two kernels. Global warp w
// of the grid owns the w-th contiguous segment of rows and walks it in
// order, 32 rows at a time; the lanes of one key are found with one ballot a
// key bit and their leader counts them in the warp's column of `counts`
// [C + 1][warps]. The last block to finish (an integer ticket) scans the
// counts in that order, which gives each warp its first slot in each run,
// then the run offsets, the chunk offsets and the work list. The second kernel walks the same segments again
// and writes each row to its slot, ranked among its warp's earlier rows of
// the same key. Integer work only, in a fixed order: the same bits on every
// call, equal to a stable sort's.
constexpr int kGroupThreads = 512;
constexpr int kGroupWarps = kGroupThreads / 32;  // warps a block
constexpr int kGroupRowsPerWarp = 128;           // rows a warp walks, as far as kGroupMaxBlocks allows
constexpr int kGroupMaxBlocks = 512;
constexpr int kGroupUnroll = 2;                  // rows a lane loads ahead
constexpr int kGroupSharedRuns = 640;            // a block's counts in shared memory up to C + 1 runs (40 KB)
constexpr int kScanItems = 8;                    // counts a thread scans at a time
static_assert(kGroupThreads * kScanItems <= kGroupSharedRuns * kGroupWarps,
              "a scan tile fits the block's shared counts");

template <typename Id>
__device__ __forceinline__ int key_of(const Id* __restrict__ ids, int row, int end,
                                      int num_categories) {
  if (row >= end) return -1;
  const Id id = ids[row];
  return id >= 0 && id < num_categories ? static_cast<int>(id) : num_categories;
}

// Exclusive scan of v in thread order; `sum` gets the block's total.
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_warp, int& sum) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kGroupWarps ? s_warp[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kGroupWarps) s_warp[lane] = w;
  }
  __syncthreads();
  const int before = warp ? s_warp[warp - 1] : 0;
  sum = s_warp[kGroupWarps - 1];
  __syncthreads();  // s_warp is free for the next scan
  return before + x - v;
}

// The lanes whose key equals this lane's, keys in [-1, 2^bits - 1): one
// ballot a bit of key + 1 (a warp match costs more with more distinct keys).
__device__ __forceinline__ unsigned same_key_lanes(int key, int bits) {
  const unsigned v = static_cast<unsigned>(key + 1);
  unsigned peers = 0xffffffffu;
  for (int b = 0; b < bits; ++b) {
    const unsigned set = __ballot_sync(0xffffffffu, (v >> b) & 1u);
    peers &= (v >> b) & 1u ? set : ~set;
  }
  return peers;
}

// Walk this warp's rows [begin, end) in order; fn(key, peers, row) for each
// 32 of them.
template <typename Id, typename Fn>
__device__ __forceinline__ void walk_rows(const Id* __restrict__ ids, int begin, int end,
                                          int num_categories, Fn fn) {
  const int lane = threadIdx.x % 32;
  const int bits = 32 - __clz(num_categories + 1);
  for (int base = begin; base < end; base += 32 * kGroupUnroll) {
    int keys[kGroupUnroll];
#pragma unroll
    for (int u = 0; u < kGroupUnroll; ++u) {  // every load issued before the first ballot
      keys[u] = key_of(ids, base + 32 * u + lane, end, num_categories);
    }
#pragma unroll
    for (int u = 0; u < kGroupUnroll; ++u) {
      const unsigned peers = same_key_lanes(keys[u], bits);
      if (keys[u] >= 0) fn(keys[u], peers, base + 32 * u + lane);
      __syncwarp();
    }
  }
}

struct WarpRows {
  int warp, lane, global, begin, end;  // global: the warp's column of counts
};

__device__ __forceinline__ WarpRows warp_rows(int n) {
  WarpRows r;
  r.warp = threadIdx.x / 32;
  r.lane = threadIdx.x % 32;
  r.global = blockIdx.x * kGroupWarps + r.warp;
  const int warps = gridDim.x * kGroupWarps;
  const int seg = (n + warps - 1) / warps;
  r.begin = min(n, r.global * seg);
  r.end = min(n, r.begin + seg);
  return r;
}

// This warp's running counts: its row of the block's shared table where the
// runs fit (stride 1), else its column of `counts` (stride = warps).
struct WarpCounts {
  int32_t* base;
  int stride;
};

__device__ __forceinline__ WarpCounts warp_counts(int32_t* s_counts, int32_t* counts, int runs,
                                                  const WarpRows& r) {
  if (runs <= kGroupSharedRuns) return {s_counts + r.warp * runs, 1};
  return {counts + r.global, static_cast<int>(gridDim.x) * kGroupWarps};
}

template <typename Id>
__global__ void __launch_bounds__(kGroupThreads)
group_count_kernel(const Id* __restrict__ ids, int n, int num_categories,
                   int32_t* __restrict__ counts, int32_t* __restrict__ offsets,
                   int32_t* __restrict__ chunk_offsets, int32_t* __restrict__ chunk_cat,
                   int num_work, unsigned int* __restrict__ ticket) {
  __shared__ int32_t s_counts[kGroupSharedRuns * kGroupWarps];
  __shared__ int s_warp[kGroupWarps];
  __shared__ bool s_last;
  const int runs = num_categories + 1;
  const int warps = gridDim.x * kGroupWarps;
  const WarpRows r = warp_rows(n);
  const WarpCounts mine = warp_counts(s_counts, counts, runs, r);
  for (int k = r.lane; k < runs; k += 32) mine.base[k * mine.stride] = 0;
  __syncwarp();
  walk_rows(ids, r.begin, r.end, num_categories, [&](int key, unsigned peers, int) {
    if (r.lane == __ffs(peers) - 1) mine.base[key * mine.stride] += __popc(peers);
  });
  if (mine.stride == 1) {
    for (int k = r.lane; k < runs; k += 32) counts[k * warps + r.global] = mine.base[k];
  }
  // the last block to finish scans everyone's counts
  __threadfence();
  __syncthreads();
  // atomicInc wraps the ticket back to 0 as the last block takes it
  if (threadIdx.x == 0) s_last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // an exclusive scan of counts in its [run][warp] order gives each warp its
  // first slot in each run (rows of earlier runs, then of earlier warps); a
  // tile at a time through shared memory, loaded and stored coalesced
  const int m = runs * warps;
  int32_t* tile = s_counts;  // this block's counts are in `counts` already
  int carry = 0;
  for (int t0 = 0; t0 < m; t0 += kGroupThreads * kScanItems) {
#pragma unroll
    for (int q = 0; q < kScanItems; ++q) {
      const int e = t0 + q * kGroupThreads + threadIdx.x;
      tile[q * kGroupThreads + threadIdx.x] = e < m ? __ldcg(counts + e) : 0;
    }
    __syncthreads();
    int v[kScanItems], sum = 0;
#pragma unroll
    for (int q = 0; q < kScanItems; ++q) {
      v[q] = tile[threadIdx.x * kScanItems + q];
      sum += v[q];
    }
    int total;
    int before = carry + block_exclusive_scan(sum, s_warp, total);
#pragma unroll
    for (int q = 0; q < kScanItems; ++q) {
      tile[threadIdx.x * kScanItems + q] = before;
      before += v[q];
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kScanItems; ++q) {
      const int e = t0 + q * kGroupThreads + threadIdx.x;
      if (e < m) counts[e] = tile[q * kGroupThreads + threadIdx.x];
    }
    __syncthreads();
    carry += total;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < runs; k += kGroupThreads) offsets[k] = counts[k * warps];
  if (threadIdx.x == 0) offsets[runs] = n;
  __syncthreads();
  int chunks_before = 0;
  for (int k0 = 0; k0 < runs; k0 += kGroupThreads) {
    const int k = k0 + threadIdx.x;
    const int rows = k < runs ? offsets[k + 1] - offsets[k] : 0;
    int tile;
    const int chunk0 =
        chunks_before + block_exclusive_scan((rows + kChunkRows - 1) / kChunkRows, s_warp, tile);
    if (k < runs) chunk_offsets[k] = chunk0;
    chunks_before += tile;
  }
  if (threadIdx.x == 0) chunk_offsets[runs] = chunks_before;
  __syncthreads();
  // the work list: each run's chunks, then C + 1 past the last chunk
  for (int k = threadIdx.x; k < runs; k += kGroupThreads) {
    for (int j = chunk_offsets[k]; j < chunk_offsets[k + 1]; ++j) chunk_cat[j] = k;
  }
  for (int j = chunks_before + threadIdx.x; j < num_work; j += kGroupThreads) chunk_cat[j] = runs;
}

template <typename Id>
__global__ void __launch_bounds__(kGroupThreads)
group_scatter_kernel(const Id* __restrict__ ids, int n, int num_categories,
                     int32_t* __restrict__ counts, int64_t* __restrict__ order) {
  __shared__ int32_t s_counts[kGroupSharedRuns * kGroupWarps];
  const int runs = num_categories + 1;
  const int warps = gridDim.x * kGroupWarps;
  const WarpRows r = warp_rows(n);
  const WarpCounts mine = warp_counts(s_counts, counts, runs, r);
  if (mine.stride == 1) {  // the warp's first slot in each run, from its column of counts
    for (int k = r.lane; k < runs; k += 32) mine.base[k] = counts[k * warps + r.global];
  }
  __syncwarp();
  walk_rows(ids, r.begin, r.end, num_categories, [&](int key, unsigned peers, int row) {
    order[mine.base[key * mine.stride] + __popc(peers & ((1u << r.lane) - 1))] = row;
    __syncwarp(peers);
    if (r.lane == __ffs(peers) - 1) mine.base[key * mine.stride] += __popc(peers);
  });
}

}  // namespace

// x: f32 [n, dim]; order: i64 [n], the row ids grouped by category;
// offsets, chunk_offsets: i32 [C + 2]; chunk_cat: i32 [num_chunks] (the work
// list, see above); m2: f32 [C, dim, dim]; partial: f64 [num_chunks, dim,
// dim] scratch. All contiguous; C > 0, dim <= 512; vec4: dim % 4 == 0 and x
// 16-byte aligned. Two kernels: the chunks' partials, then their sums.
extern "C" int ttamm_segment_second_moments(const float* x, const int64_t* order,
                                            const int32_t* offsets,
                                            const int32_t* chunk_offsets,
                                            const int32_t* chunk_cat, float* m2, double* partial,
                                            int num_categories, int dim, int num_chunks,
                                            int vec4, cudaStream_t stream) {
  const int smem = kChunkRows * (round_up(dim, kTile) + kRowPad) * 2;
  cudaError_t err = cudaFuncSetAttribute(m2_chunk_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  m2_chunk_kernel<<<num_chunks, kChunkThreads, smem, stream>>>(x, order, offsets, chunk_offsets,
                                                          chunk_cat, m2, partial, num_categories,
                                                          dim, vec4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t dd = static_cast<int64_t>(dim) * dim;
  const dim3 grid(static_cast<unsigned int>((dd + kThreads * kReduceVec - 1) / (kThreads * kReduceVec)),
                  static_cast<unsigned int>(num_categories));
  m2_reduce_kernel<<<grid, kThreads, 0, stream>>>(partial, chunk_offsets, m2, dd);
  return static_cast<int>(cudaGetLastError());
}

// x: f32 [n, dim]; h: f32 [C, dim, dim]; order, offsets, chunk_offsets,
// chunk_cat: the forward's grouping; dx: f32 [n, dim]. dim <= 512; vec4:
// dim % 4 == 0 and x, h 16-byte aligned.
extern "C" int ttamm_segment_second_moments_bwd(const float* x, const float* h,
                                                const int64_t* order, const int32_t* offsets,
                                                const int32_t* chunk_offsets,
                                                const int32_t* chunk_cat, float* dx,
                                                int num_categories, int dim, int num_chunks,
                                                int vec4, cudaStream_t stream) {
  const int operands = (kChunkRows + kBwdCols) * (round_up(dim, kTile) + kRowPad) * 2;
  const int tile = kChunkRows * kOutStride * static_cast<int>(sizeof(float));
  const int smem = operands > tile ? operands : tile;
  const cudaError_t err = cudaFuncSetAttribute(
      m2_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>(num_chunks),
                  static_cast<unsigned int>((dim + kBwdCols - 1) / kBwdCols));
  m2_bwd_kernel<<<grid, kThreads, smem, stream>>>(x, h, order, offsets, chunk_offsets, chunk_cat,
                                                  dx, num_categories, dim, vec4);
  return static_cast<int>(cudaGetLastError());
}

// ids: i32 (ids64 = 0) or i64 [n]; order: i64 [n]; offsets, chunk_offsets:
// i32 [C + 2]; chunk_cat: i32 [num_work], num_work >= ceil(n / R) + C + 1;
// counts: i32 [(C + 1) ttamm_category_grouping_warps(n)] scratch; ticket: one
// i32, 0 (the call leaves it 0). Two kernels.
extern "C" int ttamm_category_grouping_warps(int n) {
  const int per_block = kGroupWarps * kGroupRowsPerWarp;
  return min(kGroupMaxBlocks, max(1, (n + per_block - 1) / per_block)) * kGroupWarps;
}

extern "C" int ttamm_category_grouping(const void* ids, int ids64, int n, int num_categories,
                                       int64_t* order, int32_t* offsets, int32_t* chunk_offsets,
                                       int32_t* chunk_cat, int num_work, int32_t* counts,
                                       unsigned int* ticket, cudaStream_t stream) {
  const int blocks = ttamm_category_grouping_warps(n) / kGroupWarps;
  if (ids64) {
    const int64_t* id = static_cast<const int64_t*>(ids);
    group_count_kernel<<<blocks, kGroupThreads, 0, stream>>>(
        id, n, num_categories, counts, offsets, chunk_offsets, chunk_cat, num_work, ticket);
    group_scatter_kernel<<<blocks, kGroupThreads, 0, stream>>>(id, n, num_categories, counts,
                                                               order);
  } else {
    const int32_t* id = static_cast<const int32_t*>(ids);
    group_count_kernel<<<blocks, kGroupThreads, 0, stream>>>(
        id, n, num_categories, counts, offsets, chunk_offsets, chunk_cat, num_work, ticket);
    group_scatter_kernel<<<blocks, kGroupThreads, 0, stream>>>(id, n, num_categories, counts,
                                                               order);
  }
  return static_cast<int>(cudaGetLastError());
}
