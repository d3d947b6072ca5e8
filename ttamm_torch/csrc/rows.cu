// Embedding-row gather and in-place row scatter, and the fused sparse-row
// Adam update of one table.
//
// Replace the TPU kernels `gather_rows` and `scatter_set_rows`
// (ttamm_tpu/ops/pallas/rows.py, bodies `_gather_kernel` and
// `_scatter_set_kernel`): out[r] = table[idx[r]], and table[idx[r]] = rows[r]
// in place. On the TPU each lane is one async row DMA between HBM and a VMEM
// block. There the sparse-row Adam update reads the m, v and weight rows of the
// touched table rows through the gather and writes them back through the
// scatter (3 + 3 launches per table per step), with XLA's fused arithmetic in
// between (ttamm_tpu/ops/sparse_adam.py, the `use_pallas` path).
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
// writes nothing. Duplicate scatter indices race (one lane's row wins), so a
// caller sends every duplicate lane to a row whose value is never read, or
// masks it (idx < 0).
//
// The masked gather replaces `gather_rows(masked=True)` (rows.py, body
// `_gather_kernel_masked`, which leaves a masked lane's row uninitialised),
// and computes the function of the lookup of a row-sharded table
// (ttamm_torch/parallel/embedding_lookup.py; the JAX package's
// parallel/embedding_lookup.py:27-35 takes the clamped lanes, then zeroes
// the foreign ones with `jnp.where`): out[r] = local[idx[r] - base] where
// 0 <= idx[r] - base < rows (the lanes this shard owns), else zeros, so that
// a sum over the model shards gives every lane its row. The localisation
// (idx - base, the range test) and the zeros happen in the kernel: the
// eager ops around a plain gather (shift, range test, clamp, where, zeros)
// become none. Bound by bytes: every lane's index, each owned distinct row
// read once, every lane's row written (12,288 lanes x 512 B at one
// canonical step's item lanes). One warp moves one row with 16-byte
// vectors; a foreign lane's warp stores zeros and reads no row. Lanes come
// in batch order, so owned and foreign lanes interleave, and a warp's
// branch is taken by all of its threads together. Measured at one step's
// lookup (scripts/masked_gather_variants.py): 2, 4 or 8 rows a warp (every
// index, then every row's loads, before the stores; or the zeros stored
// first), 128 or 512 threads and streaming stores are no faster.
//
// The masked scatter replaces `scatter_set_rows(masked=True)` (rows.py,
// body `_scatter_set_kernel_masked`): idx < 0 marks a lane whose row another
// shard owns, or a capacity-padding lane, and such a lane writes nothing.
// The scatter kernel already writes nothing for idx < 0, so the masked
// scatter launches it through the same entry point (the Python wrapper
// counts it apart). Since the sharded sparse-row update runs on
// sparse_adam_rows, the masked scatter is on no path; it stays, held to its
// plain version and to the JAX kernel.
//
// The TPU kernels sort their blocks into skip / full / mixed classes
// (`_block_classes`), because predicating every lane costs its scalar unit
// ~35% per update there. Not carried: one warp moves one row, so a masked
// lane is a branch taken by the whole warp together.
//
// sparse_adam_rows replaces the whole row update of one sparse table after
// the coalesce (ttamm_tpu/ops/sparse_adam.py:191-208: gather_rows x 3, the
// Adam arithmetic, scatter_set_rows x 3) with one read-modify-write pass:
// for each lane r with i = idx[r] >= 0 it reads w[i], m[i], v[i] and
// grads[r], applies Adam and writes w[i], m[i], v[i] back. Bound by bytes:
// each live lane moves its gradient row in and three rows in and out, 7 x
// 512 B at D = 128 (40.7 MB at one canonical item-table step), and its
// index. The [N, D] intermediates of the unfused composition (three gathered
// rows, fourteen eager elementwise passes, three scattered rows) never leave
// registers. One warp takes one row: it loads the row's index, then each
// lane its 16-byte vectors of w, m, v and grads (four independent loads in
// flight per lane) before any arithmetic or store; the loads and stores
// stream (evict-first), as no row is read twice. Measured at one canonical
// step (scripts/sparse_adam_variants.py): 2, 4 or 8 rows a warp, 128 or 512
// threads and plain loads and stores are no faster; the occupancy of one
// row a warp already hides the index load. Each live row is the target of
// one lane at most (the caller gives the non-head lanes of a duplicate run
// idx = -1), so no two lanes touch one row: no atomics, no shared memory,
// and no write storm on a scratch row. The sharded update of a row-sharded
// table (ttamm_torch/parallel/sparse_update.py) gives idx = -1 to the lanes
// another shard owns as well: one launch a table a step on each shard, in
// place of 3 masked gathers, the eager Adam passes and 3 masked scatters.
//
// The arithmetic is the eager PyTorch composition's on the card, bit for
// bit: one correctly rounded operation per eager op, in the eager order,
// through the _rn intrinsics, which nvcc does not contract into FMAs. A
// tensor divided by a Python scalar c is, in PyTorch on CUDA, a multiply by
// 1 / c formed in double and rounded to f32 once (measured:
// scripts/sparse_adam_variants.py); Python scalars reach the eager ops cast
// to f32. So the bias corrections' reciprocals and the f32 scalars come from
// the host (AdamScalars), formed there exactly as PyTorch forms them.
//
// The kernel reads those scalars from device memory, through a pointer to
// one step's row of a table of per-step scalars, not by value: a launch
// captured into a CUDA graph freezes its by-value arguments, and the
// multi-step train call replays one captured step many times, each replay
// at its own step. The host writes the table once per chunk of steps; each
// thread loads the nine floats once (they stay in L1), so the arithmetic and
// its bits are those of the by-value form.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

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
    const float nan = __int_as_float(0x7fc00000);
    for (int v = lane; v < vecs; v += 32) dst[v] = make_float4(nan, nan, nan, nan);
    return;
  }
  const float4* src = reinterpret_cast<const float4*>(table + static_cast<int64_t>(i) * dim);
  for (int v = lane; v < vecs; v += 32) dst[v] = __ldg(src + v);
}

__global__ void __launch_bounds__(kThreads)
gather_rows_masked_kernel(const float* __restrict__ local, const int32_t* __restrict__ idx,
                          float* __restrict__ out, int64_t n, int64_t rows, int dim,
                          int64_t base) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (r >= n) return;
  const int lane = threadIdx.x & 31;
  const int vecs = dim >> 2;
  const int64_t i = static_cast<int64_t>(__ldg(idx + r)) - base;
  float4* dst = reinterpret_cast<float4*>(out + r * dim);
  if (i < 0 || i >= rows) {  // another shard's lane: zeros, no read
    for (int v = lane; v < vecs; v += 32) dst[v] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const float4* src = reinterpret_cast<const float4*>(local + i * dim);
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

// The host-formed f32 scalars of one Adam step (ttamm_torch/ops/kernels.py
// `adam_scalars`), in this order in device memory: b1, 1 - b1, b2, 1 - b2
// (each formed in double, then cast), the reciprocals of the two bias
// corrections (formed in double), eps, lr, and lr * weight_decay (formed in
// double); `decay` = weight_decay != 0 (by value: it does not change from
// step to step).
struct AdamScalars {
  float b1, one_minus_b1, b2, one_minus_b2, inv_bias1, inv_bias2, eps, lr, lr_wd;
  int decay;
};

__device__ __forceinline__ AdamScalars load_adam_scalars(const float* __restrict__ p, int decay) {
  return AdamScalars{__ldg(p + 0), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3), __ldg(p + 4),
                     __ldg(p + 5), __ldg(p + 6), __ldg(p + 7), __ldg(p + 8), decay};
}

constexpr int kAdamThreads = 256;
constexpr int kAdamWarps = kAdamThreads / 32;

// One element of adam_rows (ttamm_torch/ops/sparse_adam.py), one rounding
// per eager op.
__device__ __forceinline__ void adam_element(float& w, float& m, float& v, float g,
                                             const AdamScalars& s) {
  const float m_new = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.one_minus_b1, g));
  const float v_new =
      __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(s.one_minus_b2, __fmul_rn(g, g)));
  const float m_hat = __fmul_rn(m_new, s.inv_bias1);
  const float v_hat = __fmul_rn(v_new, s.inv_bias2);
  float delta = __fdiv_rn(__fmul_rn(s.lr, m_hat), __fadd_rn(__fsqrt_rn(v_hat), s.eps));
  if (s.decay) delta = __fadd_rn(delta, __fmul_rn(s.lr_wd, w));
  w = __fsub_rn(w, delta);
  m = m_new;
  v = v_new;
}

__device__ __forceinline__ void adam_vec(float4& w, float4& m, float4& v, const float4& g,
                                         const AdamScalars& s) {
  adam_element(w.x, m.x, v.x, g.x, s);
  adam_element(w.y, m.y, v.y, g.y, s);
  adam_element(w.z, m.z, v.z, g.z, s);
  adam_element(w.w, m.w, v.w, g.w, s);
}

__global__ void __launch_bounds__(kAdamThreads)
sparse_adam_rows_kernel(float* __restrict__ w, float* __restrict__ m, float* __restrict__ v,
                        const int32_t* __restrict__ idx, const float* __restrict__ grads,
                        int64_t n, int64_t rows, int dim, const float* __restrict__ scalars,
                        int decay) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kAdamWarps + (threadIdx.x >> 5);
  if (r >= n) return;
  const int32_t i = __ldg(idx + r);
  if (i < 0 || i >= rows) return;  // a masked lane: no read, no write
  const AdamScalars s = load_adam_scalars(scalars, decay);
  const int lane = threadIdx.x & 31;
  const int vecs = dim >> 2;
  const int64_t target = static_cast<int64_t>(i) * vecs;
  float4* w4 = reinterpret_cast<float4*>(w) + target;
  float4* m4 = reinterpret_cast<float4*>(m) + target;
  float4* v4 = reinterpret_cast<float4*>(v) + target;
  const float4* g4 = reinterpret_cast<const float4*>(grads) + r * vecs;
  for (int col = lane; col < vecs; col += 32) {
    float4 wr = __ldcs(w4 + col);
    float4 mr = __ldcs(m4 + col);
    float4 vr = __ldcs(v4 + col);
    const float4 gr = __ldcs(g4 + col);
    adam_vec(wr, mr, vr, gr, s);
    __stcs(w4 + col, wr);
    __stcs(m4 + col, mr);
    __stcs(v4 + col, vr);
  }
}

unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kRowsPerBlock - 1) / kRowsPerBlock);
}

}  // namespace

// table: f32 [rows, dim]; idx: i32 [n]; out: f32 [n, dim]. Contiguous,
// 16-byte aligned, dim % 4 == 0, n > 0.
extern "C" int ttamm_gather_rows(const float* table, const int32_t* idx, float* out,
                                 int64_t n, int64_t rows, int dim, cudaStream_t stream) {
  gather_rows_kernel<<<blocks_for(n), kThreads, 0, stream>>>(table, idx, out, n, rows, dim);
  return static_cast<int>(cudaGetLastError());
}

// local: f32 [rows, dim], this shard's rows of a table whose global row
// base + j is local row j; idx: i32 [n] global row ids; out: f32 [n, dim],
// zeros at the lanes outside [base, base + rows). Layout as the gather.
extern "C" int ttamm_gather_rows_masked(const float* local, const int32_t* idx, float* out,
                                        int64_t n, int64_t rows, int dim, int64_t base,
                                        cudaStream_t stream) {
  gather_rows_masked_kernel<<<blocks_for(n), kThreads, 0, stream>>>(local, idx, out, n, rows,
                                                                     dim, base);
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

// w, m, v: f32 [rows, dim], distinct, updated in place; idx: i32 [n], each
// live row (0 <= idx < rows) at most once; grads: f32 [n, dim]; scalars: the
// step's nine f32 scalars (AdamScalars' order) in device memory.
// Contiguous, 16-byte aligned, dim % 4 == 0, n > 0.
extern "C" int ttamm_sparse_adam_rows(float* w, float* m, float* v, const int32_t* idx,
                                      const float* grads, int64_t n, int64_t rows, int dim,
                                      const float* scalars, int decay, cudaStream_t stream) {
  const auto blocks = static_cast<unsigned int>((n + kAdamWarps - 1) / kAdamWarps);
  sparse_adam_rows_kernel<<<blocks, kAdamThreads, 0, stream>>>(w, m, v, idx, grads, n, rows,
                                                               dim, scalars, decay);
  return static_cast<int>(cudaGetLastError());
}
