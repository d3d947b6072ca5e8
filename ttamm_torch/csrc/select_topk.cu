// Candidate selection and final top-k of the group-pruned exact search.
//
// Replaces the TPU kernel `select_topk_from_groups`
// (ttamm_tpu/ops/pallas/topk.py, kernel body `_select_topk_kernel`): given
// the float32 score slab [B, NG*128] (item n at column n) and each row's KG
// selected group ids, return the top k of the KG*128 candidates, ordered by
// value descending, ties to the lower candidate position (group rank j, then
// lane: position j * 128 + lane), pad lanes (global id >= num_items) and
// every lane of a group id outside [0, NG) scoring finfo(f32).min. The
// result is bit-identical to gathering the KG group rows and taking a
// stable descending top-k, which is the kernel's plain version.
//
// The TPU kernel gathers the groups with a one-hot bf16x3 MXU product (a TPU
// workaround for the lack of a fast dynamic gather); here every group row is
// read directly, which is exact by construction.
//
// What bounds it on Hopper: device-memory bandwidth for the reads (B * KG *
// 512 bytes of the slab, one contiguous 512-byte row per selected group):
// 8.8 us at the val eval's 2,685 rows of KG = 21. Little else is needed: on
// real rows about k of the KG * 128 candidates can be in the top k. A
// k-round extraction (the first port: a register scan, a shuffle argmax and
// two block barriers per output) instead pays 2k barriers a row and ran at
// 7% of the bound.
//
// What the design does about it: one block of 128 threads per row, the
// bound-and-rank steps of bound_rank.cuh (shared with small_k_topk) with
// the candidate position as the index.
// - Read: warp w takes the selected groups w, w + 4, ...; lane l reads the
//   l-th 16-byte piece of each group's 512-byte row (coalesced), after one
//   warp-uniform load of the group id. The keys stay in registers (at most
//   4 * ceil(KG / 4) a thread), each thread keeping its maximum; nothing of
//   the row is staged in shared memory.
// - The bound L is the least key that shares the first 16 bits of the k-th
//   largest of the 128 thread maxima: two radix passes instead of four (six
//   block barriers fewer), for a few more candidates. The keys >= L (about
//   23 at the eval's k = 21, tied rows included) are counted per thread,
//   placed by a warp scan and one shared-memory atomic per warp, and ranked
//   by counting.
// - The fallbacks (rows tied at the top, a weak bound, k beyond the bound's
//   128 maxima) re-read keys from the slab through L2 by position.
// Measured with scripts/select_topk_variants.py (NVIDIA H100 80GB HBM3,
// 700 W; ms at the val eval block [2685, 99968] / float32 serving [1024,
// 99968] / a 2M-item block [134, 2M]): this kernel 0.0183 / 0.0080 /
// 0.0052; 256 threads 0.0234 / 0.0101 / 0.0046 (a 134-row launch has one
// row an SM, so only there do more threads a row pay); the exact 4-digit
// bound 0.0231 / 0.0099 / 0.0065, 3 digits 0.0208 / 0.0090 / 0.0059; 12
// blocks an SM (40 registers, spills) 0.0191 / 0.0089 / 0.0056. With 56
// registers at KG <= 24, 9 blocks (rows) share an SM, and the 2,685 rows of
// an eval block take ~2.3 such waves: the barrier chain of a row, not the
// bytes, sets the time (2.1x the byte bound).
//
// Values come back as the input bits. NaN is not a supported input, as on
// the TPU.

#include <cfloat>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bound_rank.cuh"

namespace {

constexpr int kGroup = 128;
constexpr int kVecPerGroup = kGroup / 4;  // float4 pieces per group row
constexpr int kMaxGroups = 32;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// Digits of the bound's radix select over the thread maxima (of 4 for the
// exact k-th maximum). Two give the least key sharing its first 16 bits: a
// lower bound that admits a few more candidates, for half the passes.
constexpr int kBoundDigits = 2;

// The id of candidate position p: group rank p / 128, lane p % 128. Group
// ids outside [0, NG) wrap like the plain version's int64 -> int32 cast.
struct PositionToItem {
  static constexpr bool kIdentity = false;
  const int32_t* row_gids;
  __device__ int32_t operator()(int32_t p) const {
    return static_cast<int32_t>(static_cast<uint32_t>(row_gids[p / kGroup]) * kGroup +
                                static_cast<uint32_t>(p % kGroup));
  }
};

// kSlots: the groups a warp reads, at least ceil(KG / kWarps).
template <int kSlots>
__global__ void __launch_bounds__(kThreads, 8)
select_topk_kernel(const float* __restrict__ scores, const int32_t* __restrict__ gids,
                   float* __restrict__ vals, int32_t* __restrict__ ids, int64_t width,
                   int num_groups, int kg, int k, int64_t num_items) {
  __shared__ RowScratch<kWarps> s;
  __shared__ int32_t row_gids[kMaxGroups];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t row = blockIdx.x;
  const int32_t* rg = gids + row * kg;
  const float* srow = scores + row * width;
  const int32_t pad_key = f32_key(-FLT_MAX);
  if (tid < kg) row_gids[tid] = rg[tid];
  if (tid < 2) s.count[tid] = 0;

  // Read: slot i of warp w is group rank j = w + 4 i (warp-uniform).
  int32_t g[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int j = warp + i * kWarps;
    g[i] = j < kg ? __ldg(rg + j) : -1;
  }
  float4 x[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const bool ok = g[i] >= 0 && g[i] < num_groups;
    x[i] = ok ? __ldg(reinterpret_cast<const float4*>(srow) +
                      static_cast<int64_t>(g[i]) * kVecPerGroup + lane)
              : make_float4(-FLT_MAX, -FLT_MAX, -FLT_MAX, -FLT_MAX);
  }
  int32_t key[kSlots][4];
  int32_t thread_max = INT32_MIN;  // INT32_MIN (a NaN image): no key
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const bool live = warp + i * kWarps < kg;
    const bool ok = g[i] >= 0 && g[i] < num_groups;
    const int64_t item0 = static_cast<int64_t>(g[i]) * kGroup + 4 * lane;
    const float xs[4] = {x[i].x, x[i].y, x[i].z, x[i].w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      key[i][c] = !live ? INT32_MIN
                        : (ok && item0 + c < num_items ? f32_key(xs[c]) : pad_key);
      thread_max = max(thread_max, key[i][c]);
    }
  }
  __syncthreads();

  // 1. L = the k-th largest thread maximum, if k threads hold keys (the
  // warps w < KG)
  int32_t t = INT32_MIN;
  int rem;
  if (k <= min(kg, kWarps) * 32) {
    t = radix_select<kBoundDigits>([&](auto f) { f(thread_max, warp < kg); }, k, s.hist, s.sh,
                                   rem);
  }
  // 2. the keys >= L, and how many are > L: counted per thread, placed
  // after the thread's predecessors in the warp and the warp's block slot
  int n_ge = 0, n_gt = 0;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const bool live = warp + i * kWarps < kg;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      n_ge += live && key[i][c] >= t;
      n_gt += live && key[i][c] > t;
    }
  }
  int incl = n_ge;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += v;
  }
  const int warp_gt = __reduce_add_sync(kFull, n_gt);
  int first = 0;
  if (lane == 31) {
    if (incl) first = atomicAdd(&s.count[0], incl);
    if (warp_gt) atomicAdd(&s.count[1], warp_gt);
  }
  int pos = __shfl_sync(kFull, first, 31) + incl - n_ge;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const bool live = warp + i * kWarps < kg;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (live && key[i][c] >= t) {
        if (pos < kCandCap) {
          s.ck[pos] = key[i][c];
          s.ci[pos] = (warp + i * kWarps) * kGroup + 4 * lane + c;
        }
        ++pos;
      }
    }
  }
  __syncthreads();

  // 3. rank the candidates, or select in position order and sort
  auto key_at = [&](int p) -> int32_t {
    const int32_t gp = row_gids[p / kGroup];
    const int64_t item = static_cast<int64_t>(gp) * kGroup + p % kGroup;
    const bool ok = gp >= 0 && gp < num_groups;
    return ok && item < num_items ? f32_key(__ldg(srow + item)) : pad_key;
  };
  finish_row<kThreads>(
      s, t, kg * kGroup, k,
      [&](auto f) {
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
          const bool live = warp + i * kWarps < kg;
#pragma unroll
          for (int c = 0; c < 4; ++c) f(key[i][c], live);
        }
      },
      key_at, PositionToItem{row_gids}, vals + row * k, ids + row * k);
}

template <int kSlots>
int launch(const float* scores, const int32_t* gids, float* vals, int32_t* ids, int batch,
           int64_t width, int kg, int k, int64_t num_items, cudaStream_t stream) {
  select_topk_kernel<kSlots><<<batch, kThreads, 0, stream>>>(
      scores, gids, vals, ids, width, static_cast<int>(width / kGroup), kg, k, num_items);
  return static_cast<int>(cudaGetLastError());
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
  const int slots = (kg + kWarps - 1) / kWarps;  // 1 .. 8
  if (slots <= 2) return launch<2>(scores, gids, vals, ids, batch, width, kg, k, num_items, stream);
  if (slots <= 4) return launch<4>(scores, gids, vals, ids, batch, width, kg, k, num_items, stream);
  if (slots <= 6) return launch<6>(scores, gids, vals, ids, batch, width, kg, k, num_items, stream);
  return launch<8>(scores, gids, vals, ids, batch, width, kg, k, num_items, stream);
}
