// The bound-and-rank exact top-k of one row per block, shared by
// small_k_topk.cu (a dense row, index = column) and select_topk.cu (the
// selected groups of a score slab, index = candidate position).
//
// A kernel reads its row once as monotone int32 keys (topk_keys.cuh), keeps
// each thread's largest key, and calls:
// 1. radix_select over the thread maxima: their k-th largest, L, is a lower
//    bound on the row's k-th largest key T (k distinct elements reach L).
// 2. It compacts the keys >= L into RowScratch::ck / ci (the first kCandCap
//    of them, in any order) and counts them, and those > L, in
//    RowScratch::count. On real rows there are about k of them.
// 3. finish_row writes the top k in (key desc, index asc) order:
//    - at most kCandCap candidates: each one's rank is the number of
//      candidates that rank before it, and the ranks below k are written.
//      That count is the whole tie rule: no rescan per output;
//    - otherwise, if fewer than k keys are > L, then T = L (rows tied at the
//      top: an all-equal row, -inf rows with a few finite keys);
//    - otherwise (a weak bound, or none) T comes from a radix select over
//      the whole row;
//    then every key > T and the lowest-index keys == T until there are k,
//    taken in index order (each warp walks its segment of the row twice,
//    counting, then writing after the warps before it), then sorted: by
//    rank counting (k <= kCandCap), else by a bitonic network run in place
//    in the output row.
// The radix select finds the k-th largest key exactly in four 8-bit digit
// passes, most significant first, each a 256-bin histogram of the keys that
// match the digits found so far. Histogram updates are aggregated per warp
// with __match_any_sync (one shared-memory atomic per distinct digit per
// warp), because scores in [-1, 1] put the top digit of most keys into one
// or two bins.

#pragma once

#include <stdint.h>

#include "topk_keys.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBins = 256;     // one 8-bit digit
constexpr int kCandCap = 512;  // candidates ranked in shared memory

__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }

// Shared-memory scratch of one row.
template <int kWarps>
struct RowScratch {
  int32_t ck[kCandCap];  // candidate keys
  int32_t ci[kCandCap];  // candidate indices
  int hist[kBins];
  int sh[2];
  int count[2];  // keys >= L, keys > L
  int warp_gt[kWarps];
  int warp_eq[kWarps];
};

// The index itself as the output id (small_k_topk).
struct SameIndex {
  static constexpr bool kIdentity = true;
  __device__ int32_t operator()(int32_t i) const { return i; }
};

// The k-th largest key of a population, exactly, by four 8-bit digit
// passes. `visit(f)` calls f(key, valid) for each of the calling thread's
// members, equally often in every lane of a warp; the block needs at least
// k valid members. Sets `rem` to k minus the number of keys above the
// result (so 1 <= rem). With kDigits < 4 passes it returns the least key
// that shares the k-th largest key's first kDigits digits: a lower bound
// on it, and `rem` is not meaningful.
template <int kDigits = 4, class Visit>
__device__ int32_t radix_select(Visit visit, int k, int* hist, int* sh, int& rem) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  uint32_t prefix = 0;
  uint32_t known = 0;  // the digits found so far
  rem = k;
  for (int shift = 24; shift >= 32 - 8 * kDigits; shift -= 8) {
    for (int b = tid; b < kBins; b += blockDim.x) hist[b] = 0;
    __syncthreads();
    visit([&](int32_t key, bool valid) {
      const uint32_t u = static_cast<uint32_t>(key) ^ 0x80000000u;  // monotone unsigned
      const bool take = valid && (u & known) == prefix;
      if (__ballot_sync(kFull, take)) {
        const int digit = take ? static_cast<int>((u >> shift) & 0xFFu) : kBins;
        const unsigned peers = __match_any_sync(kFull, digit);
        if (take && lane == __ffs(peers) - 1) atomicAdd(&hist[digit], __popc(peers));
      }
    });
    __syncthreads();
    if (tid < 32) {
      // lane l scans bins 255 - 8l down to 248 - 8l
      int c[8];
      int sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = hist[kBins - 1 - 8 * lane - j];
        sum += c[j];
      }
      int incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += v;
      }
      int above = incl - sum;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (above < rem && rem <= above + c[j]) {
          sh[0] = kBins - 1 - 8 * lane - j;
          sh[1] = rem - above;
        }
        above += c[j];
      }
    }
    __syncthreads();
    prefix |= static_cast<uint32_t>(sh[0]) << shift;
    rem = sh[1];
    known |= 0xFFu << shift;
  }
  return static_cast<int32_t>(prefix ^ 0x80000000u);
}

// Writes the candidates of rank < k (key desc, index asc) among n to the
// output row, each under out_id(index); every rank below k must be among
// them.
template <class OutId>
__device__ void rank_write(const int32_t* ck, const int32_t* ci, int n, int k,
                           float* vals, int32_t* idx, OutId out_id) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int32_t key = ck[e];
    const int32_t id = ci[e];
    int rank = 0;
    for (int j = 0; j < n; ++j) rank += ranks_before(ck[j], ci[j], key, id);
    if (rank < k) {
      vals[rank] = key_f32(key);
      idx[rank] = out_id(id);
    }
  }
}

// Sorts n (key, id) pairs in place into rank order with a block-wide
// bitonic network, padded virtually to a power of two with pairs that rank
// last (every merge sorts in the same direction, so a compare with a pad
// position is a no-op).
__device__ void bitonic_rank_sort(int32_t* key, int32_t* id, int n) {
  int size = 1;
  while (size < n) size <<= 1;
  auto exchange = [&](int a, int b) {  // a < b
    if (b < n && ranks_before(key[b], id[b], key[a], id[a])) {
      const int32_t tk = key[a], ti = id[a];
      key[a] = key[b];
      id[a] = id[b];
      key[b] = tk;
      id[b] = ti;
    }
  };
  for (int len = 2; len <= size; len <<= 1) {
    const int half = len >> 1;
    for (int t = threadIdx.x; t < size / 2; t += blockDim.x) {
      const int base = (t / half) * len;
      const int j = t % half;
      exchange(base + j, base + len - 1 - j);
    }
    __syncthreads();
    for (int stride = half >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < size / 2; t += blockDim.x) {
        const int a = (t / stride) * 2 * stride + t % stride;
        exchange(a, a + stride);
      }
      __syncthreads();
    }
  }
}

// Step 3: the row's top k from the candidates >= t that step 2 left in `s`
// (after a barrier). `visit_row` is radix_select's visitor over the whole
// row, `key_at(i)` the key at index i < width, `out_id(i)` the id written
// for index i. vr / ir: the row's k output values and ids.
template <int kThreads, class VisitRow, class KeyAt, class OutId>
__device__ void finish_row(RowScratch<kThreads / 32>& s, int32_t t, int width, int k,
                           VisitRow visit_row, KeyAt key_at, OutId out_id,
                           float* vr, int32_t* ir) {
  constexpr int kWarps = kThreads / 32;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_ge = s.count[0];
  const int n_gt = s.count[1];
  if (n_ge <= kCandCap) {
    rank_write(s.ck, s.ci, n_ge, k, vr, ir, out_id);
    return;
  }
  int rem;
  if (n_gt < k) {
    rem = k - n_gt;  // T = L
  } else {
    t = radix_select(visit_row, k, s.hist, s.sh, rem);
  }

  // every key > T and the first rem keys == T, in index order: warp w
  // walks its segment of the row twice, counting, then writing after the
  // counts of the warps before it.
  const int gt_total = k - rem;
  const int seg = ((width + kWarps - 1) / kWarps + 31) / 32 * 32;
  const int s0 = min(width, warp * seg);
  const int s1 = min(width, s0 + seg);
  int ngt = 0, neq = 0;
  for (int base = s0; base < s1; base += 32) {
    const int i = base + lane;
    const int32_t key = i < s1 ? key_at(i) : INT32_MIN;
    ngt += __popc(__ballot_sync(kFull, i < s1 && key > t));
    neq += __popc(__ballot_sync(kFull, i < s1 && key == t));
  }
  if (lane == 0) {
    s.warp_gt[warp] = ngt;
    s.warp_eq[warp] = neq;
  }
  __syncthreads();
  ngt = 0;
  neq = 0;
  for (int w = 0; w < warp; ++w) {
    ngt += s.warp_gt[w];
    neq += s.warp_eq[w];
  }
  // k <= kCandCap: select into shared memory and rank-count; beyond, select
  // into the output row (keys in the value slots, indices in the id slots)
  // and sort there.
  const bool in_smem = k <= kCandCap;
  int32_t* sk = in_smem ? s.ck : reinterpret_cast<int32_t*>(vr);
  int32_t* si = in_smem ? s.ci : ir;
  for (int base = s0; base < s1; base += 32) {
    const int i = base + lane;
    const int32_t key = i < s1 ? key_at(i) : INT32_MIN;
    const bool gt = i < s1 && key > t;
    const bool eq = i < s1 && key == t;
    const unsigned bg = __ballot_sync(kFull, gt);
    const unsigned be = __ballot_sync(kFull, eq);
    if (gt) {
      const int p = ngt + __popc(bg & lanes_below(lane));
      sk[p] = key;
      si[p] = i;
    }
    if (eq) {
      const int p = neq + __popc(be & lanes_below(lane));
      if (p < rem) {
        sk[gt_total + p] = key;
        si[gt_total + p] = i;
      }
    }
    ngt += __popc(bg);
    neq += __popc(be);
  }
  __syncthreads();
  if (in_smem) {
    rank_write(s.ck, s.ci, k, k, vr, ir, out_id);
    return;
  }
  bitonic_rank_sort(sk, si, k);
  for (int e = tid; e < k; e += kThreads) {
    vr[e] = key_f32(sk[e]);
    if constexpr (!OutId::kIdentity) ir[e] = out_id(si[e]);
  }
}

}  // namespace
