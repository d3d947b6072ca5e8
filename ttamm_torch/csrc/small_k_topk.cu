// Exact per-row top-k of float32 rows whose cost does not grow with k.
//
// Replaces the TPU kernel `small_k_topk` (ttamm_tpu/ops/pallas/topk.py,
// kernel body `_topk_kernel`), which runs k rounds of max-extract over a
// VMEM-resident block and masks each extracted lane.
//
// What bounds it on Hopper: one read of the row from device memory (4 B a
// key) and one write of k values and ids; at the search shapes (W = 782 ..
// 15,625, k = 20 .. 24, 1,024 rows) that is 3 .. 64 MB, one to twenty
// microseconds. A k-round extraction (the TPU design, and the first port)
// instead costs k * W compares and 2k block barriers a row.
//
// What the design does about it. One block per row reads the row once (into
// shared memory up to 48K keys; wider rows are re-read through L2) as
// monotone int32 keys (topk_keys.cuh), then:
// 1. A bound: every thread keeps the largest key it read. The k-th largest
//    of those maxima, L, is at most the row's k-th largest key T, because k
//    distinct elements reach L (k <= threads holding keys; otherwise no
//    bound). L comes from a radix select over the thread maxima (below).
// 2. The keys >= L are compacted into shared memory; on real rows there are
//    about k of them (random rows of 15,625: 23-26 at k = 24).
//    - If there are at most 512, each one's rank is the number of them that
//      precede it in (key desc, index asc) order, and the ranks below k are
//      written. This is the whole tie rule: no rescan per output.
//    - Otherwise, if fewer than k keys are > L, then T = L (rows tied at the
//      top: an all-equal row, -inf rows with a few finite keys).
//    - Otherwise (a weak bound or no bound) T comes from a radix select over
//      the whole row.
// 3. Given T: every key > T and the lowest-index keys == T until there are
//    k, taken in index order (each warp walks its segment of the row twice,
//    counting, then writing after the warps before it), then sorted: by rank
//    counting (k <= 512), else by a bitonic network run in place in the
//    output row.
// The radix select finds the k-th largest key exactly in four 8-bit digit
// passes, most significant first, each a 256-bin histogram of the keys that
// match the digits found so far. Histogram updates are aggregated per warp
// with __match_any_sync (one shared-memory atomic per distinct digit per
// warp), because scores in [-1, 1] put the top digit of most keys into one
// or two bins.
//
// The block has 128 threads up to 6,144 keys (the eval's 782 groups and
// 2,560 .. 5,120 candidates), 256 up to 12,288 and 512 beyond (15,625 at 2M
// items). One warp per row, with no block barrier, was measured against an
// earlier cut of this kernel (NVIDIA H100 80GB HBM3, 700 W, 1,024 random
// rows, k = 20): 6.7 us against 7.8 at W = 782, but 14.1 / 16.4 against
// 10.9 / 11.1 us at 2,560 / 3,072, and its bound has only 32 maxima
// (k <= 32). This kernel then read 3.8 / 11.5 / 12.4 us, so the warp form
// was not kept.
//
// Values come back as the input bits, so -inf, finfo(f32).min and -3e38
// survive and -0.0 ranks below +0.0. NaN is not a supported input, as on
// the TPU.

#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_keys.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBins = 256;                // one 8-bit digit
constexpr int kCandCap = 512;             // candidates ranked in shared memory
constexpr int kSmemMaxWidth = 48 * 1024;  // 192 KiB of int32 keys
constexpr int kLoadBatch = 8;             // row loads in flight per thread

__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }

// Reads keys tid, tid + kThreads, ... of a row, kLoadBatch loads in flight
// per thread, and hands each to f(index, key).
template <int kThreads, class F>
__device__ __forceinline__ void read_row(const float* __restrict__ xr, int width, int tid, F f) {
  for (int base = tid; base < width; base += kThreads * kLoadBatch) {
    float v[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int i = base + u * kThreads;
      v[u] = i < width ? __ldg(xr + i) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int i = base + u * kThreads;
      if (i < width) f(i, f32_key(v[u]));
    }
  }
}

// The k-th largest key of a population, exactly, by four 8-bit digit
// passes. `visit(f)` calls f(key, valid) for each of the calling thread's
// members, equally often in every lane of a warp; the block needs at least
// k valid members. Sets `rem` to k minus the number of keys above the
// result (so 1 <= rem).
template <class Visit>
__device__ int32_t radix_select(Visit visit, int k, int* hist, int* sh, int& rem) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  uint32_t prefix = 0;
  uint32_t known = 0;  // the digits found so far
  rem = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
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
// output row; every rank below k must be among them.
__device__ void rank_write(const int32_t* ck, const int32_t* ci, int n, int k,
                           float* vals, int32_t* idx) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int32_t key = ck[e];
    const int32_t id = ci[e];
    int rank = 0;
    for (int j = 0; j < n; ++j) rank += ranks_before(ck[j], ci[j], key, id);
    if (rank < k) {
      vals[rank] = key_f32(key);
      idx[rank] = id;
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

// At least 1,536 threads of blocks per SM (3 of 512 with 48K keys each in
// shared memory): at most 42 registers a thread.
template <int kThreads, bool kSmem>
__global__ void __launch_bounds__(kThreads, 1536 / kThreads)
small_k_topk_kernel(const float* __restrict__ x, float* __restrict__ vals,
                    int32_t* __restrict__ idx, int width, int k) {
  constexpr int kWarps = kThreads / 32;
  extern __shared__ int32_t row_keys[];  // width keys when kSmem
  __shared__ int32_t ck[kCandCap];
  __shared__ int32_t ci[kCandCap];
  __shared__ int hist[kBins];
  __shared__ int sh[2];
  __shared__ int count[2];  // keys >= L, keys > L
  __shared__ int warp_gt[kWarps];
  __shared__ int warp_eq[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t row = blockIdx.x;
  const float* xr = x + row * width;
  float* vr = vals + row * k;
  int32_t* ir = idx + row * k;
  auto key_at = [&](int i) -> int32_t {
    return kSmem ? row_keys[i] : f32_key(__ldg(xr + i));
  };

  int32_t thread_max = INT32_MIN;  // INT32_MIN (a NaN image): no key
  read_row<kThreads>(xr, width, tid, [&](int i, int32_t key) {
    if (kSmem) row_keys[i] = key;
    thread_max = max(thread_max, key);
  });
  if (tid < 2) count[tid] = 0;
  __syncthreads();

  // 1. L = the k-th largest thread maximum, if k threads hold keys
  int32_t t = INT32_MIN;
  int rem = k;
  if (k <= min(width, kThreads)) {
    t = radix_select([&](auto f) { f(thread_max, tid < width); }, k, hist, sh, rem);
  }
  // 2. the keys >= L, and how many are > L
  for (int base = 0; base < width; base += kThreads) {
    const int i = base + tid;
    const int32_t key = i < width ? key_at(i) : INT32_MIN;
    const bool cand = i < width && key >= t;
    const unsigned b = __ballot_sync(kFull, cand);
    const unsigned b_gt = __ballot_sync(kFull, cand && key > t);
    if (b) {
      int first = 0;
      if (lane == __ffs(b) - 1) {
        first = atomicAdd(&count[0], __popc(b));
        if (b_gt) atomicAdd(&count[1], __popc(b_gt));
      }
      first = __shfl_sync(kFull, first, __ffs(b) - 1);
      const int pos = first + __popc(b & lanes_below(lane));
      if (cand && pos < kCandCap) {
        ck[pos] = key;
        ci[pos] = i;
      }
    }
  }
  __syncthreads();
  const int n_ge = count[0];
  const int n_gt = count[1];
  if (n_ge <= kCandCap) {
    rank_write(ck, ci, n_ge, k, vr, ir);
    return;
  }
  if (n_gt < k) {
    rem = k - n_gt;  // T = L
  } else {
    t = radix_select(
        [&](auto f) {
          for (int base = 0; base < width; base += kThreads) {
            const int i = base + tid;
            const bool v = i < width;
            f(v ? key_at(i) : 0, v);
          }
        },
        k, hist, sh, rem);
  }

  // 3. every key > T and the first rem keys == T, in index order: warp w
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
    warp_gt[warp] = ngt;
    warp_eq[warp] = neq;
  }
  __syncthreads();
  ngt = 0;
  neq = 0;
  for (int w = 0; w < warp; ++w) {
    ngt += warp_gt[w];
    neq += warp_eq[w];
  }
  // k <= kCandCap: select into shared memory and rank-count; beyond, select
  // into the output row (keys in the value slots) and sort there.
  const bool in_smem = k <= kCandCap;
  int32_t* sk = in_smem ? ck : reinterpret_cast<int32_t*>(vr);
  int32_t* si = in_smem ? ci : ir;
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
    rank_write(ck, ci, k, k, vr, ir);
    return;
  }
  bitonic_rank_sort(sk, si, k);
  for (int e = tid; e < k; e += kThreads) vr[e] = key_f32(sk[e]);
}

template <int kThreads>
int launch(const float* x, float* vals, int32_t* idx, int batch, int width, int k,
           cudaStream_t stream) {
  if (width <= kSmemMaxWidth) {
    const int smem = width * static_cast<int>(sizeof(int32_t));
    const cudaError_t err = cudaFuncSetAttribute(
        small_k_topk_kernel<kThreads, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    small_k_topk_kernel<kThreads, true><<<batch, kThreads, smem, stream>>>(x, vals, idx, width, k);
  } else {
    small_k_topk_kernel<kThreads, false><<<batch, kThreads, 0, stream>>>(x, vals, idx, width, k);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* ttamm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: f32 [batch, width] contiguous; vals: f32 [batch, k]; idx: i32 [batch, k].
// Requires 0 < k <= width (checked by the Python wrapper).
extern "C" int ttamm_small_k_topk(const float* x, float* vals, int32_t* idx,
                                  int batch, int width, int k,
                                  cudaStream_t stream) {
  if (width <= 6 * 1024) return launch<128>(x, vals, idx, batch, width, k, stream);
  if (width <= 12 * 1024) return launch<256>(x, vals, idx, batch, width, k, stream);
  return launch<512>(x, vals, idx, batch, width, k, stream);
}
