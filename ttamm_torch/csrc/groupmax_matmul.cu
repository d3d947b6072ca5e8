// Per-128-item-group maxima of Q . I^T without writing the score slab.
//
// Replaces the TPU kernel `groupmax_matmul` (ttamm_tpu/ops/pallas/fused_mips.py,
// kernel body `_groupmax_kernel`): phase 1 of the fused no-slab search. The
// [B, N] score slab (8 MB per query at N = 2M in f32) never reaches device
// memory; only the [B, N/128] maxima are written.
//
// Semantics kept from the TPU kernel: both operands in bf16, products
// summed in f32; rows at or beyond `num_items` score -3e38 before the max, so
// a group holding only pad rows reports -3e38 and a tail group's maximum
// covers its real rows only. Any B and N; D is padded with zeros to whole
// 64-column chunks by the TMA loads. The wrapper hands over bf16 operands
// (float32 ones rounded to nearest even first) with D % 8 == 0 (TMA's 16-byte
// row pitch; narrower D zero-padded in a copy).
//
// What bounds it on Hopper: 2*B*N*D operations on the tensor cores (0.53 ms at
// 1024 x 2M x 128 against the bf16 peak) over one read of the corpus (N*D*2
// bytes, 0.15 ms). The first port ran legacy 16x16x16 WMMA on synchronously
// staged tiles, spilled every 64x128 score tile to shared memory for the max
// and streamed the corpus once per 64-query tile: 9% of the bf16 peak.
//
// What the design does about it:
// - wgmma m64n128k16 (bf16 in, f32 accumulators in registers): one group's
//   128 items are the N of one product, so a thread's group maximum is a
//   reduction over its own accumulator fragment plus two quad shuffles. No
//   score tile goes through shared memory.
// - A query tile of 256 rows (128 when B <= 128 or D > 256) stays resident
//   in shared memory; two consumer warpgroups each own half of it (two or
//   one 64-row accumulators each).
// - One producer warp keeps a ring of 3..8 item chunks (128 items x 64
//   columns, 16 KB, 128-byte swizzle) in flight with TMA and mbarriers.
// - The two consumer warpgroups take turns (two named barriers) to launch
//   a group's products, so one warpgroup's maxima overlap the other's
//   products on the tensor cores (0.77 against 1.04 ms in lockstep at
//   1024 x 2M x 128 on an NVIDIA H100 80GB HBM3, 700 W). The turns need the
//   chunks of two groups in the ring (D <= 192 at a 256-query tile, D <= 256
//   at 128); for wider D the warpgroups run in lockstep and release each
//   chunk as soon as the products after it are in flight.
// - Persistent blocks: blockIdx = (query tile, stripe), a block walks one
//   contiguous stripe of groups, and the blocks of all query tiles of one
//   stripe are adjacent and run at once, so each item chunk is read from
//   device memory about once a call and served to the other query tiles
//   from L2 (the TPU kernel keeps all queries resident and reads it exactly
//   once; 256 KB of queries do not fit one SM's shared memory).
// - Maxima are staged per warpgroup in shared memory and written in runs of
//   16 consecutive groups a query row.

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 128;                       // items per group
constexpr int kChunk = 64;                        // bf16 columns per TMA box (128 B)
constexpr int kChunkBytes = kGroup * kChunk * 2;  // one item box, 16 KB
constexpr int kRun = 16;                          // groups staged per output run
constexpr int kConsumers = 2;                     // consumer warpgroups
constexpr int kThreads = kConsumers * 128 + 32;   // + one producer warp
constexpr int kMaxStages = 8;
constexpr int kMinStages = 3;
// A block's shared memory on Hopper (227 KB).
constexpr int kSmemLimit = 232448;
constexpr float kPadScore = -3.0e38f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Waits until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major bf16 tile with 128-byte rows
// in the 128-byte swizzle (as TMA writes it): 8-row atoms 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] (+)= A[64 x 16] . B[128 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

// Named barriers 3 and 4 order the two consumer warpgroups' products
// (bar.sync by the waiting warpgroup, bar.arrive by the other: 256 threads).
constexpr int kTurnBarrier = 3;
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;" ::"r"(kTurnBarrier + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;" ::"r"(kTurnBarrier + 1 - wg) : "memory");
}

// The group maxima of one 64-row accumulator: d[i] holds row
// wq + 8 * ((i >> 1) & 1) and item column 8 * (i >> 2) + 2 * (lane & 3) +
// (i & 1); a quad of lanes shares its two rows.
template <bool kMasked>
__device__ __forceinline__ void fragment_max(const float (&d)[64], int lane, int64_t valid,
                                             float& m0, float& m1) {
  m0 = -INFINITY;
  m1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    const float v = (kMasked && col >= valid) ? kPadScore : d[i];
    if ((i >> 1) & 1) {
      m1 = fmaxf(m1, v);
    } else {
      m0 = fmaxf(m0, v);
    }
  }
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
}

// kMT: 64-row accumulators per consumer warpgroup (query tile 128 * kMT).
template <int kMT>
__global__ void __launch_bounds__(kThreads, 1)
groupmax_kernel(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap i_map, float* __restrict__ out,
                int batch, int num_groups, int64_t num_items, int chunks, int stages,
                int q_tiles, int stripes, int pingpong) {
  constexpr int kRows = kConsumers * kMT * 64;  // query rows per block
  extern __shared__ unsigned char raw_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw_smem) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* q_smem = base;                              // chunks x [kRows x 64] bf16
  unsigned char* i_smem = q_smem + chunks * kRows * 128;     // stages x [128 x 64] bf16
  float* staged = reinterpret_cast<float*>(i_smem + stages * kChunkBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(staged + kConsumers * kMT * 64 * kRun);
  uint64_t* empty = full + stages;
  uint64_t* q_full = empty + stages;

  const int qtile = blockIdx.x % q_tiles;
  const int stripe = blockIdx.x / q_tiles;
  const int g_begin = static_cast<int>(static_cast<int64_t>(num_groups) * stripe / stripes);
  const int g_end = static_cast<int>(static_cast<int64_t>(num_groups) * (stripe + 1) / stripes);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // lane 0 of every consumer warp
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (g_begin >= g_end) return;

  if (warp == kConsumers * 4) {
    // Producer: the query tile once, then the stripe's item chunks.
    if (lane == 0) {
      mbar_expect_tx(q_full, chunks * kRows * 128);
      for (int c = 0; c < chunks; ++c) {
        tma_load_2d(q_smem + c * kRows * 128, &q_map, q_full, c * kChunk, qtile * kRows);
      }
      int s = 0;
      uint32_t phase = 0;
      for (int g = g_begin; g < g_end; ++g) {
        for (int c = 0; c < chunks; ++c) {
          mbar_wait(&empty[s], phase ^ 1);
          mbar_expect_tx(&full[s], kChunkBytes);
          tma_load_2d(i_smem + s * kChunkBytes, &i_map, &full[s], c * kChunk, g * kGroup);
          if (++s == stages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns query rows [wg * kMT * 64, (wg + 1) * kMT * 64).
  const int wg = warp >> 2;
  const int t = threadIdx.x & 127;
  const int wq = (t >> 5) * 16 + (lane >> 2);  // fragment row of d[i], (i >> 1) & 1 == 0
  float* my_staged = staged + wg * kMT * 64 * kRun;
  float acc[kMT][64];

  mbar_wait(q_full, 0);
  int s = 0;
  uint32_t phase = 0;
  int run0 = g_begin;
  for (int g = g_begin; g < g_end; ++g) {
    // The chunks' products go out back to back. With pingpong the two
    // warpgroups take turns to launch a group's products, so one's maxima
    // overlap the other's products, and a group's chunks are released when
    // its sums are complete; otherwise a chunk is released once the
    // products after it are in flight (wait_group 1).
    if (pingpong && (wg == 1 || g > g_begin)) turn_wait(wg);
    const int s_first = s;
    int prev = -1;
    for (int c = 0; c < chunks; ++c) {
      mbar_wait(&full[s], phase);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) fence_acc(acc[mt]);
      wgmma_fence();
      const uint64_t b_desc = sw128_desc(i_smem + s * kChunkBytes);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const uint64_t a_desc =
            sw128_desc(q_smem + c * kRows * 128 + (wg * kMT + mt) * 64 * 128);
#pragma unroll
        for (int kk = 0; kk < kChunk / 16; ++kk) {
          // +32 bytes along K per 16 columns (descriptor addresses are in 16 B)
          wgmma_m64n128k16(acc[mt], a_desc + 2 * kk, b_desc + 2 * kk, (c | kk) != 0);
        }
      }
      wgmma_commit();
      if (!pingpong && prev >= 0) {
        wgmma_wait_one();
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      prev = s;
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
    }
    if (pingpong) turn_pass(wg);
    wgmma_wait_all();
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) fence_acc(acc[mt]);
    if (lane == 0) {
      if (pingpong) {
        for (int c = 0, r = s_first; c < chunks; ++c, r = (r + 1 == stages ? 0 : r + 1)) {
          mbar_arrive(&empty[r]);
        }
      } else {
        mbar_arrive(&empty[prev]);
      }
    }

    const int64_t valid = num_items - static_cast<int64_t>(g) * kGroup;
    const int j = g - run0;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      float m0, m1;
      if (valid >= kGroup) {
        fragment_max<false>(acc[mt], lane, valid, m0, m1);
      } else {
        fragment_max<true>(acc[mt], lane, valid, m0, m1);
      }
      if ((lane & 3) == 0) {
        my_staged[(mt * 64 + wq) * kRun + j] = m0;
        my_staged[(mt * 64 + wq + 8) * kRun + j] = m1;
      }
    }
    if (j == kRun - 1 || g == g_end - 1) {
      warpgroup_sync(1 + wg);
      const int len = j + 1;
      const int q0 = qtile * kRows + wg * kMT * 64;
      for (int e = t; e < kMT * 64 * len; e += 128) {
        const int r = e / len;
        const int jj = e - r * len;
        if (q0 + r < batch) {
          out[static_cast<int64_t>(q0 + r) * num_groups + run0 + jj] = my_staged[r * kRun + jj];
        }
      }
      warpgroup_sync(1 + wg);
      run0 = g + 1;
    }
  }
  if (pingpong && wg == 0) turn_wait(0);  // the other's last turn_pass
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda.so.1, which PyTorch has already
// loaded (no link against it).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A [rows, dim] bf16 row-major matrix read in boxes of box_rows x 64
// columns, 128-byte swizzled; out-of-range rows and columns read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int64_t rows, int dim, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(dim), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(dim) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kChunk), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kMT>
int launch(const void* q, const void* items, float* out, int batch, int64_t n_rows,
           int64_t num_items, int dim, int chunks, cudaStream_t stream) {
  constexpr int kRows = kConsumers * kMT * 64;
  // 1 KB to align the tiles, the query tile, the staged maxima, then as many
  // 16 KB item chunks (each with two 8-byte barriers) as fit, at most 8.
  const int fixed = 1024 + chunks * kRows * 128 + kConsumers * kMT * 64 * kRun * 4 + 8;
  const int stages = (kSmemLimit - fixed) / (kChunkBytes + 16) < kMaxStages
                         ? (kSmemLimit - fixed) / (kChunkBytes + 16)
                         : kMaxStages;
  if (stages < kMinStages) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = fixed + stages * (kChunkBytes + 16);

  CUtensorMap q_map, i_map;
  if (!make_map(&q_map, q, batch, dim, kRows) || !make_map(&i_map, items, n_rows, dim, kGroup)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(groupmax_kernel<kMT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int num_groups = static_cast<int>((n_rows + kGroup - 1) / kGroup);
  const int q_tiles = (batch + kRows - 1) / kRows;
  int stripes = sms / q_tiles;
  if (stripes < 1) stripes = 1;
  if (stripes > num_groups) stripes = num_groups;
  groupmax_kernel<kMT><<<q_tiles * stripes, kThreads, smem, stream>>>(
      q_map, i_map, out, batch, num_groups, num_items, chunks, stages, q_tiles, stripes,
      static_cast<int>(2 * chunks <= stages));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: bf16 [batch, dim], items: bf16 [n_rows, dim], contiguous, 16-byte
// aligned, dim % 8 == 0 (TMA row pitch), dim <= 640 (shared memory), n_rows
// < 2^31 (TMA coordinates); all checked by the Python wrapper.
// out: f32 [batch, ceil(n_rows / 128)].
extern "C" int ttamm_groupmax_matmul(const void* q, const void* items, float* out, int batch,
                                     int64_t n_rows, int64_t num_items, int dim,
                                     cudaStream_t stream) {
  const int chunks = (dim + kChunk - 1) / kChunk;
  if (batch > 128 && chunks <= 4) {
    return launch<2>(q, items, out, batch, n_rows, num_items, dim, chunks, stream);
  }
  return launch<1>(q, items, out, batch, n_rows, num_items, dim, chunks, stream);
}
