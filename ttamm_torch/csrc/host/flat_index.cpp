// Native exact MIPS top-k over a flat embedding matrix.
//
// The reference consumed this capability through FAISS's C++ IndexFlatIP
// (reference src/pipelines/training.py:646-697). This is the framework's
// own native searcher, used by the host-side serving path
// (ttamm_tpu/serve/) when no TPU is attached.
//
// Layout: queries are processed in tiles of kQueryTile; each item block is
// read ONCE per tile instead of once per query, so the corpus sweep — the
// memory-bandwidth bottleneck of a flat exact search — is amortized over
// the tile (a [B, D] x [D, N] GEMM blocking, not a per-query scan). The
// micro-kernel keeps the tile's scores in per-query accumulators and
// vectorizes ACROSS the query tile (row element broadcast x query column),
// which avoids per-dot horizontal reductions entirely. Threads pull whole
// query tiles from an atomic counter; per-query bounded min-heaps produce
// the top-k.
//
// Build: `make -C native` -> libttamm_native.so (loaded via ctypes from
// ttamm_tpu/serve/native_bridge.py; pybind11 is intentionally not used —
// the ABI is a single C function).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__AVX512F__)
#include <immintrin.h>
#endif

namespace {

// Queries per tile — the corpus-traffic amortization factor.
// AVX-512 build: 64 queries = 4 zmm columns; with 4 item rows blocked the
// 16 zmm accumulators fill the register file and the corpus is read once
// per 64 queries. Measured on the 2-core AVX-512 dev host at N=100k,
// D=128, B=1024, k=20: scalar 2.8k -> zmm-kernel tile 32 6.0k -> tile 64
// 6.8k q/s (tile 128 is slower AND would overflow the 64-bit selection
// mask — static_assert below). Non-AVX-512 fallback: tile 32 + depth-4
// unroll, the measured best for autovectorized scalar accumulators.
#if defined(__AVX512F__)
constexpr int32_t kQueryTile = 64;  // 4 zmm columns; see kernel below
static_assert(kQueryTile <= 64, "selection mask is uint64_t (one bit/lane)");
#else
constexpr int32_t kQueryTile = 32;
#endif
// Items per pass: bounds the [kBlock, kQueryTile] score buffer (64 KB).
constexpr int64_t kBlock = 1024;

struct HeapEntry {
  float score;
  int64_t index;
};

// Min-heap on score: top() is the weakest of the current top-k.
inline bool heap_less(const HeapEntry& a, const HeapEntry& b) {
  return a.score > b.score;
}

void search_query_tiles(const float* items, int64_t n, int32_t d,
                        const float* queries, int32_t k, float* out_scores,
                        int64_t* out_indices,
                        std::atomic<int64_t>* next_tile,
                        int64_t num_queries) {
  const int64_t num_tiles = (num_queries + kQueryTile - 1) / kQueryTile;
  // Query tile transposed to [d][kQueryTile] so the micro-kernel's inner
  // loop is contiguous over the tile; unused lanes are zero-padded.
  std::vector<float> qT(static_cast<size_t>(d) * kQueryTile);
  std::vector<float> scores_tile(static_cast<size_t>(kBlock) * kQueryTile);
  std::vector<HeapEntry> heaps(static_cast<size_t>(kQueryTile) *
                               (static_cast<size_t>(k) + 1));
  std::vector<int32_t> heap_sizes(kQueryTile);

  for (;;) {
    const int64_t tile = next_tile->fetch_add(1);
    if (tile >= num_tiles) break;
    const int64_t q0 = tile * kQueryTile;
    const int32_t qcount = static_cast<int32_t>(
        std::min<int64_t>(kQueryTile, num_queries - q0));

    std::fill(qT.begin(), qT.end(), 0.f);
    for (int32_t t = 0; t < qcount; ++t) {
      const float* query = queries + (q0 + t) * d;
      for (int32_t j = 0; j < d; ++j) qT[j * kQueryTile + t] = query[j];
    }
    std::fill(heap_sizes.begin(), heap_sizes.end(), 0);

    for (int64_t start = 0; start < n; start += kBlock) {
      const int64_t end = std::min(start + kBlock, n);
      const int64_t count = end - start;

      // Micro-kernel: each item row is read once and scored against the
      // whole tile. acc[] vectorizes across the tile (no horizontal
      // reduction); the row element is a broadcast. Two independent
      // accumulator sets over a depth-4 unroll break the FMA latency
      // chain without spilling the register file at this tile width.
      if (qcount > 4) {
#if defined(__AVX512F__)
        // Register blocking: kRows item rows x kCols zmm query columns
        // (kRows*kCols accumulators <= 16 zmm). Per depth element the
        // query columns load once and each row adds one broadcast +
        // kCols FMAs, so the loop runs at FMA throughput; the wider
        // 64-query tile also halves corpus traffic per query vs 32.
        constexpr int32_t kCols = kQueryTile / 16;
        constexpr int32_t kRows = 16 / kCols;
        const int64_t countR = count & ~int64_t(kRows - 1);
        for (int64_t i = 0; i < countR; i += kRows) {
          const float* r = items + (start + i) * d;
          __m512 acc[kRows][kCols];
          for (int32_t a = 0; a < kRows; ++a)
            for (int32_t c = 0; c < kCols; ++c)
              acc[a][c] = _mm512_setzero_ps();
          for (int32_t j = 0; j < d; ++j) {
            const float* qc =
                qT.data() + static_cast<size_t>(j) * kQueryTile;
            __m512 q[kCols];
            for (int32_t c = 0; c < kCols; ++c)
              q[c] = _mm512_loadu_ps(qc + 16 * c);
            for (int32_t a = 0; a < kRows; ++a) {
              const __m512 rb = _mm512_set1_ps(r[a * d + j]);
              for (int32_t c = 0; c < kCols; ++c)
                acc[a][c] = _mm512_fmadd_ps(rb, q[c], acc[a][c]);
            }
          }
          float* out =
              scores_tile.data() + static_cast<size_t>(i) * kQueryTile;
          for (int32_t a = 0; a < kRows; ++a)
            for (int32_t c = 0; c < kCols; ++c)
              _mm512_storeu_ps(out + a * kQueryTile + 16 * c, acc[a][c]);
        }
        // Remainder rows: one row at a time, kCols accumulators.
        for (int64_t i = countR; i < count; ++i) {
          const float* row = items + (start + i) * d;
          __m512 acc1r[kCols];
          for (int32_t c = 0; c < kCols; ++c) acc1r[c] = _mm512_setzero_ps();
          for (int32_t j = 0; j < d; ++j) {
            const float* qc =
                qT.data() + static_cast<size_t>(j) * kQueryTile;
            const __m512 rb = _mm512_set1_ps(row[j]);
            for (int32_t c = 0; c < kCols; ++c)
              acc1r[c] = _mm512_fmadd_ps(
                  rb, _mm512_loadu_ps(qc + 16 * c), acc1r[c]);
          }
          float* out =
              scores_tile.data() + static_cast<size_t>(i) * kQueryTile;
          for (int32_t c = 0; c < kCols; ++c)
            _mm512_storeu_ps(out + 16 * c, acc1r[c]);
        }
#else
        const int32_t d4 = d & ~3;
        for (int64_t i = 0; i < count; ++i) {
          const float* row = items + (start + i) * d;
          float acc0[kQueryTile] = {0.f};
          float acc1[kQueryTile] = {0.f};
          for (int32_t j = 0; j < d4; j += 4) {
            const float r0 = row[j], r1 = row[j + 1];
            const float r2 = row[j + 2], r3 = row[j + 3];
            const float* qc =
                qT.data() + static_cast<size_t>(j) * kQueryTile;
            for (int32_t t = 0; t < kQueryTile; ++t) {
              acc0[t] += r0 * qc[t] + r1 * qc[kQueryTile + t];
              acc1[t] += r2 * qc[2 * kQueryTile + t] +
                         r3 * qc[3 * kQueryTile + t];
            }
          }
          for (int32_t j = d4; j < d; ++j) {
            const float r = row[j];
            const float* qc =
                qT.data() + static_cast<size_t>(j) * kQueryTile;
            for (int32_t t = 0; t < kQueryTile; ++t) acc0[t] += r * qc[t];
          }
          float* out =
              scores_tile.data() + static_cast<size_t>(i) * kQueryTile;
          for (int32_t t = 0; t < kQueryTile; ++t)
            out[t] = acc0[t] + acc1[t];
        }
#endif
      } else {
        // Narrow tile (tail or tiny batch): per-query dot products avoid
        // the wide kernel's wasted zero lanes.
        for (int64_t i = 0; i < count; ++i) {
          const float* row = items + (start + i) * d;
          float* out =
              scores_tile.data() + static_cast<size_t>(i) * kQueryTile;
          for (int32_t t = 0; t < qcount; ++t) {
            const float* query = queries + (q0 + t) * d;
            float acc = 0.f;
            for (int32_t j = 0; j < d; ++j) acc += query[j] * row[j];
            out[t] = acc;
          }
        }
      }

#if defined(__AVX512F__)
      // Selection: one masked compare of each item's 32 contiguous scores
      // against the per-query weakest-of-top-k thresholds replaces 32
      // scalar compares; after warmup almost every item fails for every
      // query (k/N odds), so the heap work collapses to the rare passing
      // lanes. Thresholds reload only when a heap actually changes.
      {
        constexpr int32_t kCols = kQueryTile / 16;
        alignas(64) float thr[kQueryTile];
        for (int32_t t = 0; t < kQueryTile; ++t) {
          thr[t] = (t < qcount && heap_sizes[t] >= k)
                       ? heaps[static_cast<size_t>(t) * (k + 1)].score
                       : -3.4e38f;
          if (t >= qcount) thr[t] = 3.4e38f;  // pad lanes never pass
        }
        __m512 th[kCols];
        for (int32_t c = 0; c < kCols; ++c)
          th[c] = _mm512_load_ps(thr + 16 * c);
        for (int64_t i = 0; i < count; ++i) {
          const float* s =
              scores_tile.data() + static_cast<size_t>(i) * kQueryTile;
          uint64_t mask = 0;
          for (int32_t c = 0; c < kCols; ++c)
            mask |= static_cast<uint64_t>(_mm512_cmp_ps_mask(
                        _mm512_loadu_ps(s + 16 * c), th[c], _CMP_GT_OQ))
                    << (16 * c);
          if (mask == 0) continue;
          do {
            const int32_t t = __builtin_ctzll(mask);
            mask &= mask - 1;
            HeapEntry* heap =
                heaps.data() + static_cast<size_t>(t) * (k + 1);
            int32_t& size = heap_sizes[t];
            if (size < k) {
              heap[size++] = {s[t], start + i};
              std::push_heap(heap, heap + size, heap_less);
              if (size == k) {
                thr[t] = heap[0].score;
                th[t / 16] = _mm512_load_ps(thr + 16 * (t / 16));
              }
            } else {
              std::pop_heap(heap, heap + size, heap_less);
              heap[size - 1] = {s[t], start + i};
              std::push_heap(heap, heap + size, heap_less);
              thr[t] = heap[0].score;
              th[t / 16] = _mm512_load_ps(thr + 16 * (t / 16));
            }
          } while (mask != 0);
        }
      }
#else
      for (int32_t t = 0; t < qcount; ++t) {
        HeapEntry* heap = heaps.data() + static_cast<size_t>(t) * (k + 1);
        int32_t& size = heap_sizes[t];
        for (int64_t i = 0; i < count; ++i) {
          const float score =
              scores_tile[static_cast<size_t>(i) * kQueryTile + t];
          if (size < k) {
            heap[size++] = {score, start + i};
            std::push_heap(heap, heap + size, heap_less);
          } else if (score > heap[0].score) {
            std::pop_heap(heap, heap + size, heap_less);
            heap[size - 1] = {score, start + i};
            std::push_heap(heap, heap + size, heap_less);
          }
        }
      }
#endif
    }

    // Emit in descending score order (sort_heap with a ">"-comparator
    // yields descending scores directly).
    for (int32_t t = 0; t < qcount; ++t) {
      HeapEntry* heap = heaps.data() + static_cast<size_t>(t) * (k + 1);
      const int32_t found = heap_sizes[t];
      std::sort_heap(heap, heap + found, heap_less);
      const int64_t q = q0 + t;
      for (int32_t i = 0; i < found; ++i) {
        out_scores[q * k + i] = heap[i].score;
        out_indices[q * k + i] = heap[i].index;
      }
      for (int32_t i = found; i < k; ++i) {
        out_scores[q * k + i] = -3.4e38f;
        out_indices[q * k + i] = -1;
      }
    }
  }
}

}  // namespace

extern "C" {

// Exact inner-product top-k. Returns 0 on success.
//   items:   [n, d] row-major float32
//   queries: [b, d] row-major float32
//   out_scores / out_indices: [b, k] preallocated
//   num_threads: 0 = hardware concurrency
int ttamm_flat_topk(const float* items, int64_t n, int32_t d,
                    const float* queries, int64_t b, int32_t k,
                    float* out_scores, int64_t* out_indices,
                    int32_t num_threads) {
  if (items == nullptr || queries == nullptr || out_scores == nullptr ||
      out_indices == nullptr)
    return 1;
  if (n <= 0 || d <= 0 || b <= 0 || k <= 0) return 2;
  if (k > n) return 3;

  int32_t threads = num_threads > 0
                        ? num_threads
                        : static_cast<int32_t>(std::thread::hardware_concurrency());
  if (threads <= 0) threads = 1;
  const int64_t num_tiles = (b + kQueryTile - 1) / kQueryTile;
  threads = static_cast<int32_t>(std::min<int64_t>(threads, num_tiles));

  std::atomic<int64_t> next_tile{0};
  if (threads == 1) {
    search_query_tiles(items, n, d, queries, k, out_scores, out_indices,
                       &next_tile, b);
    return 0;
  }
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int32_t t = 0; t < threads; ++t) {
    pool.emplace_back(search_query_tiles, items, n, d, queries, k,
                      out_scores, out_indices, &next_tile, b);
  }
  for (auto& th : pool) th.join();
  return 0;
}

}  // extern "C"
