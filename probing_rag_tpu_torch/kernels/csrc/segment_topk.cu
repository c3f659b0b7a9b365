// Run sums of equal doc ids over sorted posting rows, with a top-k.
//
// Replaces probing_rag_tpu/ops/pallas_sparse.py::_segment_kernel (and its
// helper probing_rag_tpu/ops/pallas_dense.py::topk_merge_tile, which is
// topk_merge_tile in common.cuh). Input rows are sorted by doc id; each run
// of one doc id is that doc's postings for the query's terms, and its sum is
// the doc's BM25 score. Runs of the sentinel (padding) are skipped. Output
// per row: the k best (score, doc) pairs ranked by score descending then doc
// id ascending, score 0 and doc -1 where a row has fewer than k docs.
//
// Bound on this card: device-memory bandwidth (8 bytes read per slot, k
// pairs written per row); the per-run work is a handful of adds. Design: one
// thread block per row. A thread that sees a run head (d[i] != d[i-1]) sums
// that run forward sequentially. Runs are at most one posting per query
// term long, so the serial walk is short, and its sum is exact over the
// run's own values in order, never a difference of prefix sums. Each thread
// keeps its own top-k in registers; the block then merges the lists
// pairwise in shared memory. The Pallas kernel's tile carries and
// shift-doubling scans are not needed: the whole row is in reach.

#include "common.cuh"

namespace {

constexpr int kSegThreads = 256;

__global__ void segment_topk_kernel(const int* __restrict__ doc,
                                    const float* __restrict__ imp,
                                    long long p, int k, int sentinel,
                                    float* __restrict__ out_v,
                                    int* __restrict__ out_i) {
  __shared__ float sv[kSegThreads * TOPK_MAX];
  __shared__ int si[kSegThreads * TOPK_MAX];
  const long long row = blockIdx.x;
  const int* d = doc + row * p;
  const float* v = imp + row * p;

  float lv[TOPK_MAX];
  int li[TOPK_MAX];
  for (int j = 0; j < TOPK_MAX; ++j) {
    lv[j] = -INFINITY;
    li[j] = INT_MAX;
  }
  for (long long i = threadIdx.x; i < p; i += blockDim.x) {
    const int di = d[i];
    if (di == sentinel) break;  // sorted: only padding from here on
    if (i > 0 && d[i - 1] == di) continue;
    float s = v[i];
    for (long long j = i + 1; j < p && d[j] == di; ++j) s += v[j];
    topk_merge_tile(lv, li, k, s, di);
  }
  float* mv = sv + threadIdx.x * TOPK_MAX;
  int* mi = si + threadIdx.x * TOPK_MAX;
  for (int j = 0; j < k; ++j) {
    mv[j] = lv[j];
    mi[j] = li[j];
  }
  __syncthreads();

  for (int stride = 1; stride < blockDim.x; stride <<= 1) {
    const int partner = threadIdx.x + stride;
    if (threadIdx.x % (2 * stride) == 0 && partner < blockDim.x) {
      const float* bv = sv + partner * TOPK_MAX;
      const int* bi = si + partner * TOPK_MAX;
      float rv[TOPK_MAX];
      int ri[TOPK_MAX];
      int a = 0, b = 0;
      for (int j = 0; j < k; ++j) {
        const bool take_a =
            b >= k || (a < k && topk_better(mv[a], mi[a], bv[b], bi[b]));
        if (take_a) {
          rv[j] = mv[a];
          ri[j] = mi[a];
          ++a;
        } else {
          rv[j] = bv[b];
          ri[j] = bi[b];
          ++b;
        }
      }
      for (int j = 0; j < k; ++j) {
        mv[j] = rv[j];
        mi[j] = ri[j];
      }
    }
    __syncthreads();
  }
  if (threadIdx.x < k) {
    const bool hit = si[threadIdx.x] != INT_MAX;
    out_v[row * k + threadIdx.x] = hit ? sv[threadIdx.x] : 0.0f;
    out_i[row * k + threadIdx.x] = hit ? si[threadIdx.x] : -1;
  }
}

}  // namespace

// doc/imp are [q, p] device arrays sorted by doc per row; out_v/out_i are
// [q, k] with 1 <= k <= TOPK_MAX.
extern "C" int segment_topk(const void* doc, const void* imp, int q,
                            long long p, int k, int sentinel, void* out_v,
                            void* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  segment_topk_kernel<<<q, kSegThreads, 0, st>>>(
      static_cast<const int*>(doc), static_cast<const float*>(imp), p, k,
      sentinel, static_cast<float*>(out_v), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}
