// Run sums of equal doc ids over sorted posting rows, with a top-k.
//
// Replaces probing_rag_tpu/ops/pallas_sparse.py::_segment_kernel (and its
// helper probing_rag_tpu/ops/pallas_dense.py::topk_merge_tile). Input rows
// are sorted by doc id; each run of one doc id is that doc's postings for
// the query's terms, and its sum is the doc's BM25 score. Runs of the
// sentinel (padding, which sorts last) are skipped. Output per row: the k
// best (score, doc) pairs ranked by score descending then doc id
// ascending, score 0 and doc -1 where a row has fewer than k docs.
//
// Bound on this card: device-memory bandwidth, 8 bytes read a slot up to
// the row's first sentinel (0.075 ms for [1918, 16384]; about 0.04 ms for
// the over-cap hybrid's [8, 2M], half of it padding), k pairs written a
// row; the per-run work is a handful of adds. The TPU kernel walks each
// row in order and carries its run and its top-k across grid steps; here
// nothing carries between blocks, so a row is split over many.
//
// Design: one round trip, two launches.
//  * segment_chunk_kernel, grid (chunks, rows): each block takes `chunk`
//    slots of one row (the wrapper picks chunk so that a row has at most
//    1024 chunks) and stages them kSegStage at a time in shared memory with
//    16-byte cp.async copies. A block whose first slot holds the sentinel
//    writes an empty list and exits. A run belongs to the block that holds
//    its head (d[i] != d[i-1], or i == 0): a thread that meets a head sums
//    the run forward in order, on past the staged window and the chunk's
//    end if it goes on there (runs are at most one posting per query term
//    long); a run that began before the chunk is skipped. The sums are the
//    run's own values added in order, bit-equal to a serial walk. A warp
//    takes 32 slots at a time and keeps one running top-k spread over its
//    lanes (lane r holds the r-th entry): a ballot picks the lanes whose
//    run beats the k-th best, and each goes in by a ballot for its rank and
//    a shuffle of the entries below it. No per-thread list, no local
//    memory. Warp 0 then takes in the other warps' entries from shared
//    memory the same way and writes the block's list to the partial buffer
//    [chunks, rows, k].
//  * merge_partial_topk_kernel (topk_merge.cuh), one warp a row: the k-way
//    merge of the row's partial lists, as the dense searches do, with the
//    empty slots filled as (0, -1).
// Blocks at [1918, 16384] with the wrapper's 8192-slot chunks: 3,836 (was
// 1,918); [8, 2M]: 2,048 (was 8), of which the padding half exit at their
// first slot. Round trips through device memory: one read of each row up
// to its first sentinel (the one-block-per-row kernel read the same bytes,
// but with 8 blocks on 132 SMs at [8, 2M]), plus the partial lists.

#include "common.cuh"
#include "topk_merge.cuh"

namespace {

constexpr int kSegThreads = 256;
constexpr int kSegWarps = kSegThreads / 32;
constexpr int kSegStage = 4096;  // slots staged at a time (32 KB)

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The warp's running top-k, one entry a lane: lane r < k holds the r-th
// best (score, doc) so far, (-inf, INT_MAX) while empty; every lane also
// holds the k-th best, the bar a candidate must beat.
struct WarpTop {
  float v = -INFINITY;
  int i = INT_MAX;
  float kth_v = -INFINITY;
  int kth_i = INT_MAX;

  // (s, id), the same in every lane, goes in at its rank if it beats the
  // k-th best: the lanes past it shift down one.
  __device__ __forceinline__ void insert(float s, int id, int k) {
    if (!topk_better(s, id, kth_v, kth_i)) return;  // the same in every lane
    const int lane = threadIdx.x & 31;
    const int pos = __popc(__ballot_sync(0xffffffffu, lane < k && topk_better(v, i, s, id)));
    const float uv = __shfl_up_sync(0xffffffffu, v, 1);
    const int ui = __shfl_up_sync(0xffffffffu, i, 1);
    if (lane == pos) {
      v = s;
      i = id;
    } else if (lane > pos) {
      v = uv;
      i = ui;
    }
    kth_v = __shfl_sync(0xffffffffu, v, k - 1);
    kth_i = __shfl_sync(0xffffffffu, i, k - 1);
  }

  // Each lane's candidate (s, id) where `want`, in lane order.
  __device__ __forceinline__ void offer(bool want, float s, int id, int k) {
    unsigned m = __ballot_sync(0xffffffffu, want && topk_better(s, id, kth_v, kth_i));
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      insert(__shfl_sync(0xffffffffu, s, src), __shfl_sync(0xffffffffu, id, src), k);
    }
  }
};

// Block (x, y): slots [x * chunk, (x + 1) * chunk) of row row0 + y; its
// list goes to part_*[x][row][0:k]. With VEC, rows and chunks are whole
// 16-byte vectors.
template <bool VEC>
__global__ void __launch_bounds__(kSegThreads) segment_chunk_kernel(
    const int* __restrict__ doc, const float* __restrict__ imp, int row0, int q,
    long long p, long long chunk, int k, int sentinel, float* __restrict__ part_v,
    int* __restrict__ part_i) {
  __shared__ __align__(16) int sd[kSegStage];
  __shared__ __align__(16) float sv[kSegStage];
  __shared__ float wv[kSegWarps * TOPK_MAX];
  __shared__ int wi[kSegWarps * TOPK_MAX];
  const long long row = row0 + blockIdx.y;
  const int* d = doc + row * p;
  const float* v = imp + row * p;
  const long long c0 = static_cast<long long>(blockIdx.x) * chunk;
  const long long c1 = c0 + chunk < p ? c0 + chunk : p;
  const size_t out = (static_cast<size_t>(blockIdx.x) * q + row) * k;
  if (c0 >= p || d[c0] == sentinel) {  // only padding from here on
    if (threadIdx.x < k) {
      part_v[out + threadIdx.x] = -INFINITY;
      part_i[out + threadIdx.x] = INT_MAX;
    }
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  WarpTop top;
  for (long long s0 = c0; s0 < c1; s0 += kSegStage) {
    if (d[s0] == sentinel) break;  // the same slot for every thread
    const int n = static_cast<int>(c1 - s0 < kSegStage ? c1 - s0 : kSegStage);
    __syncthreads();  // the last stage's reads are done
    if (VEC) {
      for (int e = 4 * threadIdx.x; e < n; e += 4 * kSegThreads) {
        cp_async16(sd + e, d + s0 + e);
        cp_async16(sv + e, v + s0 + e);
      }
    } else {
      for (int e = threadIdx.x; e < n; e += kSegThreads) {
        cp_async4(sd + e, d + s0 + e);
        cp_async4(sv + e, v + s0 + e);
      }
    }
    cp_async_wait_all();
    __syncthreads();
    // a warp takes 32 slots at a time; a lane that holds a run's head sums
    // the run forward, on past the staged slots if it goes on there
    for (int at = warp * 32; at < n; at += kSegThreads) {
      const int i = at + lane;
      const int di = i < n ? sd[i] : sentinel;
      if (!__any_sync(0xffffffffu, di != sentinel)) break;  // sorted: padding from here
      bool head = false;
      float s = 0.0f;
      if (di != sentinel) {
        head = i > 0 ? sd[i - 1] != di : (s0 == 0 || d[s0 - 1] != di);
        if (head) {
          s = sv[i];
          int j = i + 1;
          for (; j < n && sd[j] == di; ++j) s += sv[j];
          if (j == n)
            for (long long g = s0 + n; g < p && d[g] == di; ++g) s += v[g];
        }
      }
      top.offer(head, s, di, k);
    }
  }

  // the warps' lists, then warp 0 takes in the other warps' entries
  if (lane < k) {
    wv[warp * TOPK_MAX + lane] = top.v;
    wi[warp * TOPK_MAX + lane] = top.i;
  }
  __syncthreads();
  if (warp == 0) {
    for (int w = 1; w < kSegWarps; ++w)
      top.offer(lane < k, lane < k ? wv[w * TOPK_MAX + lane] : -INFINITY,
                lane < k ? wi[w * TOPK_MAX + lane] : INT_MAX, k);
    if (lane < k) {
      part_v[out + lane] = top.v;
      part_i[out + lane] = top.i;
    }
  }
}

}  // namespace

// doc/imp are [q, p] contiguous device arrays sorted by doc per row;
// out_v/out_i are [q, k] with 1 <= k <= TOPK_MAX; part_v/part_i are
// [nchunks, q, k] scratch, nchunks = ceil(p / chunk) (at least 1), at most
// 32 * MERGE_LISTS; chunk a positive multiple of 4.
extern "C" int segment_topk(const void* doc, const void* imp, int q, long long p, int k,
                            int sentinel, long long chunk, int nchunks, void* part_v,
                            void* part_i, void* out_v, void* out_i, void* stream) {
  const long long want = p > 0 ? (p + chunk - 1) / chunk : 1;
  if (k < 1 || k > TOPK_MAX || chunk < 4 || chunk % 4 || nchunks != want ||
      nchunks > 32 * MERGE_LISTS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = p % 4 == 0 && (reinterpret_cast<uintptr_t>(doc) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(imp) & 15) == 0;
  const int* dd = static_cast<const int*>(doc);
  const float* dv = static_cast<const float*>(imp);
  float* pv = static_cast<float*>(part_v);
  int* pi = static_cast<int*>(part_i);
  for (int row0 = 0; row0 < q; row0 += MAX_GRID_Y) {
    const int rows = q - row0 < MAX_GRID_Y ? q - row0 : MAX_GRID_Y;
    dim3 grid(static_cast<unsigned>(nchunks), rows);
    if (vec)
      segment_chunk_kernel<true><<<grid, kSegThreads, 0, st>>>(dd, dv, row0, q, p, chunk, k,
                                                              sentinel, pv, pi);
    else
      segment_chunk_kernel<false><<<grid, kSegThreads, 0, st>>>(dd, dv, row0, q, p, chunk, k,
                                                               sentinel, pv, pi);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(launch_merge_partial_topk(pv, pi, nchunks, q, k, k,
                                                    static_cast<float*>(out_v),
                                                    static_cast<int*>(out_i), st, 0.0f));
}
