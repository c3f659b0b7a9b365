// Segmented posting gather over an aligned postings layout.
//
// Replaces probing_rag_tpu/ops/pallas_sparse.py::_gather_kernel (with the
// XLA tail mask of postings_gather_pallas, and the per-block weight multiply
// that retrieval/bm25.py::_hybrid_gather_sort applies after it). Row q of
// the [Q, pad] output is the concatenation of its terms' slices
// [start, start + len) of the postings arrays; starts and lengths are
// multiples of the block, so every output block copies one block of one
// term. A term past pad is cut; slots past the row total are sentinel / 0.
// With the O copy given, a term whose slice starts at an odd output block
// (its exclusive prefix / block is odd) is read from O and the others from
// E: over the bitonic store's block-alternated copies, every output block
// then comes out sorted, ascending at even block index and descending at
// odd. It serves the "dma" engine mode (the aligned CSR, E only) and the
// over-cap hybrid's long terms (E and O, with block weights).
//
// Bound on this card: device-memory bandwidth. It reads 8 bytes and writes
// 8 bytes a slot, with one multiply. Design: one thread block per (row,
// output block). Thread 0 finds the owning term by binary search over the
// row's inclusive prefix of lengths; then each thread copies 4 slots with
// one 16-byte load and store of docs and one of impacts. Aligned starts and
// lengths keep every such access aligned. The Pallas kernel's sequential
// wait-each DMA chunks, their overshoot into the next term's slice and the
// in-row slack it needed are not carried over: blocks are independent.

#include "common.cuh"

namespace {

constexpr int kGatherThreads = 256;

__global__ void postings_gather_kernel(
    const int* __restrict__ doc_e, const float* __restrict__ imp_e,
    const int* __restrict__ doc_o, const float* __restrict__ imp_o,
    const int* __restrict__ starts, const long long* __restrict__ ends,
    const float* __restrict__ wtblk, int row0, int tq, long long pad,
    int block, int sentinel, int* __restrict__ out_doc,
    float* __restrict__ out_imp) {
  const long long row = row0 + blockIdx.y;
  const long long blk = blockIdx.x;
  const long long b0 = blk * block;
  const long long* e = ends + row * tq;

  __shared__ int owner;
  if (threadIdx.x == 0) {
    // the first term whose inclusive end is past b0 (empty terms never are)
    int lo = 0, hi = tq;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (e[mid] > b0) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    owner = lo;
  }
  __syncthreads();

  int4* od = reinterpret_cast<int4*>(out_doc + row * pad + b0);
  float4* oi = reinterpret_cast<float4*>(out_imp + row * pad + b0);
  const int n4 = block / 4;
  const int t = owner;
  if (t >= tq) {  // past the row total
    const int4 sd = make_int4(sentinel, sentinel, sentinel, sentinel);
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int i = threadIdx.x; i < n4; i += blockDim.x) {
      od[i] = sd;
      oi[i] = zero;
    }
    return;
  }
  const long long cum = t > 0 ? e[t - 1] : 0;
  const bool odd = doc_o != nullptr && ((cum / block) & 1);
  const long long off = static_cast<long long>(starts[row * tq + t]) + (b0 - cum);
  const int4* sd = reinterpret_cast<const int4*>((odd ? doc_o : doc_e) + off);
  const float4* si = reinterpret_cast<const float4*>((odd ? imp_o : imp_e) + off);
  const float w = wtblk != nullptr ? wtblk[row * (pad / block) + blk] : 1.0f;
  for (int i = threadIdx.x; i < n4; i += blockDim.x) {
    od[i] = sd[i];
    float4 v = si[i];
    v.x *= w;
    v.y *= w;
    v.z *= w;
    v.w *= w;
    oi[i] = v;
  }
}

}  // namespace

// Pointers are device pointers. starts is [q, tq] int32, ends the [q, tq]
// int64 inclusive prefix of the row's lengths; doc_o / imp_o are null for
// the plain form; wtblk is [q, pad / block] f32 or null; outputs are
// [q, pad]. pad and every start and length are multiples of block, block a
// multiple of 4, and the arrays 16-byte aligned.
extern "C" int postings_gather(const void* doc_e, const void* imp_e,
                               const void* doc_o, const void* imp_o,
                               const void* starts, const void* ends,
                               const void* wtblk, int q, int tq, long long pad,
                               int block, int sentinel, void* out_doc,
                               void* out_imp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int row0 = 0; row0 < q; row0 += MAX_GRID_Y) {
    const int rows = q - row0 < MAX_GRID_Y ? q - row0 : MAX_GRID_Y;
    dim3 grid(static_cast<unsigned>(pad / block), rows);
    postings_gather_kernel<<<grid, kGatherThreads, 0, st>>>(
        static_cast<const int*>(doc_e), static_cast<const float*>(imp_e),
        static_cast<const int*>(doc_o), static_cast<const float*>(imp_o),
        static_cast<const int*>(starts), static_cast<const long long*>(ends),
        static_cast<const float*>(wtblk), row0, tq, pad, block, sentinel,
        static_cast<int*>(out_doc), static_cast<float*>(out_imp));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
