// BM25 posting gather over the block-alternated bitonic store.
//
// Replaces probing_rag_tpu/ops/pallas_sparse.py::_bitonic_gather_kernel
// (with the XLA tail mask and per-block dedup weight that sit beside it in
// bm25_search_bitonic). Each [Q, pad] output row is the concatenation of its
// query terms' slots: a long term's slot is a copy of its aligned region in
// the E or O store (E when the slot starts at an even 1024-block of the row,
// O when odd), a short term's slot is one block holding its postings
// ascending at the head (even block, compact copy) or descending at the tail
// (odd block, reversed copy) with sentinel fill. Blocks past the row total
// are sentinel / 0. So every block of a row comes out sorted, ascending at
// even block index and descending at odd, which is what lets the sort start
// at pass 2 * block.
//
// Bound on this card: device-memory bandwidth. It moves 8 bytes in and 8
// bytes out per slot and does no arithmetic beyond the weight multiply.
// Design: one thread block per (row, 1024-block); the block's owning term is
// found once, then 256 threads copy the block with neighbouring threads on
// neighbouring addresses, so every load and store is coalesced. The Pallas
// kernel's DMA windows, rolls and 1024-aligned offsets are not needed: a
// CUDA thread reads any address.

#include "common.cuh"

namespace {

constexpr int kGatherThreads = 256;

__global__ void bm25_gather_kernel(
    const int* __restrict__ doc_e, const float* __restrict__ imp_e,
    const int* __restrict__ doc_o, const float* __restrict__ imp_o,
    const int* __restrict__ doc_c, const float* __restrict__ imp_c,
    const int* __restrict__ doc_r, const float* __restrict__ imp_r,
    const int* __restrict__ src, const int* __restrict__ srcr,
    const int* __restrict__ slot, const int* __restrict__ rlen,
    const int* __restrict__ big, const int* __restrict__ cum,
    const float* __restrict__ wtblk, int row0, int tq, long long pad,
    int block, int sentinel, int* __restrict__ out_doc,
    float* __restrict__ out_imp) {
  const long long row = row0 + blockIdx.y;
  const long long blk = blockIdx.x;
  const long long b0 = blk * block;
  const long long desc = row * tq;

  __shared__ int owner;
  if (threadIdx.x == 0) {
    int found = -1;
    for (int t = 0; t < tq; ++t) {
      const int w = slot[desc + t];
      const int c = cum[desc + t];
      if (w > 0 && c <= b0 && b0 < (long long)c + w) {
        found = t;
        break;
      }
    }
    owner = found;
  }
  __syncthreads();

  int* od = out_doc + row * pad + b0;
  float* oi = out_imp + row * pad + b0;
  const int t = owner;
  if (t < 0) {  // past the row total
    for (int lane = threadIdx.x; lane < block; lane += blockDim.x) {
      od[lane] = sentinel;
      oi[lane] = 0.0f;
    }
    return;
  }
  const float w = wtblk != nullptr ? wtblk[row * (pad / block) + blk] : 1.0f;
  const int c = cum[desc + t];
  const int s = src[desc + t];
  const int parity = (c / block) & 1;
  if (big[desc + t]) {
    const int* sd = parity ? doc_o : doc_e;
    const float* si = parity ? imp_o : imp_e;
    const long long off = (long long)s + (b0 - c);
    for (int lane = threadIdx.x; lane < block; lane += blockDim.x) {
      od[lane] = sd[off + lane];
      oi[lane] = si[off + lane] * w;
    }
    return;
  }
  const int len = rlen[desc + t];
  if (parity == 0) {
    for (int lane = threadIdx.x; lane < block; lane += blockDim.x) {
      const bool in = lane < len;
      od[lane] = in ? doc_c[(long long)s + lane] : sentinel;
      oi[lane] = in ? imp_c[(long long)s + lane] * w : 0.0f;
    }
  } else {
    const int lead = block - len;
    const long long r = srcr[desc + t];
    for (int lane = threadIdx.x; lane < block; lane += blockDim.x) {
      const bool in = lane >= lead;
      od[lane] = in ? doc_r[r + lane - lead] : sentinel;
      oi[lane] = in ? imp_r[r + lane - lead] * w : 0.0f;
    }
  }
}

}  // namespace

// Pointers are device pointers; descriptors are [q, tq] int32 row-major;
// wtblk is [q, pad / block] f32 or null; outputs are [q, pad].
extern "C" int bm25_gather(const void* doc_e, const void* imp_e,
                           const void* doc_o, const void* imp_o,
                           const void* doc_c, const void* imp_c,
                           const void* doc_r, const void* imp_r,
                           const void* src, const void* srcr, const void* slot,
                           const void* rlen, const void* big, const void* cum,
                           const void* wtblk, int q, int tq, long long pad,
                           int block, int sentinel, void* out_doc,
                           void* out_imp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int row0 = 0; row0 < q; row0 += MAX_GRID_Y) {
    const int rows = q - row0 < MAX_GRID_Y ? q - row0 : MAX_GRID_Y;
    dim3 grid(static_cast<unsigned>(pad / block), rows);
    bm25_gather_kernel<<<grid, kGatherThreads, 0, st>>>(
        static_cast<const int*>(doc_e), static_cast<const float*>(imp_e),
        static_cast<const int*>(doc_o), static_cast<const float*>(imp_o),
        static_cast<const int*>(doc_c), static_cast<const float*>(imp_c),
        static_cast<const int*>(doc_r), static_cast<const float*>(imp_r),
        static_cast<const int*>(src), static_cast<const int*>(srcr),
        static_cast<const int*>(slot), static_cast<const int*>(rlen),
        static_cast<const int*>(big), static_cast<const int*>(cum),
        static_cast<const float*>(wtblk), row0, tq, pad, block, sentinel,
        static_cast<int*>(out_doc), static_cast<float*>(out_imp));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
