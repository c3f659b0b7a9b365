// Compact assembly of short posting lists into query rows.
//
// Replaces probing_rag_tpu/ops/pallas_sparse.py::_assemble_kernel (with the
// XLA tail mask of postings_assemble_pallas). Row q of the [Q, pad] output
// holds its terms' postings back to back in term order: term t's rlen
// postings from the compact copy at src, each impact times the term's f32
// weight; slots past the row total are sentinel / 0, and a posting past pad
// is cut. The row may lie in a wider buffer (row stride ld): the BM25
// over-cap hybrid writes its short tail straight into the long-term row's
// reserved slack.
//
// Bound on this card: device-memory bandwidth (8 bytes read and 8 written a
// posting, 8 written a padding slot), but short lists (fewer than 256
// postings, the bitonic store's min_len) make it latency-bound in practice.
// Design: one thread block per row. The block walks its terms in chunks of
// blockDim: each thread loads one term's length, a block-wide scan gives
// every term its offset, then each warp copies whole terms, lanes on
// neighbouring postings. The Pallas kernel's 2-block DMA windows, rolls,
// staging flushes and int32 bit-pattern weights (an SMEM limit) are not
// needed: a CUDA thread reads and writes any address.

#include "common.cuh"

namespace {

constexpr int kAssembleThreads = 512;
constexpr int kWarps = kAssembleThreads / 32;

__global__ void postings_assemble_kernel(
    const int* __restrict__ doc_c, const float* __restrict__ imp_c,
    const int* __restrict__ src, const int* __restrict__ rlen,
    const float* __restrict__ wt, int tq, long long pad, long long ld,
    int sentinel, int* __restrict__ out_doc, float* __restrict__ out_imp) {
  __shared__ long long s_off[kAssembleThreads];  // exclusive offsets, this chunk
  __shared__ int s_warp[kWarps];
  const long long row = blockIdx.x;
  const int* rs = src + row * tq;
  const int* rl = rlen + row * tq;
  const float* rw = wt != nullptr ? wt + row * tq : nullptr;
  int* od = out_doc + row * ld;
  float* oi = out_imp + row * ld;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  long long base = 0;  // postings placed by the earlier chunks
  for (int t0 = 0; t0 < tq; t0 += kAssembleThreads) {
    const int t = t0 + threadIdx.x;
    const int len = t < tq ? rl[t] : 0;
    int x = len;  // inclusive scan within the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    if (warp == 0) {  // scan of the warp totals
      int w = lane < kWarps ? s_warp[lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      if (lane < kWarps) s_warp[lane] = w;
    }
    __syncthreads();
    s_off[threadIdx.x] = base + (warp > 0 ? s_warp[warp - 1] : 0) + x - len;
    const long long chunk_total = s_warp[kWarps - 1];
    __syncthreads();
    const int n = tq - t0 < kAssembleThreads ? tq - t0 : kAssembleThreads;
    for (int j = warp; j < n; j += kWarps) {
      const int L = rl[t0 + j];
      const long long dst = s_off[j];
      const long long s = rs[t0 + j];
      const float w = rw != nullptr ? rw[t0 + j] : 1.0f;
      for (int i = lane; i < L; i += 32) {
        if (dst + i < pad) {
          od[dst + i] = doc_c[s + i];
          oi[dst + i] = imp_c[s + i] * w;
        }
      }
    }
    base += chunk_total;
    __syncthreads();  // s_off and s_warp are rewritten by the next chunk
  }
  for (long long p = (base < pad ? base : pad) + threadIdx.x; p < pad;
       p += kAssembleThreads) {
    od[p] = sentinel;
    oi[p] = 0.0f;
  }
}

}  // namespace

// Pointers are device pointers. src and rlen are [q, tq] int32, wt [q, tq]
// f32 or null; out_doc / out_imp point at row 0 of a [q, pad] region whose
// rows are ld elements apart.
extern "C" int postings_assemble(const void* doc_c, const void* imp_c,
                                 const void* src, const void* rlen,
                                 const void* wt, int q, int tq, long long pad,
                                 long long ld, int sentinel, void* out_doc,
                                 void* out_imp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  postings_assemble_kernel<<<q, kAssembleThreads, 0, st>>>(
      static_cast<const int*>(doc_c), static_cast<const float*>(imp_c),
      static_cast<const int*>(src), static_cast<const int*>(rlen),
      static_cast<const float*>(wt), tq, pad, ld, sentinel,
      static_cast<int*>(out_doc), static_cast<float*>(out_imp));
  return static_cast<int>(cudaGetLastError());
}
