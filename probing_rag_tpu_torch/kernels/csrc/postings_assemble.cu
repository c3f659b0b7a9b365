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
// Bound on this card: device-memory bandwidth, 8 bytes read for each real
// posting and 8 written for each slot, with one multiply. Design: output-
// stationary, one thread block per (row, span of slots) over all SMs
// (ops/sparse.py::plan_assemble picks the span, a multiple of kTile, for
// about two blocks an SM). A block walks its span a tile of kTile slots at
// a time. For each tile it scans the row's term lengths in chunks of
// blockDim from where the last tile stopped (a block-wide scan of length
// and non-empty count packed in 64 bits, the next chunk's loads in flight
// meanwhile), keeps in shared memory the non-empty terms that overlap the
// tile (at most kTile of them: each owns a slot of it) as end, source base
// and weight, and stops once the prefix passes the tile's end. Then each
// thread writes 4 consecutive slots with one 16-byte store of docs and one
// of impacts: it finds its first slot's term by binary search over the
// shared ends and steps forward across term ends, with scalar loads from
// the compact copy (contiguous within a term, coalesced across the warp).
// Every block of a row repeats the scan up to its span: 12 bytes a term
// (length, source, weight), from L2 after the first block, against the
// span x 8 bytes the block writes; no prefix launch runs before it. The
// Pallas kernel's 2-block DMA windows, rolls, staging flushes and int32
// bit-pattern weights (an SMEM limit) are not needed: a CUDA thread reads
// and writes any address.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;         // terms a scan chunk covers
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4 * kThreads;   // slots a block writes per step
constexpr unsigned long long kLenMask = (1ull << 48) - 1;  // low: lengths; high: non-empty count

__global__ void __launch_bounds__(kThreads) postings_assemble_kernel(
    const int* __restrict__ doc_c, const float* __restrict__ imp_c,
    const int* __restrict__ src, const int* __restrict__ rlen,
    const float* __restrict__ wt, int row0, int tq, long long pad, long long ld,
    long long span, int sentinel, int* __restrict__ out_doc,
    float* __restrict__ out_imp) {
  __shared__ int s_end[kTile];   // each entry's end, from the tile's first slot
  __shared__ int s_base[kTile];  // compact index of the tile's first slot
  __shared__ float s_w[kTile];
  __shared__ unsigned long long s_warp[kWarps];
  const long long row = row0 + blockIdx.y;
  const int* rs = src + row * tq;
  const int* rl = rlen + row * tq;
  const float* rw = wt != nullptr ? wt + row * tq : nullptr;
  int* od = out_doc + row * ld;
  float* oi = out_imp + row * ld;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b0 = blockIdx.x * span;
  const long long b1 = b0 + span < pad ? b0 + span : pad;

  // this thread's term of a scan chunk: length, compact start, weight
  auto load = [&](int t, int& len, int& s, float& w) {
    len = 0;
    s = 0;
    w = 1.0f;
    if (t < tq) {
      len = rl[t];
      s = rs[t];
      if (rw != nullptr) w = rw[t];
    }
  };
  int t0 = 0;          // first term of the scan chunk
  long long base = 0;  // postings of the terms before it
  int len, s;
  float w;
  load(threadIdx.x, len, s, w);
  int next_len, next_s;  // the next chunk's, loaded while this one is scanned
  float next_w;
  bool prefetched = false;
  for (long long c0 = b0; c0 < b1; c0 += kTile) {
    const long long c1 = c0 + kTile;
    int n = 0;  // entries of this tile
    while (t0 < tq) {
      if (!prefetched) {
        load(t0 + kThreads + threadIdx.x, next_len, next_s, next_w);
        prefetched = true;
      }
      unsigned long long x = (static_cast<unsigned long long>(len > 0) << 48) |
                             static_cast<unsigned int>(len);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {  // inclusive scan within the warp
        const unsigned long long y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      if (lane == 31) s_warp[warp] = x;
      __syncthreads();
      if (warp == 0) {  // scan of the warp totals
        unsigned long long v = lane < kWarps ? s_warp[lane] : 0ull;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const unsigned long long y = __shfl_up_sync(0xffffffffu, v, o);
          if (lane >= o) v += y;
        }
        if (lane < kWarps) s_warp[lane] = v;
      }
      __syncthreads();
      x += warp > 0 ? s_warp[warp - 1] : 0ull;
      const long long next = base + static_cast<long long>(s_warp[kWarps - 1] & kLenMask);
      const long long end = base + static_cast<long long>(x & kLenMask);
      const long long start = end - len;
      // entries are numbered by non-empty rank: the chunk's terms that end
      // at or before c0 precede the overlapping ones. (The two counting
      // barriers also keep the next chunk's s_warp writes behind the reads.)
      const int nbefore = __syncthreads_count(len > 0 && end <= c0);
      const bool ov = len > 0 && end > c0 && start < c1;
      if (ov) {
        const int e = n + static_cast<int>(x >> 48) - 1 - nbefore;
        s_end[e] = static_cast<int>(end - c0 < kTile ? end - c0 : kTile);
        s_base[e] = static_cast<int>(s - (start - c0));
        s_w[e] = w;
      }
      n += __syncthreads_count(ov);
      if (next >= c1) break;  // later terms start at or past the tile's end;
                              // the next tile rescans this chunk
      t0 += kThreads;
      base = next;
      len = next_len;
      s = next_s;
      w = next_w;
      prefetched = false;
    }

    const int j0 = 4 * threadIdx.x;
    if (c0 + j0 < b1) {  // pad % 4 == 0: the 4 slots are in the row or none is
      int lo = 0, hi = n;  // the first entry whose end is past j0
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s_end[mid] > j0) {
          hi = mid;
        } else {
          lo = mid + 1;
        }
      }
      int d[4];
      float v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + c;
        while (lo < n && s_end[lo] <= j) ++lo;
        if (lo < n) {
          const int k = s_base[lo] + j;
          d[c] = doc_c[k];
          v[c] = imp_c[k] * s_w[lo];
        } else {
          d[c] = sentinel;
          v[c] = 0.0f;
        }
      }
      *reinterpret_cast<int4*>(od + c0 + j0) = make_int4(d[0], d[1], d[2], d[3]);
      *reinterpret_cast<float4*>(oi + c0 + j0) = make_float4(v[0], v[1], v[2], v[3]);
    }
    // the next tile writes the entries only after the barriers of its first
    // chunk, which every thread reaches after this copy
  }
}

}  // namespace

// Pointers are device pointers. src and rlen are [q, tq] int32, wt [q, tq]
// f32 or null; out_doc / out_imp point at row 0 of a [q, pad] region whose
// rows are ld elements apart, 16-byte aligned. pad and ld are multiples of
// 4; span (the slots of a row each block writes) a multiple of 2048.
extern "C" int postings_assemble(const void* doc_c, const void* imp_c,
                                 const void* src, const void* rlen,
                                 const void* wt, int q, int tq, long long pad,
                                 long long ld, long long span, int sentinel,
                                 void* out_doc, void* out_imp, void* stream) {
  if (span <= 0 || span % kTile || pad % 4 || ld % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((pad + span - 1) / span);
  for (int row0 = 0; row0 < q; row0 += MAX_GRID_Y) {
    const int rows = q - row0 < MAX_GRID_Y ? q - row0 : MAX_GRID_Y;
    postings_assemble_kernel<<<dim3(blocks, rows), kThreads, 0, st>>>(
        static_cast<const int*>(doc_c), static_cast<const float*>(imp_c),
        static_cast<const int*>(src), static_cast<const int*>(rlen),
        static_cast<const float*>(wt), row0, tq, pad, ld, span, sentinel,
        static_cast<int*>(out_doc), static_cast<float*>(out_imp));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
