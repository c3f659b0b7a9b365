// IVF probed search: for each 8-query tile, score the store blocks its
// descriptors name and keep a running top-k of document ids per query.
//
// Replaces probing_rag_tpu/ops/pallas_ivf.py::_kernel (ivf_topk_pallas).
// The TPU kernel walks one tile's descriptor list in order on one core,
// with the descriptors brought ahead by scalar prefetch and the running
// top-k carried in VMEM scratch. Here block (t, s) walks the s-th slice of
// tile t's descriptor list and reads its own descriptors; its running
// top-k lives in shared memory and is written as a partial list, and the
// second pass of topk_merge.cuh merges the slices of each query.
//
// Bound on the H100: a probed block of 256 x 768 is scored by only 8
// queries, about 4 multiply-adds per byte read from bf16, so the kernel is
// bound by bytes. With one thread block per tile, a batch of 64 queries
// would run on 8 of the 132 SMs; splitting each tile's descriptor list over
// many blocks keeps every SM reading. Descriptors that name the all-pad
// block are skipped without reading it (it can insert nothing), and so are
// descriptors outside the store, which the planner never makes (checking
// them on the host would cost a sync per search). Any D and any block
// size work: a second instantiation (TAIL) stages depth past D and rows
// past a block as zeros. Scores are
// f32 FMAs over 4-wide shared-memory reads: bf16 and int8 rows are widened
// to f32 as they are staged (exact), and the int8 score is scaled per row.
// Each step marks the rows that beat a query's current k-th in a bitmask;
// one thread per query then inserts only those.
//
// Rows with id < 0 (cell padding) score -inf and never insert. Ranking:
// score descending, then document id ascending; l2 ranks by
// 2 q.d - |d|^2. Empty slots come out as (-inf, -1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "topk_merge.cuh"

#define QTILE 8     // queries per tile
#define RT 32       // store rows per step
#define KC 64       // depth per step
#define LD (KC + 4) // staged row stride (floats), keeps float4 reads aligned
#define THREADS 256 // QTILE x RT: one (query, row) score per thread

enum Mode { BF16 = 0, INT8 = 1, F32 = 2 };

// Elements e0 .. e0 + 7 of row `row` of a [rows, d] matrix, as loaded
// (bf16: 16 bytes; int8: 8; f32: 32), and widened to f32 when staged.
// With TAIL, elements past d read as zero.
template <int MODE, bool TAIL>
__device__ __forceinline__ void load8(const void* base, size_t row, int d, int e0,
                                      uint4 (&raw)[2]) {
  constexpr int ELT = MODE == BF16 ? 2 : (MODE == INT8 ? 1 : 4);
  const void* p = static_cast<const unsigned char*>(base) + row * d * ELT;
  if constexpr (MODE == BF16) {
    raw[0] = vload16<TAIL>(p, e0 * 2, d * 2);
  } else if constexpr (MODE == INT8) {
    const uint2 v = vload8<TAIL>(p, e0, d);
    raw[0] = make_uint4(v.x, v.y, 0, 0);
  } else {
    raw[0] = vload16<TAIL>(p, e0 * 4, d * 4);
    raw[1] = vload16<TAIL>(p, e0 * 4 + 16, d * 4);
  }
}

template <int MODE>
__device__ __forceinline__ void widen8(const uint4 (&raw)[2], float* out) {
  if constexpr (MODE == BF16) {
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw[0]);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(h[i]);
  } else if constexpr (MODE == INT8) {
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw[0]);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = static_cast<float>(b[i]);
  } else {
    const float* f = reinterpret_cast<const float*>(&raw[0]);
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = f[i];
    f = reinterpret_cast<const float*>(&raw[1]);
#pragma unroll
    for (int i = 0; i < 4; ++i) out[4 + i] = f[i];
  }
}

template <int MODE, bool TAIL>
__global__ void __launch_bounds__(THREADS) ivf_topk_partial_kernel(
    const void* __restrict__ q, const int* __restrict__ desc, const void* __restrict__ store,
    const int* __restrict__ ids, const float* __restrict__ sqn,
    const float* __restrict__ scales, int nt, int pb, int per_split, int block, int d,
    int pad_block, float* __restrict__ part_v, int* __restrict__ part_i) {
  __shared__ __align__(16) float qs[QTILE * LD];
  __shared__ __align__(16) float ds[RT * LD];
  __shared__ float sc[QTILE * (RT + 1)];
  __shared__ int cid[RT];
  __shared__ unsigned int qmask[QTILE];  // rows of this step that beat each query's k-th
  __shared__ float rv[QTILE * TOPK_MAX];
  __shared__ int ri[QTILE * TOPK_MAX];
  const int tid = threadIdx.x;
  const int t = blockIdx.x;
  const int qi = tid & 7, r = tid >> 3;  // this thread's (query, row)
  if (tid < QTILE * TOPK_MAX) {
    rv[tid] = -INFINITY;
    ri[tid] = INT_MAX;
  }
  if (tid < QTILE) qmask[tid] = 0;
  int filled = 0;  // entries in query tid's list (threads below QTILE)
  const int j0 = blockIdx.y * per_split;
  const int j1 = j0 + per_split < pb ? j0 + per_split : pb;
  const size_t qrow0 = (size_t)t * QTILE;
  for (int j = j0; j < j1; ++j) {
    const int b = desc[(size_t)t * pb + j];
    // the pad block, and any descriptor outside the store, is a hole (the
    // same for every thread of the block)
    if (b < 0 || b >= pad_block) continue;
    for (int r0 = 0; r0 < block; r0 += RT) {
      const size_t row0 = (size_t)b * block + r0;
      float acc = 0.0f;
      // staging: store row sr and, in threads below 64, query row sr; 8
      // elements at c; the next step's loads are issued before this
      // step's products. Rows past the block (block % RT != 0) stage zeros.
      constexpr int QM = MODE == F32 ? F32 : BF16;  // the queries' dtype
      const int sr = tid >> 3, c = (tid & 7) * 8;
      const bool stages_q = tid < QTILE * KC / 8;
      const bool in_block = !TAIL || r0 + sr < block;
      uint4 qraw[2], sraw[2] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
      if (stages_q) load8<QM, TAIL>(q, qrow0 + sr, d, c, qraw);
      if (in_block) load8<MODE, TAIL>(store, row0 + sr, d, c, sraw);
      for (int k0 = 0; k0 < d; k0 += KC) {
        float tmp[8];
        if (stages_q) {
          widen8<QM>(qraw, tmp);
#pragma unroll
          for (int i = 0; i < 8; ++i) qs[sr * LD + c + i] = tmp[i];
        }
        widen8<MODE>(sraw, tmp);
#pragma unroll
        for (int i = 0; i < 8; ++i) ds[sr * LD + c + i] = tmp[i];
        __syncthreads();
        if (k0 + KC < d) {
          if (stages_q) load8<QM, TAIL>(q, qrow0 + sr, d, k0 + KC + c, qraw);
          if (in_block) load8<MODE, TAIL>(store, row0 + sr, d, k0 + KC + c, sraw);
        }
#pragma unroll
        for (int kk = 0; kk < KC; kk += 4) {
          const float4 a = *reinterpret_cast<const float4*>(qs + qi * LD + kk);
          const float4 e = *reinterpret_cast<const float4*>(ds + r * LD + kk);
          acc = fmaf(a.x, e.x, acc);
          acc = fmaf(a.y, e.y, acc);
          acc = fmaf(a.z, e.z, acc);
          acc = fmaf(a.w, e.w, acc);
        }
        __syncthreads();
      }
      const size_t row = row0 + r;
      const int id = !TAIL || r0 + r < block ? ids[row] : -1;
      float v = -INFINITY;
      if (id >= 0) {
        v = acc;
        if (MODE == INT8) v *= scales[row];
        if (sqn != nullptr) v = 2.0f * v - sqn[row];
      }
      sc[qi * (RT + 1) + r] = v;
      if (qi == 0) cid[r] = id;
      // the lists change only after the barrier below; ids are unique
      // within a tile, so only a strictly higher score can displace the
      // k-th by score alone, and an equal one by a lower id
      if (v > -INFINITY && topk_better(v, id, rv[qi * TOPK_MAX + TOPK_MAX - 1],
                                       ri[qi * TOPK_MAX + TOPK_MAX - 1]))
        atomicOr(&qmask[qi], 1u << r);
      __syncthreads();
      if (tid < QTILE) {
        float* vals = rv + tid * TOPK_MAX;
        int* out = ri + tid * TOPK_MAX;
        unsigned int m = qmask[tid];
        qmask[tid] = 0;
        while (m) {  // the candidates, in row order
          const int cc = __ffs(m) - 1;
          m &= m - 1;
          topk_insert(vals, out, TOPK_MAX, filled, sc[tid * (RT + 1) + cc], cid[cc]);
        }
      }
      __syncthreads();
    }
  }
  __syncthreads();
  if (tid < QTILE * TOPK_MAX) {
    const size_t o = ((size_t)blockIdx.y * nt * QTILE + qrow0) * TOPK_MAX + tid;
    part_v[o] = rv[tid];
    part_i[o] = ri[tid];
  }
}

// queries [nt * 8, d] (bf16 for bf16/int8 stores, f32 for f32); desc
// [nt, pb] block indices in [0, nb); store [nb * block, d]; ids
// [nb * block] (-1 = pad row); sqn (l2) and scales (int8) [nb * block] f32
// or null; nsplit <= 32 * MERGE_LISTS. part_v/part_i: [nsplit, nt * 8,
// TOPK_MAX]; out: [nt * 8, k].
extern "C" int ivf_topk(const void* q, const void* desc, const void* store, const void* ids,
                        const void* sqn, const void* scales, int mode, int nt, int pb,
                        int per_split, int nsplit, int block, int d, int pad_block, int k,
                        void* part_v, void* part_i, void* out_v, void* out_i, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > TOPK_MAX || nsplit < 1 || nsplit > 32 * MERGE_LISTS)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(nt, nsplit);
  const int* dc = static_cast<const int*>(desc);
  const int* id = static_cast<const int*>(ids);
  const float* sq = static_cast<const float*>(sqn);
  const float* sl = static_cast<const float*>(scales);
  float* pv = static_cast<float*>(part_v);
  int* pi = static_cast<int*>(part_i);
  // the TAIL variant when D is not a whole number of 64-deep steps, a
  // block not of 32-row steps, or an operand not 16-byte aligned
  const bool tail = d % KC != 0 || block % RT != 0 ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(store)) & 15) != 0;
  decltype(&ivf_topk_partial_kernel<BF16, false>) kernel;
  switch (mode) {
    case BF16:
      kernel = tail ? ivf_topk_partial_kernel<BF16, true> : ivf_topk_partial_kernel<BF16, false>;
      break;
    case INT8:
      kernel = tail ? ivf_topk_partial_kernel<INT8, true> : ivf_topk_partial_kernel<INT8, false>;
      break;
    case F32:
      kernel = tail ? ivf_topk_partial_kernel<F32, true> : ivf_topk_partial_kernel<F32, false>;
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<grid, THREADS, 0, s>>>(q, dc, store, id, sq, sl, nt, pb, per_split, block, d,
                                  pad_block, pv, pi);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_merge_partial_topk(
      pv, pi, nsplit, nt * QTILE, TOPK_MAX, k, static_cast<float*>(out_v),
      static_cast<int*>(out_i), s));
}
