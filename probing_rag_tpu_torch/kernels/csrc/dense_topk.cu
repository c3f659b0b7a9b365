// Flat dense search: Q x N scores with a running top-k per query, the
// [Q, N] score matrix never written to device memory.
//
// Replaces probing_rag_tpu/ops/pallas_dense.py::_kernel (dense_topk_pallas,
// with topk_merge_tile_nocarry). The TPU kernel walks N in order inside one
// query block and carries the running top-k in VMEM scratch across grid
// steps. Here N is split across thread blocks instead: block (x, y) scores
// query tile x (64 queries) against store chunk y, keeps a running top-kp
// per query in shared memory, and writes it as a partial list; a second
// small pass (topk_merge.cuh) merges the partial lists of each query.
//
// Bound on the H100: at 256 queries x 500,000 x 768 bf16 the store read is
// 768 MB (0.23 ms at 3.35 TB/s) and the work 197 GFLOP (0.20 ms at 989
// TFLOP/s bf16), near the ridge. The design keeps every SM streaming the
// store (about 4 blocks per SM over the whole grid) and puts the query tile
// in blockIdx.x, so the tiles that read one chunk run side by side and
// share it through L2. Scores come off the tensor cores (WMMA bf16, f32
// accumulation) for bf16 stores and for int8 stores, which are dequantized
// to bf16 in shared memory (exact for |v| <= 127) and scaled per document
// afterwards; f32 stores use f32 FMAs (no TF32), and int8 x int8 queries
// use dp4a with int32 sums. The epilogue marks, four threads to a row, the
// columns that beat the row's current kp-th score; one thread then inserts
// only those. The running lists take QT x kp entries of dynamic shared
// memory, so kp runs up to MAX_KP (256: the coarse quantizer's nprobe),
// and an insertion walks only the filled part of a list. Any D works: a
// second instantiation (TAIL) stages depth past D as zeros.
//
// Ranking: score descending, then column ascending. l2 ranks by
// 2 q.d - |d|^2 (the caller adds |q|^2 back). Columns at or past n score
// -inf and never enter a list; empty slots come out as (-inf, -1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "topk_merge.cuh"

using namespace nvcuda;

#define QT 64       // queries per block
#define TN 64       // store rows per tile
#define THREADS 256
#define SC_LD (TN + 4)  // score tile row stride (floats)

enum Mode { BF16 = 0, INT8_DEQ = 1, F32 = 2, INT8_MXU = 3 };

// ---- score tiles: sc[r * SC_LD + c] = q[q0 + r] . store[t0 + c], raw sums

// bf16 queries x (bf16 | int8 dequantized to bf16) store, WMMA 16x16x16,
// 64 deep per step. Each thread stages 16 elements of one query row and
// one store row; the next step's global loads are issued before this
// step's products, so their latency hides behind the tensor cores.
constexpr int WKC = 64;
constexpr int WLD = WKC + 8;  // bf16 row stride of the staged operands

// With TAIL, depth past d (a D that is not a multiple of 64) is staged as
// zeros; without it every load is a plain aligned vector load.
template <int MODE, bool TAIL>
__device__ __forceinline__ void wmma_load(const __nv_bfloat16* __restrict__ q,
                                          const void* __restrict__ store, int nq, int q0,
                                          long long t0, long long t1, int d, int k0, int r,
                                          int c, uint4 (&qv)[2], uint4 (&dv)[2]) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  qv[0] = qv[1] = dv[0] = dv[1] = zero;
  if (q0 + r < nq) {
    const __nv_bfloat16* p = q + (size_t)(q0 + r) * d;
    qv[0] = vload16<TAIL>(p, (k0 + c) * 2, d * 2);
    qv[1] = vload16<TAIL>(p, (k0 + c) * 2 + 16, d * 2);
  }
  const long long row = t0 + r;
  if (row >= t1) return;
  if constexpr (MODE == BF16) {
    const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(store) + row * d;
    dv[0] = vload16<TAIL>(p, (k0 + c) * 2, d * 2);
    dv[1] = vload16<TAIL>(p, (k0 + c) * 2 + 16, d * 2);
  } else {  // 16 int8 values, widened when staged
    dv[0] = vload16<TAIL>(static_cast<const int8_t*>(store) + row * d, k0 + c, d);
  }
}

template <int MODE>
__device__ __forceinline__ void wmma_stage(__nv_bfloat16* qs, __nv_bfloat16* ds, int r, int c,
                                           const uint4 (&qv)[2], const uint4 (&dv)[2]) {
  uint4* qd = reinterpret_cast<uint4*>(qs + r * WLD + c);
  uint4* dd = reinterpret_cast<uint4*>(ds + r * WLD + c);
  qd[0] = qv[0];
  qd[1] = qv[1];
  if constexpr (MODE == BF16) {
    dd[0] = dv[0];
    dd[1] = dv[1];
  } else {
    __align__(16) __nv_bfloat16 h[16];
    const int8_t* b = reinterpret_cast<const int8_t*>(&dv[0]);
#pragma unroll
    for (int i = 0; i < 16; ++i) h[i] = __float2bfloat16(static_cast<float>(b[i]));
    dd[0] = reinterpret_cast<const uint4*>(h)[0];
    dd[1] = reinterpret_cast<const uint4*>(h)[1];
  }
}

template <int MODE, bool TAIL>
__device__ void score_tile_wmma(const __nv_bfloat16* __restrict__ q,
                                const void* __restrict__ store, int nq, int q0,
                                long long t0, long long t1, int d, float* sc,
                                unsigned char* stage) {
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(stage);
  __nv_bfloat16* ds = qs + QT * WLD;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wr = (warp >> 1) * 16;  // 4 x 2 warps over the 64 x 64 tile
  const int wc = (warp & 1) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
  const int r = tid >> 2;  // staging: row r, 16 columns at c
  const int c = (tid & 3) * 16;
  uint4 qv[2], dv[2];
  wmma_load<MODE, TAIL>(q, store, nq, q0, t0, t1, d, 0, r, c, qv, dv);
  for (int k0 = 0; k0 < d; k0 += WKC) {
    wmma_stage<MODE>(qs, ds, r, c, qv, dv);
    __syncthreads();
    if (k0 + WKC < d)
      wmma_load<MODE, TAIL>(q, store, nq, q0, t0, t1, d, k0 + WKC, r, c, qv, dv);
#pragma unroll
    for (int kk = 0; kk < WKC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, qs + wr * WLD + kk, WLD);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(b, ds + (wc + j * 16) * WLD + kk, WLD);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
    __syncthreads();
  }
  // sc shares its shared memory with the staged operands, all read by now
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(sc + wr * SC_LD + wc + j * 16, acc[j], SC_LD, wmma::mem_row_major);
}

// f32 x f32 (FMA) or int8 x int8 (dp4a, int32 sums): each thread a 4 x 4
// block of the tile. Writes sc after its last step, as above.
template <int MODE, bool TAIL>
__device__ void score_tile_simt(const void* __restrict__ q, const void* __restrict__ store,
                                int nq, int q0, long long t0, long long t1, int d,
                                float* sc, unsigned char* stage) {
  // f32: 16 floats of depth per step; int8: 64 bytes (16 packed words)
  constexpr int W = 16;
  constexpr int LD = W + 1;
  typedef typename std::conditional<MODE == F32, float, int>::type T;
  T* qs = reinterpret_cast<T*>(stage);
  T* ds = qs + QT * LD;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  const int r = tid >> 2;  // staging: row r, 4 words at c
  const int c = (tid & 3) * 4;
  const int rb = MODE == F32 ? d * 4 : d;  // row length in bytes
  const int dw = (rb + 3) / 4;  // in 4-byte words, the tail read as zeros
  const unsigned char* qb = static_cast<const unsigned char*>(q);
  const unsigned char* sb = static_cast<const unsigned char*>(store);
  for (int k0 = 0; k0 < dw; k0 += W) {
    uint4 qv = make_uint4(0, 0, 0, 0), dv = make_uint4(0, 0, 0, 0);
    if (q0 + r < nq) qv = vload16<TAIL>(qb + (size_t)(q0 + r) * rb, (k0 + c) * 4, rb);
    if (t0 + r < t1) dv = vload16<TAIL>(sb + (t0 + r) * rb, (k0 + c) * 4, rb);
    const T* qe = reinterpret_cast<const T*>(&qv);
    const T* de = reinterpret_cast<const T*>(&dv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qs[r * LD + c + i] = qe[i];
      ds[r * LD + c + i] = de[i];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < W; ++kk) {
      T a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qs[(ty * 4 + i) * LD + kk];
        b[i] = ds[(tx * 4 + i) * LD + kk];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (MODE == F32) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
          else acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      sc[(ty * 4 + i) * SC_LD + tx * 4 + j] = static_cast<float>(acc[i][j]);
}

// The staged operands of one step; the score tile is written only after
// the operands of its last step are consumed, so the two share one buffer.
constexpr int STAGE_BYTES = 2 * QT * WLD * 2;
static_assert(STAGE_BYTES >= QT * SC_LD * 4, "score tile must fit the staging buffer");

template <int MODE, bool TAIL>
__global__ void __launch_bounds__(THREADS) dense_topk_partial_kernel(
    const void* __restrict__ q, const void* __restrict__ store,
    const float* __restrict__ sqn, const float* __restrict__ scales, int nq,
    long long n, int d, long long chunk_rows, int kp, float* __restrict__ part_v,
    int* __restrict__ part_i) {
  __shared__ __align__(128) unsigned char stage[STAGE_BYTES];
  float* sc = reinterpret_cast<float*>(stage);
  // the running lists, QT x kp each, in dynamic shared memory
  extern __shared__ __align__(16) unsigned char lists[];
  float* rv = reinterpret_cast<float*>(lists);
  int* ri = reinterpret_cast<int*>(rv + QT * kp);
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QT;
  const long long c0 = (long long)blockIdx.y * chunk_rows;
  const long long c1 = c0 + chunk_rows < n ? c0 + chunk_rows : n;
  for (int i = tid; i < QT * kp; i += THREADS) {
    rv[i] = -INFINITY;
    ri[i] = INT_MAX;
  }
  __syncthreads();
  const int r = tid >> 2, part = tid & 3;  // epilogue: row r, 16 columns
  int filled = 0;  // entries in row r's list (kept by lane part 0)
  for (long long t0 = c0; t0 < c1; t0 += TN) {
    if constexpr (MODE == BF16 || MODE == INT8_DEQ)
      score_tile_wmma<MODE, TAIL>(static_cast<const __nv_bfloat16*>(q), store, nq, q0, t0, c1,
                                  d, sc, stage);
    else
      score_tile_simt<MODE, TAIL>(q, store, nq, q0, t0, c1, d, sc, stage);
    __syncthreads();
    // row r's list changes only below, in lane part 0 of these four lanes
    const float thr = rv[r * kp + kp - 1];
    unsigned int mask = 0;  // bit j: column part * 16 + j beats the row's kp-th
#pragma unroll 4
    for (int j = 0; j < TN / 4; ++j) {
      const int c = part * (TN / 4) + j;
      const long long col = t0 + c;
      float v = -INFINITY;
      if (col < c1 && q0 + r < nq) {
        v = sc[r * SC_LD + c];
        if (MODE == INT8_DEQ || MODE == INT8_MXU) v *= scales[col];
        if (sqn != nullptr) v = 2.0f * v - sqn[col];
      }
      sc[r * SC_LD + c] = v;
      // columns only grow along the chunk, so a candidate equal to the
      // kp-th score ranks below it: the test can be strict
      if (v > thr) mask |= 1u << j;
    }
    const int lane0 = (tid & 31) & ~3;
    unsigned long long row_mask = 0;
#pragma unroll
    for (int p = 0; p < 4; ++p)
      row_mask |= static_cast<unsigned long long>(__shfl_sync(0xffffffffu, mask, lane0 + p))
                  << (16 * p);
    __syncwarp();
    if (part == 0 && row_mask) {  // the row's candidates, in column order
      float* vals = rv + r * kp;
      int* ids = ri + r * kp;
      while (row_mask) {
        const int c = __ffsll(row_mask) - 1;
        row_mask &= row_mask - 1;
        topk_insert(vals, ids, kp, filled, sc[r * SC_LD + c], static_cast<int>(t0 + c));
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < QT * kp; i += THREADS) {
    const int row = i / kp;
    if (q0 + row < nq) {
      const size_t o = ((size_t)blockIdx.y * nq + q0 + row) * kp + i % kp;
      part_v[o] = rv[i];
      part_i[o] = ri[i];
    }
  }
}

// The TAIL variant when D is not a whole number of 64-deep steps or an
// operand is not 16-byte aligned. Past 48 KB of shared memory in all (the
// staging buffer and lists of kp > 60) a kernel needs the opt-in.
template <int MODE>
static cudaError_t launch_partial(dim3 grid, cudaStream_t s, const void* q, const void* store,
                                  const float* sq, const float* sl, int nq, long long n, int d,
                                  long long chunk_rows, int kp, float* pv, int* pi) {
  const bool tail = d % WKC != 0 ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(store)) & 15) != 0;
  auto kernel = tail ? dense_topk_partial_kernel<MODE, true>
                     : dense_topk_partial_kernel<MODE, false>;
  const size_t smem = (size_t)QT * kp * (sizeof(float) + sizeof(int));
  if (STAGE_BYTES + smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, THREADS, smem, s>>>(q, store, sq, sl, nq, n, d, chunk_rows, kp, pv, pi);
  return cudaGetLastError();
}

// queries [nq, d] (bf16 for modes 0-1, f32 for 2, int8 for 3); store
// [>= n, d]; sqn [>= n] f32 or null (ip); scales [>= n] f32 (int8 modes);
// kp <= MAX_KP; nchunks <= 32 * MERGE_LISTS. part_v/part_i: [nchunks, nq,
// kp] scratch; out: [nq, k_out].
extern "C" int dense_topk(const void* q, const void* store, const void* sqn,
                          const void* scales, int mode, int nq, long long n, int d,
                          long long chunk_rows, int nchunks, int kp, int k_out,
                          void* part_v, void* part_i, void* out_v, void* out_i,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kp < 1 || kp > MAX_KP || k_out > kp || nchunks < 1 || nchunks > 32 * MERGE_LISTS)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((nq + QT - 1) / QT, nchunks);
  const float* sq = static_cast<const float*>(sqn);
  const float* sl = static_cast<const float*>(scales);
  float* pv = static_cast<float*>(part_v);
  int* pi = static_cast<int*>(part_i);
  cudaError_t err;
  switch (mode) {
    case BF16:
      err = launch_partial<BF16>(grid, s, q, store, sq, sl, nq, n, d, chunk_rows, kp, pv, pi);
      break;
    case INT8_DEQ:
      err = launch_partial<INT8_DEQ>(grid, s, q, store, sq, sl, nq, n, d, chunk_rows, kp, pv, pi);
      break;
    case F32:
      err = launch_partial<F32>(grid, s, q, store, sq, sl, nq, n, d, chunk_rows, kp, pv, pi);
      break;
    case INT8_MXU:
      err = launch_partial<INT8_MXU>(grid, s, q, store, sq, sl, nq, n, d, chunk_rows, kp, pv, pi);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_merge_partial_topk(
      pv, pi, nchunks, nq, kp, k_out, static_cast<float*>(out_v), static_cast<int*>(out_i), s));
}
