// Flat dense search: Q x N scores with a running top-k per query, the
// [Q, N] score matrix never written to device memory.
//
// Replaces probing_rag_tpu/ops/pallas_dense.py::_kernel (dense_topk_pallas,
// with topk_merge_tile_nocarry). The TPU kernel walks N in order inside one
// query block and carries the running top-k in VMEM scratch across grid
// steps. Here N is split across thread blocks: block (x, y) scores query
// tile x against store chunk y, keeps a running top-kp per query in shared
// memory and writes it as a partial list; a second small pass
// (topk_merge.cuh) merges the partial lists of each query.
// ops/dense.py::plan_dense picks one of two regimes and all of its sizes.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16): at the service shape,
// 256 queries x 500,000 x 768 bf16, the store read is 768 MB (0.229 ms)
// and the work 197 GFLOP (0.199 ms), just under the ridge (256 flop per
// store byte against ~295); at the probing loop's 8 x 100,000 x 768 the
// 154 MB read (0.046 ms) is all, 8 flop a byte. So the design streams the
// store once at the memory rate and keeps the tensor cores' work per byte
// proportional to the real query count.
//
// wgmma (bf16 stores; int8 stores with bf16 queries; int8 x int8): the
// roles of the staged design are swapped. Store rows are wgmma's M (64 rows
// per consumer warpgroup, two warpgroups: 128 rows a step) and the query
// tile is N, the smallest multiple of 8 >= the tile's queries (a product
// of width N is one wgmma per set bit of N / 8, so no MMA column is
// padding past the next multiple of 8; the staged design pads every tile
// to 64 queries). Widths stop at 128: on the H100, 256 queries ran faster
// as two tiles of 128 than as one of 256 (whose query tile streamed
// through L2 at three times the store's bytes, and whose 128 keys a
// thread spilled). Both operands are K-major as they lie in memory.
// One producer thread keeps TMA loads of [128 rows, 64-deep] store boxes
// (128 deep for int8 x int8), 1 or 2 boxes a stage, in flight in a ring of
// 3-6 stages on mbarriers; the tensor map over [n, D] zero-fills the
// ragged row and depth edges. The query tile stays resident in shared
// memory where it fits (written once by the consumers while the first
// loads fly), else it is streamed in each stage beside the store box (read
// from L2). bf16: wgmma bf16 x bf16 from shared memory, f32 sums. int8
// store with bf16 queries: the int8 box arrives at one byte per element
// and each consumer widens its 16 bytes of a row straight into wgmma's A
// registers (exact for |v| <= 127); the depth order inside a 64-deep box
// is permuted so that those 16 bytes are one shared-memory load, and the
// resident query tile is written in the same permutation, so the sum is
// unchanged. No bf16 copy of the store exists. int8 x int8: wgmma s8 x s8
// with s32 sums, exact, so equal to the plain version's bits. The
// epilogue works from registers: each sum becomes its key (x row scale,
// then 2 v - |d|^2 by one fma, -inf past n; the sums are zeroed at each
// step and the keys kept apart, or ptxas serializes the products), which
// is compared with its query's current kp-th score read from shared
// memory; only keys at or above it are appended to a per-query candidate
// buffer (shared-memory counters). Up to width 32, and for lists longer
// than 32, a warp per query inserts them (warp_insert: 32 at a time by a
// bitonic sort and merge while they are many); above it a thread per query
// does, its list in registers (lane_insert), the lists interleaved across
// the threads' banks. When a buffer overflows (a chunk's first steps make
// every row a candidate), the leftovers are offered again after the
// insertions. The producer keeps the ring full during the epilogue. Old
// limits, and what became of them: 64-query padding (now N = 8 at 8
// queries), WMMA mma.sync (now wgmma), staging through registers with two
// barriers per step (now a TMA ring), the epilogue's round trip through a
// shared-memory score tile (now from registers), int8 widened element by
// element in shared memory and int8 x int8 on dp4a (now widened into
// registers, and s8 wgmma). The wgmma instantiations, one per mode and
// width, build in 6 parallel parts of this file.
//
// staged (f32 stores, such as the IVF coarse quantizer, held to exact f32
// FMAs because TF32 would change which cells are probed; pitches TMA cannot
// describe, D * element size not a multiple of 16 bytes, or bases not
// 16-byte aligned): the first design of this kernel. 64 queries and 64
// rows per tile, operands staged through registers into shared memory;
// WMMA bf16 for bf16 and int8-dequantized stores, f32 FMAs for f32, dp4a
// for int8 x int8; the epilogue marks, four threads to a row, the columns
// that beat the row's kp-th score and one thread inserts those. A TAIL
// instantiation stages depth past D as zeros.
//
// Running lists take N x kp entries of shared memory, so kp runs up to
// MAX_KP (256: the coarse quantizer's nprobe), the planner narrowing the
// query tile to fit. Ranking: score descending, then column ascending. l2
// ranks by 2 q.d - |d|^2 (the caller adds |q|^2 back). Columns at or past n
// score -inf and never enter a list; empty slots come out as (-inf, -1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "topk_merge.cuh"

// nvcc-parts: 6
// The build compiles this file once per part, with NVCC_PART = 0 .. 5 and
// NVCC_PARTS = 6 (kernels/__init__.py reads the line above), so that the
// wgmma instantiations (one per mode and width) compile in parallel. Part
// 0 also holds the staged kernels and the C entry.
#ifndef NVCC_PART
#define NVCC_PART 0
#define NVCC_PARTS 1
#endif

using namespace nvcuda;

#define QT 64       // queries per block
#define TN 64       // store rows per tile
#define THREADS 256
#define SC_LD (TN + 4)  // score tile row stride (floats)

enum Mode { BF16 = 0, INT8_DEQ = 1, F32 = 2, INT8_MXU = 3 };
enum Regime { STAGED = 0, WGMMA = 1 };

// ================================================================ staged

#if NVCC_PART == 0

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
// operand is not 16-byte aligned. bf16 and int8 stores come here only with
// a pitch TMA cannot describe or an unaligned operand (ops/dense.py::
// plan_dense), so only f32 has the other variant. Past 48 KB of shared
// memory in all (the staging buffer and lists of kp > 60) a kernel needs
// the opt-in.
template <int MODE>
static cudaError_t launch_partial(dim3 grid, cudaStream_t s, const void* q, const void* store,
                                  const float* sq, const float* sl, int nq, long long n, int d,
                                  long long chunk_rows, int kp, float* pv, int* pi) {
  auto kernel = dense_topk_partial_kernel<MODE, true>;
  if constexpr (MODE == F32) {
    if (d % WKC == 0 &&
        ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(store)) & 15) == 0)
      kernel = dense_topk_partial_kernel<MODE, false>;
  }
  const size_t smem = (size_t)QT * kp * (sizeof(float) + sizeof(int));
  if (STAGE_BYTES + smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, THREADS, smem, s>>>(q, store, sq, sl, nq, n, d, chunk_rows, kp, pv, pi);
  return cudaGetLastError();
}

#endif  // NVCC_PART == 0

// ================================================================ wgmma

namespace dw {

constexpr int ROWS = 128;           // store rows a step: two consumer warpgroups of 64
constexpr int THREADS_ALL = 384;    // consumers (warps 0-7), producer warpgroup (8-11)
constexpr int CONSUMERS = 256;
// setmaxnreg moves registers only within the block: the 384 x 168 it was
// launched with, so 2 x (CONSUMER - 168) <= 168 - PRODUCER
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;

// Dynamic shared memory of one block, offsets from its 1024-aligned base:
// the ring (stages of `boxes` store boxes, then as many boxes of the
// streamed query tile), the resident query tile, the running lists, each
// query's kp-th score, the candidate counters and buffers, the ring's
// barriers. A box is 128 rows x 128 bytes of depth (64 bytes for int8
// stores with bf16 queries). ops/dense.py::_wgmma_smem computes the same
// bytes.
struct Layout {
  int kbox, nbox, steps;   // depth of a box (elements), boxes of d, ring steps of a row step
  int a_box, b_box;        // bytes of a store box, of a streamed query box (0 when resident)
  int stage, queries, lists, thr, cnt, buf, bars, bytes;
};

__host__ __device__ inline Layout layout(int mode, int ntile, int kp, int d, int stages,
                                         int boxes, int cap, int resident) {
  Layout L;
  L.kbox = mode == INT8_MXU ? 128 : 64;
  L.nbox = (d + L.kbox - 1) / L.kbox;
  L.steps = (L.nbox + boxes - 1) / boxes;
  L.a_box = ROWS * (mode == INT8_DEQ ? 64 : 128);
  L.b_box = resident ? 0 : ntile * 128;
  L.stage = boxes * (L.a_box + L.b_box);
  L.queries = stages * L.stage;
  L.lists = L.queries + (resident ? L.nbox * ntile * 128 : 0);
  L.thr = L.lists + ntile * kp * 8;
  L.cnt = L.thr + ntile * 4;
  L.buf = L.cnt + ntile * 4;
  L.bars = L.buf + ntile * cap * 8;
  L.bytes = L.bars + 2 * stages * 8 + 1024;  // room to align the base to 1024
  return L;
}

// Block (x, y): queries [x * qt, + qt) against store rows [y * chunk_rows,
// + chunk_rows). Every role walks the same ring steps g (row steps x
// L.steps): stage g % stages, with the parity of g / stages as the phase
// of its barriers. A ring step holds `boxes` boxes of depth (fewer at the
// end of d).
template <int MODE, int N>
__global__ void __launch_bounds__(dw::THREADS_ALL, 1)
dense_wgmma_kernel(const __grid_constant__ CUtensorMap smap,
                   const __grid_constant__ CUtensorMap qmap, const void* __restrict__ q,
                   const float* __restrict__ sqn, const float* __restrict__ scales, int nq,
                   int qt, long long n, int d, long long chunk_rows, int kp, int stages,
                   int boxes, int cap, int resident, float* __restrict__ part_v,
                   int* __restrict__ part_i) {
  using namespace hop;
  using Acc = typename std::conditional<MODE == INT8_MXU, int, float>::type;
  const Layout L = layout(MODE, N, kp, d, stages, boxes, cap, resident);
  extern __shared__ uint8_t smem_raw[];
  // the base aligned to 1024 by an offset from smem_raw, so that the
  // compiler knows every pointer below is shared memory
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + L.bars;      // TMA landed in a stage
  const uint32_t empty = full + 8 * stages;  // stage read by the 8 consumer warps
  float* rv = reinterpret_cast<float*>(smem + L.lists);
  int* ri = reinterpret_cast<int*>(rv + N * kp);
  float* thr = reinterpret_cast<float*>(smem + L.thr);
  int* cnt = reinterpret_cast<int*>(smem + L.cnt);
  // (key bits, column): candidate slot j of column c at buf[j * N + c]
  int2* buf = reinterpret_cast<int2*>(smem + L.buf);
  // Candidates are inserted by a warp per query (warp_insert) up to width
  // 32 and for lists longer than lane_insert keeps in registers, else by a
  // thread per query (lane_insert). Entry p of column c's list lies at
  // rv[c * kp + p] where a warp inserts (its lanes read along a list),
  // rv[p * N + c] where a thread does (neighbouring threads on
  // neighbouring banks).
  const bool warp_insert_path = N <= 32 || kp > 32;
  const int lc = warp_insert_path ? kp : 1, lp = warp_insert_path ? 1 : N;
  const int q0 = blockIdx.x * qt;
  const int nqt = min(qt, nq - q0);
  const long long c0 = (long long)blockIdx.y * chunk_rows;
  const long long c1 = c0 + chunk_rows < n ? c0 + chunk_rows : n;
  const int steps = static_cast<int>((c1 - c0 + ROWS - 1) / ROWS);
  const long long total = (long long)steps * L.steps;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup: its first thread issues the TMA loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (tid == CONSUMERS) {
      for (long long g = 0; g < total; ++g) {
        const int st = static_cast<int>(g / L.steps), k0 = static_cast<int>(g % L.steps) * boxes;
        const int nb = min(boxes, L.nbox - k0);  // boxes of this step inside d
        const int s = static_cast<int>(g % stages);
        mbar_wait(empty + 8 * s, ((g / stages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, nb * (L.a_box + L.b_box));
        const uint32_t dst = base + s * L.stage;
        for (int b = 0; b < nb; ++b) {
          const int x = (k0 + b) * L.kbox;
          tma_load_2d(dst + b * L.a_box, &smap, full + 8 * s, x, static_cast<int>(c0) + st * ROWS);
          if (!resident)
            tma_load_2d(dst + boxes * L.a_box + b * L.b_box, &qmap, full + 8 * s, x, q0);
        }
      }
    }
    return;
  }

  // two consumer warpgroups: rows [64 wg, + 64) of each step
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  for (int i = tid; i < N * kp; i += CONSUMERS) {
    rv[i] = -INFINITY;
    ri[i] = INT_MAX;
  }
  for (int i = tid; i < N; i += CONSUMERS) {
    thr[i] = i < nqt ? -INFINITY : INFINITY;  // columns past the queries never insert
    cnt[i] = 0;
  }
  if (resident) {
    const int rb = MODE == INT8_MXU ? d : 2 * d;
    fill_b_tile<MODE == INT8_DEQ>(static_cast<const uint8_t*>(q) + (size_t)q0 * rb, rb, nqt, N,
                                  L.nbox, smem + L.queries, tid, CONSUMERS);
  }
  fence_proxy_async();
  bar_sync(1, CONSUMERS);

  const int wg = warp >> 2, wq = warp & 3;
  const int frag_row = wg * 64 + wq * 16 + (lane >> 2);  // and + 8
  const int cq = 2 * (lane & 3);  // this lane's first column of each 8
  constexpr int PW = (N / 2 + 31) / 32;  // words of candidate flags
  Acc acc[N / 2];
  long long g = 0;
  for (int st = 0; st < steps; ++st) {
    const long long r0 = c0 + (long long)st * ROWS;
    long long row[2];
    bool ok[2];
    float scl[2] = {1.0f, 1.0f}, sq[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row[h] = r0 + frag_row + 8 * h;
      ok[h] = row[h] < c1;
      if (ok[h]) {
        if (MODE != BF16) scl[h] = __ldg(scales + row[h]);
        if (sqn != nullptr) sq[h] = __ldg(sqn + row[h]);
      }
    }
    // the sums start at zero in every step and the epilogue writes its
    // keys elsewhere, so nothing keeps the sums alive through it (else
    // ptxas serializes the products)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      acc[i] = 0;
      if constexpr (MODE == INT8_MXU) asm volatile("" : "+r"(acc[i])::"memory");
      else asm volatile("" : "+f"(acc[i])::"memory");
    }
    for (int ks = 0; ks < L.steps; ++ks, ++g) {
      const int s = static_cast<int>(g % stages);
      const int k0 = ks * boxes, nb = min(boxes, L.nbox - k0);
      mbar_wait(full + 8 * s, (g / stages) & 1);
      const uint32_t st_base = base + s * L.stage;
      for (int b = 0; b < nb; ++b) {
        const uint32_t bq = resident ? base + L.queries + (k0 + b) * N * 128
                                     : st_base + boxes * L.a_box + b * L.b_box;
        if constexpr (MODE == INT8_DEQ) {
          uint32_t a[4][4];
          int8_a_fragments(smem + s * L.stage + b * L.a_box + frag_row * 64 + 16 * (lane & 3), a);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            mma_bf16_rs<N>(acc, a[kk], desc_sw128(bq + kk * 32), 1);
          wgmma_commit();
          // the A registers are rewritten next box: let these products finish
          wgmma_wait<0>();
        } else {
          const uint32_t aq = st_base + b * L.a_box + wg * 64 * 128;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            if constexpr (MODE == INT8_MXU)
              mma_s8_ss<N>(acc, desc_sw128(aq + kk * 32), desc_sw128(bq + kk * 32), 1);
            else
              mma_bf16_ss<N>(acc, desc_sw128(aq + kk * 32), desc_sw128(bq + kk * 32), 1);
          }
          wgmma_commit();
        }
      }
      if constexpr (MODE != INT8_DEQ) {
        // keep this stage's products in flight; the previous stage's are done
        wgmma_wait<1>();
        if (ks > 0 && lane == 0) mbar_arrive(empty + 8 * static_cast<int>((g - 1) % stages));
      } else if (lane == 0) {
        mbar_arrive(empty + 8 * s);
      }
    }
    if constexpr (MODE != INT8_DEQ) {
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty + 8 * static_cast<int>((g - 1) % stages));
    }
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      if constexpr (MODE == INT8_MXU) asm volatile("" : "+r"(acc[i])::"memory");
      else asm volatile("" : "+f"(acc[i])::"memory");
    }

    // epilogue: acc[4 j + 2 h + c] is column 8 j + cq + c of row[h]; its key,
    // once
    const float two = sqn != nullptr ? 2.0f : 1.0f;  // l2: 2 v - |d|^2, exact as 2 v is
    float key[N / 2];
    uint32_t pend[PW];
#pragma unroll
    for (int w = 0; w < PW; ++w) pend[w] = 0;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int h = (i >> 1) & 1;
      float v = static_cast<float>(acc[i]);
      if (MODE != BF16) v *= scl[h];
      key[i] = fmaf(two, v, -sq[h]);
      pend[i / 32] |= static_cast<uint32_t>(ok[h]) << (i % 32);
    }
    while (true) {
      // test against the kp-th score: loads only, so they overlap; then
      // append the keys at or above it (a key equal to it may still rank
      // above it by column: the insertion decides)
      uint32_t hit[PW];
#pragma unroll
      for (int w = 0; w < PW; ++w) hit[w] = 0;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const float2 t = *reinterpret_cast<const float2*>(thr + 8 * j + cq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e, c = e & 1, h = e >> 1;
          hit[i / 32] |= static_cast<uint32_t>(key[i] >= (c ? t.y : t.x)) << (i % 32);
        }
      }
#pragma unroll
      for (int w = 0; w < PW; ++w) {  // the rest cannot enter
        hit[w] &= pend[w];
        pend[w] = hit[w];
      }
      // appends: only the keys some lane of the warp has a hit for are
      // visited (a warp-uniform test), each lane's append predicated
#pragma unroll
      for (int w = 0; w < PW; ++w) {
        const uint32_t any = __reduce_or_sync(0xffffffffu, hit[w]);
#pragma unroll
        for (int k = 0; k < 32 && 32 * w + k < N / 2; ++k) {
          if (!((any >> k) & 1u)) continue;
          const int i = 32 * w + k, col = 8 * (i >> 2) + cq + (i & 1);
          const int slot = (hit[w] >> k) & 1u ? atomicAdd(cnt + col, 1) : cap;
          if (slot < cap) {  // else offered again after the insertions
            buf[slot * N + col] = make_int2(__float_as_int(key[i]), static_cast<int>(row[(i >> 1) & 1]));
            pend[w] &= ~(1u << k);
          }
        }
      }
      bar_sync(1, CONSUMERS);
      if (warp_insert_path) {  // a warp per query
        for (int c = warp; c < N; c += CONSUMERS / 32) {
          const int m = min(cnt[c], cap);
          if (m > 0) {
            float lv;
            int li;
            warp_insert(rv + c * kp, ri + c * kp, kp, buf + c, N, m, lane, lv, li);
            if (lane == 0) thr[c] = lv;
          }
          __syncwarp();
          if (lane == 0) cnt[c] = 0;
        }
      } else if (warp * 32 < N) {  // a thread per query, the warp in step
        // lanes past the last column walk column N-1's list in step and
        // leave it to its own lane
        const bool own = tid < N;
        const int c = min(tid, N - 1);
        const int m = own ? min(cnt[c], cap) : 0;
        float* vals = rv + c;
        int* ids = ri + c;
        const float last = kp <= 16 ? lane_insert<16>(vals, ids, kp, N, buf + c, m, own)
                                    : lane_insert<32>(vals, ids, kp, N, buf + c, m, own);
        if (own) {
          cnt[c] = 0;
          if (tid < nqt) thr[c] = last;
        }
      }
      bool left = false;
#pragma unroll
      for (int w = 0; w < PW; ++w) left |= pend[w] != 0;
      if (!bar_any(2, CONSUMERS, left)) break;
    }
  }
  for (int i = tid; i < nqt * kp; i += CONSUMERS) {
    const size_t o = ((size_t)blockIdx.y * nq + q0) * kp + i;
    const int e = (i / kp) * lc + (i % kp) * lp;
    part_v[o] = rv[e];
    part_i[o] = ri[e];
  }
}

template <int MODE, int N>
cudaError_t launch_n(const CUtensorMap& smap, const CUtensorMap& qmap, dim3 grid, int smem,
                     cudaStream_t s, const void* q, const float* sq, const float* sl, int nq,
                     int qt, long long n, int d, long long chunk_rows, int kp, int stages,
                     int boxes, int cap, int resident, float* pv, int* pi) {
  auto kernel = dense_wgmma_kernel<MODE, N>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS_ALL, smem, s>>>(smap, qmap, q, sq, sl, nq, qt, n, d, chunk_rows, kp,
                                         stages, boxes, cap, resident, pv, pi);
  return cudaGetLastError();
}

typedef cudaError_t (*Launcher)(const CUtensorMap&, const CUtensorMap&, dim3, int, cudaStream_t,
                                const void*, const float*, const float*, int, int, long long,
                                int, long long, int, int, int, int, int, float*, int*);

// widths 8 .. 128 (at 256 the streamed query tile, the spills and the
// epilogue of 128 keys a thread cost more than a second pass over the
// store: ops/dense.py WGMMA_MAX_N)
__host__ __device__ constexpr int max_width(int) { return 128; }
constexpr int mode_slot(int mode) { return mode == BF16 ? 0 : (mode == INT8_DEQ ? 1 : 2); }

// The launcher of width 8 j in launchers[mode_slot(mode)][j], filled when
// the library loads by the part that compiled it.
extern Launcher launchers[3][128 / 8 + 1];

template <int MODE, int N = 8>
bool register_widths() {
  if constexpr (N <= max_width(MODE)) {
    if constexpr ((N / 8 + MODE) % NVCC_PARTS == NVCC_PART)
      launchers[mode_slot(MODE)][N / 8] = &launch_n<MODE, N>;
    return register_widths<MODE, N + 8>();
  }
  return true;
}

[[maybe_unused]] static const bool registered =
    register_widths<BF16>() && register_widths<INT8_DEQ>() && register_widths<INT8_MXU>();

#if NVCC_PART == 0
Launcher launchers[3][128 / 8 + 1];

cudaError_t launch(int mode, dim3 grid, int smem, cudaStream_t s, const void* q,
                   const void* store, const float* sq, const float* sl, int nq, int qt,
                   int ntile, long long n, int d, long long chunk_rows, int kp, int stages,
                   int boxes, int cap, int resident, float* pv, int* pi) {
  if (ntile < 8 || ntile > max_width(mode) || ntile % 8 != 0) return cudaErrorInvalidValue;
  const Launcher f = launchers[mode_slot(mode)][ntile / 8];
  if (f == nullptr) return cudaErrorInvalidValue;
  CUtensorMap smap, qmap;
  bool ok;
  if (mode == BF16)
    ok = hop::tensor_map(&smap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, store, n, d, ROWS, 64,
                         CU_TENSOR_MAP_SWIZZLE_128B);
  else if (mode == INT8_DEQ)
    ok = hop::tensor_map(&smap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, store, n, d, ROWS, 64,
                         CU_TENSOR_MAP_SWIZZLE_NONE);
  else
    ok = hop::tensor_map(&smap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, store, n, d, ROWS, 128,
                         CU_TENSOR_MAP_SWIZZLE_128B);
  if (!ok) return cudaErrorInvalidValue;
  qmap = smap;  // unused when the query tile is resident
  if (!resident) {
    ok = mode == INT8_MXU
             ? hop::tensor_map(&qmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, nq, d, ntile, 128,
                               CU_TENSOR_MAP_SWIZZLE_128B)
             : hop::tensor_map(&qmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q, nq, d, ntile, 64,
                               CU_TENSOR_MAP_SWIZZLE_128B);
    if (!ok) return cudaErrorInvalidValue;
  }
  return f(smap, qmap, grid, smem, s, q, sq, sl, nq, qt, n, d, chunk_rows, kp, stages, boxes,
           cap, resident, pv, pi);
}
#endif  // NVCC_PART == 0

}  // namespace dw

#if NVCC_PART == 0
// queries [nq, d] (bf16 for modes 0-1, f32 for 2, int8 for 3); store
// [>= n, d]; sqn [>= n] f32 or null (ip); scales [>= n] f32 (int8 modes).
// regime STAGED: qt must be QT, the other plan fields are unused. regime
// WGMMA: query tiles of qt queries (grid x), ntile the product width (a
// multiple of 8 >= qt, at most dw::max_width), a ring of `stages` of `boxes`
// boxes, candidate buffers of `cap` per query, the query tile resident or
// streamed; smem must be
// the layout's bytes (the planner's and the kernel's computations agree).
// Both: nchunks chunks of chunk_rows rows (grid y, <= 32 * MERGE_LISTS),
// lists of kp <= MAX_KP. part_v/part_i: [nchunks, nq, kp] scratch; out:
// [nq, kp].
extern "C" int dense_topk(const void* q, const void* store, const void* sqn,
                          const void* scales, int mode, int regime, int nq, long long n, int d,
                          int qt, int ntile, long long chunk_rows, int nchunks, int kp,
                          int stages, int boxes, int cap, int resident, int smem,
                          void* part_v, void* part_i, void* out_v, void* out_i,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kp < 1 || kp > MAX_KP || nchunks < 1 || nchunks > 32 * MERGE_LISTS ||
      qt < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* sq = static_cast<const float*>(sqn);
  const float* sl = static_cast<const float*>(scales);
  float* pv = static_cast<float*>(part_v);
  int* pi = static_cast<int*>(part_i);
  cudaError_t err;
  if (regime == WGMMA) {
    if (mode == F32 || ntile < qt || stages < 1 || boxes < 1 || cap < 1 ||
        (mode == INT8_DEQ && !resident) ||
        dw::layout(mode, ntile, kp, d, stages, boxes, cap, resident).bytes != smem)
      return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid((nq + qt - 1) / qt, nchunks);
    err = dw::launch(mode, grid, smem, s, q, store, sq, sl, nq, qt, ntile, n, d, chunk_rows, kp,
                     stages, boxes, cap, resident, pv, pi);
  } else if (regime == STAGED && qt == QT) {
    dim3 grid((nq + QT - 1) / QT, nchunks);
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
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_merge_partial_topk(
      pv, pi, nchunks, nq, kp, kp, static_cast<float*>(out_v), static_cast<int*>(out_i), s));
}
#endif  // NVCC_PART == 0
