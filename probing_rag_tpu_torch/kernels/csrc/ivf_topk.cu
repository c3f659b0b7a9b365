// IVF probed search: for each 8-query tile, score the store blocks its
// descriptors name and keep a running top-k of document ids per query.
//
// Replaces probing_rag_tpu/ops/pallas_ivf.py::_kernel (ivf_topk_pallas).
// The TPU kernel walks one tile's descriptor list in order on one core,
// with the descriptors brought ahead by scalar prefetch and the running
// top-k carried in VMEM scratch. Here the work of a tile is split over
// thread blocks, each keeps running lists in shared memory and writes them
// as partial lists, and the second pass of topk_merge.cuh merges them.
// ops/ivf.py::plan_ivf picks one of two regimes and all of its sizes.
//
// Bound on the H100: a probed row is scored by only 8 queries, 8 flop per
// bf16 byte against a ridge near 295, so the kernel is bound by bytes: at
// bench_ivf.py's Q 64 over 1M x 768, nprobe 32, the ~1.03 GB of probed
// rows take 0.309 ms at 3.35 TB/s; at the loop's Q 8, ~125 MB, 0.037 ms,
// where filling all 132 SMs with one tile is the whole problem.
//
// wgmma (bf16 and int8 stores with a pitch TMA can describe): the staged
// kernel scored on f32 FMAs over rows widened to f32 in shared memory
// (shared-memory bandwidth, not HBM, set its pace), 32 rows a step with
// two barriers, and split a tile over blocks only by descriptor. Now a work
// item is one 64-row piece of one descriptor's block, and the blocks of a
// tile take even contiguous ranges of items, so one 8-query tile fills the
// card.
// A block runs two independent pipelines: a consumer warpgroup and the
// producer warp that serves it. The producer reads the tile's descriptors
// itself (the analogue of scalar prefetch), skips holes, and keeps TMA
// loads of [64 rows, 64-deep] tiles in flight in a ring of 3-6 stages,
// across descriptor boundaries. The consumer scores each piece with wgmma
// m64n8k16: rows on M, the tile's 8 queries on N, f32 sums. wgmma rather
// than mma.sync because the kernel is bound by bytes either way and the
// dense kernel's ring and fragments carry over. The 8-query tile stays in
// shared memory (12 KB at D 768). An int8 tile arrives at one byte per
// element and is widened exactly into the A registers (the depth order
// permuted as in dense_topk.cu); its per-row scale is applied in the
// epilogue. The epilogue reads ids, |d|^2 and scales per row, masks rows
// past the block (a 64-row box of a 48-row block reaches into the next
// block) and pad rows, tests each key against its query's running k-th
// entry and appends only the ones that beat it; a warp per query inserts
// them (warp_insert). Each pipeline writes its own partial list.
//
// staged (f32 stores; pitches TMA cannot describe, D * element size not a
// multiple of 16 bytes, or unaligned bases): the first design of this
// kernel. Block (t, s) walks the s-th slice of tile t's descriptor list,
// one (query, row) f32 dot product per thread over rows widened to f32 in
// shared memory; a TAIL instantiation stages depth past D and rows past a
// block as zeros.
//
// In both, descriptors that name the all-pad block are skipped without
// reading it (it can insert nothing), and so are descriptors outside the
// store, which the planner never makes (checking them on the host would
// cost a sync per search). Rows with id < 0 (cell padding) score -inf and
// never insert. Ranking: score descending, then document id ascending; l2
// ranks by 2 q.d - |d|^2. Empty slots come out as (-inf, -1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"
#include "topk_merge.cuh"

#define QTILE 8     // queries per tile
#define RT 32       // store rows per step
#define KC 64       // depth per step
#define LD (KC + 4) // staged row stride (floats), keeps float4 reads aligned
#define THREADS 256 // QTILE x RT: one (query, row) score per thread

enum Mode { BF16 = 0, INT8 = 1, F32 = 2 };
enum Regime { STAGED = 0, WGMMA = 1 };

// ================================================================ staged

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

// ================================================================ wgmma

namespace iw {

constexpr int PIECE = 64;          // rows of a work item: one warpgroup's M
constexpr int THREADS_ALL = 384;   // consumer warpgroups 0 and 1, producer warps 8 and 9

// Dynamic shared memory, offsets from the 1024-aligned base: the resident
// query tile, then per pipeline its ring, lists, k-th entries, candidate
// counters and buffers (a piece can add at most PIECE per query) and
// barriers. ops/ivf.py::_wgmma_smem computes the same bytes.
struct Layout {
  int chunks, a_bytes, pipe0, pipe_bytes;
  int lists, thr_v, thr_i, cnt, buf, bars;  // offsets inside a pipeline's region
  int bytes;
};

__host__ __device__ inline Layout layout(int mode, int d, int stages) {
  Layout L;
  L.chunks = (d + 63) / 64;
  L.a_bytes = PIECE * (mode == INT8 ? 64 : 128);
  L.pipe0 = L.chunks * QTILE * 128;
  L.lists = stages * L.a_bytes;
  L.thr_v = L.lists + QTILE * TOPK_MAX * 8;
  L.thr_i = L.thr_v + QTILE * 4;
  L.cnt = L.thr_i + QTILE * 4;
  L.buf = L.cnt + QTILE * 4 + 32;  // 16-byte aligned
  L.bars = L.buf + QTILE * PIECE * 8;
  L.pipe_bytes = (L.bars + 2 * stages * 8 + 1023) / 1024 * 1024;
  L.bytes = L.pipe0 + 2 * L.pipe_bytes + 1024;  // room to align the base to 1024
  return L;
}

// Block (t, y) of nsplit takes items [y * items / nsplit, (y + 1) * items /
// nsplit) of tile t's items = pb * pieces, item i = row piece i % pieces of
// descriptor i / pieces; pipeline w takes the
// items of that range with i % 2 == w. Producer and consumer of a pipeline
// walk the same items, skip the same holes, and count the same steps g
// (items x k-steps): stage g % stages, with the parity of g / stages as
// the phase of its barriers.
template <int MODE>
__global__ void __launch_bounds__(iw::THREADS_ALL, 1)
ivf_wgmma_kernel(const __grid_constant__ CUtensorMap smap, const __nv_bfloat16* __restrict__ q,
                 const int* __restrict__ desc, const int* __restrict__ ids,
                 const float* __restrict__ sqn, const float* __restrict__ scales, int nt,
                 int pb, int pieces, int block, int d, int pad_block, int stages,
                 float* __restrict__ part_v, int* __restrict__ part_i) {
  using namespace hop;
  const Layout L = layout(MODE, d, stages);
  extern __shared__ uint8_t smem_raw[];
  // the base aligned to 1024 by an offset from smem_raw, so that the
  // compiler knows every pointer below is shared memory
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t = blockIdx.x;
  const int w = warp >= 8 ? warp - 8 : warp >> 2;  // this thread's pipeline
  uint8_t* pipe = smem + L.pipe0 + w * L.pipe_bytes;
  const uint32_t pbase = smem_u32(pipe);
  const uint32_t full = pbase + L.bars, empty = full + 8 * stages;
  float* rv = reinterpret_cast<float*>(pipe + L.lists);
  int* ri = reinterpret_cast<int*>(rv + QTILE * TOPK_MAX);
  float* thr_v = reinterpret_cast<float*>(pipe + L.thr_v);
  int* thr_i = reinterpret_cast<int*>(pipe + L.thr_i);
  int* cnt = reinterpret_cast<int*>(pipe + L.cnt);
  int2* buf = reinterpret_cast<int2*>(pipe + L.buf);  // slot j of query c at buf[j * QTILE + c]
  const int items = pb * pieces;
  const int i0 = static_cast<int>((long long)blockIdx.y * items / gridDim.y);
  const int i1 = static_cast<int>((long long)(blockIdx.y + 1) * items / gridDim.y);
  const int* dt = desc + (size_t)t * pb;

  if (tid < 2 * 128) {
    const int wt = tid & 127;
    if (wt == 0) {
      for (int i = 0; i < stages; ++i) {
        mbar_init(full + 8 * i, 1);
        mbar_init(empty + 8 * i, 4);  // the pipeline's 4 consumer warps
      }
      fence_barrier_init();
    }
    if (wt < QTILE * TOPK_MAX) {
      rv[wt] = -INFINITY;
      ri[wt] = INT_MAX;
    }
    if (wt < QTILE) {
      thr_v[wt] = -INFINITY;
      thr_i[wt] = INT_MAX;
      cnt[wt] = 0;
    }
    fill_b_tile<MODE == INT8>(reinterpret_cast<const uint8_t*>(q + (size_t)t * QTILE * d), 2 * d,
                              QTILE, QTILE, L.chunks, smem, tid, 256);
    fence_proxy_async();
  }
  __syncthreads();

  if (warp >= 8) {  // producer warps 8 and 9: lane 0 serves pipeline w
    if (warp < 10 && lane == 0) {
      long long g = 0;
      for (int i = i0 + w; i < i1; i += 2) {
        const int b = __ldg(dt + i / pieces);
        if (b < 0 || b >= pad_block) continue;  // a hole
        const int row0 = b * block + (i % pieces) * PIECE;
        for (int ch = 0; ch < L.chunks; ++ch, ++g) {
          const int s = static_cast<int>(g % stages);
          mbar_wait(empty + 8 * s, ((g / stages) & 1) ^ 1);
          mbar_expect_tx(full + 8 * s, L.a_bytes);
          tma_load_2d(pbase + s * L.a_bytes, &smap, full + 8 * s, ch * 64, row0);
        }
      }
    }
    return;
  }

  const int wq = warp & 3, wt = tid & 127;
  const int frag_row = wq * 16 + (lane >> 2);  // and + 8
  const int cq = 2 * (lane & 3);  // this lane's two queries
  const uint32_t qb = smem_u32(smem);
  const float two = sqn != nullptr ? 2.0f : 1.0f;
  float acc[4];
  long long g = 0;
  for (int i = i0 + w; i < i1; i += 2) {
    const int b = __ldg(dt + i / pieces);
    if (b < 0 || b >= pad_block) continue;
    const int p0 = (i % pieces) * PIECE;
    const size_t row0 = (size_t)b * block + p0;
    int id[2];
    float scl[2] = {1.0f, 1.0f}, sq[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = frag_row + 8 * h;
      id[h] = p0 + r < block ? __ldg(ids + row0 + r) : -1;  // past the block: masked
      if (id[h] >= 0) {
        if (MODE == INT8) scl[h] = __ldg(scales + row0 + r);
        if (sqn != nullptr) sq[h] = __ldg(sqn + row0 + r);
      }
    }
    for (int ch = 0; ch < L.chunks; ++ch, ++g) {
      const int s = static_cast<int>(g % stages);
      mbar_wait(full + 8 * s, (g / stages) & 1);
      const uint32_t bq = qb + ch * QTILE * 128;
      if constexpr (MODE == INT8) {
        uint32_t a[4][4];
        int8_a_fragments(pipe + s * L.a_bytes + frag_row * 64 + 16 * (lane & 3), a);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_bf16_rs<QTILE>(acc, a[kk], desc_sw128(bq + kk * 32), ch > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<0>();  // the A registers are rewritten next step
        if (lane == 0) mbar_arrive(empty + 8 * s);
      } else {
        const uint32_t aq = pbase + s * L.a_bytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_bf16_ss<QTILE>(acc, desc_sw128(aq + kk * 32), desc_sw128(bq + kk * 32),
                             ch > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        if (ch > 0 && lane == 0) mbar_arrive(empty + 8 * static_cast<int>((g - 1) % stages));
      }
    }
    if constexpr (MODE != INT8) {
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty + 8 * static_cast<int>((g - 1) % stages));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(acc[j])::"memory");
    // acc[2 h + c]: query cq + c, row frag_row + 8 h. The lists change only
    // after the barrier below; ids are unique within a tile, so a key equal
    // to the k-th entry's beats it only by a lower id
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int h = j >> 1, qi = cq + (j & 1);
      if (id[h] < 0) continue;
      float v = acc[j];
      if (MODE == INT8) v *= scl[h];
      v = fmaf(two, v, -sq[h]);  // l2: 2 v - |d|^2, exact as 2 v is
      if (topk_better(v, id[h], thr_v[qi], thr_i[qi])) {
        const int slot = atomicAdd(cnt + qi, 1);
        buf[slot * QTILE + qi] = make_int2(__float_as_int(v), id[h]);
      }
    }
    bar_sync(1 + w, 128);
    for (int c = wq; c < QTILE; c += 4) {  // a warp per query
      const int m = cnt[c];
      if (m > 0) {
        float lv;
        int li;
        warp_insert(rv + c * TOPK_MAX, ri + c * TOPK_MAX, TOPK_MAX, buf + c, QTILE, m, lane,
                    lv, li);
        if (lane == 0) {
          thr_v[c] = lv;
          thr_i[c] = li;
        }
      }
      __syncwarp();
      if (lane == 0) cnt[c] = 0;
    }
    bar_sync(1 + w, 128);
  }
  if (wt < QTILE * TOPK_MAX) {
    const size_t o = (((size_t)blockIdx.y * 2 + w) * nt * QTILE + (size_t)t * QTILE) * TOPK_MAX + wt;
    part_v[o] = rv[wt];
    part_i[o] = ri[wt];
  }
}

template <int MODE>
cudaError_t launch(dim3 grid, int smem, cudaStream_t s, const void* q, const int* desc,
                   const void* store, const int* ids, const float* sq, const float* sl, int nt,
                   int pb, int pieces, int block, int d, int pad_block, int stages, float* pv,
                   int* pi) {
  CUtensorMap smap;
  const long long rows = (long long)(pad_block + 1) * block;
  const bool ok = MODE == INT8
                      ? hop::tensor_map(&smap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, store, rows, d,
                                        PIECE, 64, CU_TENSOR_MAP_SWIZZLE_NONE)
                      : hop::tensor_map(&smap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, store, rows,
                                        d, PIECE, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!ok) return cudaErrorInvalidValue;
  auto kernel = ivf_wgmma_kernel<MODE>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS_ALL, smem, s>>>(smap, static_cast<const __nv_bfloat16*>(q), desc, ids,
                                         sq, sl, nt, pb, pieces, block, d, pad_block, stages,
                                         pv, pi);
  return cudaGetLastError();
}

}  // namespace iw

// queries [nt * 8, d] (bf16 for bf16/int8 stores, f32 for f32); desc
// [nt, pb] block indices in [0, nb); store [nb * block, d] (nb = pad_block
// + 1); ids [nb * block] (-1 = pad row); sqn (l2) and scales (int8) [nb *
// block] f32 or null. regime STAGED: nsplit slices of per_split
// descriptors per tile, nsplit <= 32 * MERGE_LISTS partial lists. regime
// WGMMA: items of `pieces` 64-row pieces per descriptor, split evenly over
// nsplit blocks per tile (per_split unused), two partial lists each (2 nsplit <= 32 *
// MERGE_LISTS), a ring of `stages`; smem must be the layout's bytes.
// part_v/part_i: [lists, nt * 8, TOPK_MAX]; out: [nt * 8, k].
extern "C" int ivf_topk(const void* q, const void* desc, const void* store, const void* ids,
                        const void* sqn, const void* scales, int mode, int regime, int nt,
                        int pb, int pieces, int per_split, int nsplit, int block, int d,
                        int pad_block, int k, int stages, int smem, void* part_v, void* part_i,
                        void* out_v, void* out_i, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int lists = regime == WGMMA ? 2 * nsplit : nsplit;
  if (k < 1 || k > TOPK_MAX || nsplit < 1 || lists > 32 * MERGE_LISTS)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(nt, nsplit);
  const int* dc = static_cast<const int*>(desc);
  const int* id = static_cast<const int*>(ids);
  const float* sq = static_cast<const float*>(sqn);
  const float* sl = static_cast<const float*>(scales);
  float* pv = static_cast<float*>(part_v);
  int* pi = static_cast<int*>(part_i);
  cudaError_t err;
  if (regime == WGMMA) {
    if (mode == F32 || pieces != (block + iw::PIECE - 1) / iw::PIECE || stages < 1 ||
        iw::layout(mode, d, stages).bytes != smem)
      return static_cast<int>(cudaErrorInvalidValue);
    err = mode == INT8 ? iw::launch<INT8>(grid, smem, s, q, dc, store, id, sq, sl, nt, pb, pieces,
                                          block, d, pad_block, stages, pv, pi)
                       : iw::launch<BF16>(grid, smem, s, q, dc, store, id, sq, sl, nt, pb, pieces,
                                          block, d, pad_block, stages, pv, pi);
  } else if (regime == STAGED) {
    // the TAIL variant when D is not a whole number of 64-deep steps, a
    // block not of 32-row steps, or an operand not 16-byte aligned; bf16
    // and int8 stores come here only with a pitch TMA cannot describe or
    // an unaligned operand (ops/ivf.py::plan_ivf), so only f32 has the
    // other variant
    const bool tail = d % KC != 0 || block % RT != 0 ||
        ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(store)) & 15) != 0;
    decltype(&ivf_topk_partial_kernel<BF16, true>) kernel;
    switch (mode) {
      case BF16:
        kernel = ivf_topk_partial_kernel<BF16, true>;
        break;
      case INT8:
        kernel = ivf_topk_partial_kernel<INT8, true>;
        break;
      case F32:
        kernel = tail ? ivf_topk_partial_kernel<F32, true> : ivf_topk_partial_kernel<F32, false>;
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    kernel<<<grid, THREADS, 0, s>>>(q, dc, store, id, sq, sl, nt, pb, per_split, block, d,
                                    pad_block, pv, pi);
    err = cudaGetLastError();
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_merge_partial_topk(
      pv, pi, lists, nt * QTILE, TOPK_MAX, k, static_cast<float*>(out_v),
      static_cast<int*>(out_i), s));
}
