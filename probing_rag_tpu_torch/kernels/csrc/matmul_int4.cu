// int4-weight matrix products of the quantized LM (w4a16), reading the
// packed nibbles from device memory and widening them on chip:
//   rank-1 (qp [K, N/2], rs [K/g], s [N]):
//     out = dt(xs @ dt(q)) * dt(s), xs = dt(f32(x) * rs[k / g])
//   grouped (qp [K, N/2], gs [K/g, N]):
//     out = dt(sum over groups j of f32(dt(x_j @ q_j)) * gs[j])
//   channel, the tied head of an int4 embedding (qp [N, K/2], s [N]):
//     out = dt(x @ dt(q^T)) * dt(s)
// with f32 sums, in the op order of probing_rag_tpu_torch/models/gemma.py::
// _mm's int4 branches (and of the JAX _mm they port). The layout is
// ops/attention.py::pack_int4's: byte j of a row holds elements 2j (low
// nibble) and 2j + 1 (high nibble), each biased by +8.
//
// Replaces no Pallas kernel: XLA's fusion of the int4 -> dt convert into
// the dot's weight load (probing_rag_tpu/models/gemma.py::_mm, rank-1
// :685-714, grouped :715-727), which keeps the weight reads from HBM at 4
// bits. Before it the port unpacked every weight to an int8 copy on every
// call (two masks, two casts, a stack), folded rs in two more passes and
// ran matmul_int8 on the copy.
//
// Bound. At decode (M = 8) the work is ~32 flop per weight byte, so the
// packed weight read bounds it: 55 MB per Gemma-2B layer, 16.8 MB for
// [8 x 2048 -> 16384] (5.0 us at 3.35 TB/s). At 1,024 rows (grouped short
// prefills) and at prefill (M ~ 29K) the bf16 tensor cores do: 2 M N K flop
// at 989 TFLOP/s.
//
// Widening. 0x4300 | u is the bf16 of 128 + u (bf16 has 7 mantissa bits at
// exponent 7), so a nibble u = q + 8 becomes q exactly with one bf16x2 fma
// (x 1, - 136) per pair after a byte permute and a mask: no table, no
// conversion instruction.
//
// Regimes, picked by ops/matmul.py::plan_matmul_int4 and checked here:
//
// stream (rank-1 and grouped at up to 64 rows: the decode step, the verify
// round; grouped with groups of 128). What bounds it is the packed weight
// read, so the design keeps every SM streaming weights from its first load
// to its last:
// - one persistent block a SM takes an equal contiguous share of the
//   launch's units (a 256-column tile x a 128-deep step, 16 KB of nibbles;
//   the products of a shared launch one after another), tile-aligned
//   where that costs no unit a block, so no wave is left part-full and no
//   block ramps up more than once;
// - a producer warp keeps a deep ring of units in flight (TMA boxes of 128
//   rows x 128 bytes in the 128-byte swizzle, completing on mbarriers; 8
//   stages, 128 KB, at decode), and a consumer warp releases a stage as
//   soon as it has loaded its halfwords from it;
// - x is resident: the block copies the depths its share needs into shared
//   memory once (rank-1 with rs folded in, xs = dt(f32(x) * rs), as the
//   wgmma regime's pre-pass does), 128-byte swizzled; where a share's
//   depths do not fit (w_down at 40-64 rows) one window a column tile,
//   still each depth once;
// - one row tile of 8, 16, 32, 40 or 64 rows holds M, so the verify round's
//   40 rows read each weight once. The products are mma.sync m16n8k16: the
//   widened weights its A operand (a warp two m16 tiles, 32 columns; the
//   low nibble row g, the high row g + 8), x its B operand from the window
//   (M / 8 n8 tiles). wgmma m64nNk16 with the same register A fragments
//   (64 columns a warpgroup) was slower at decode, where each 16-deep step
//   waited on the previous asynchronous product (PERF.md, row 14);
// - at 8 rows two pairs of consumer warpgroups (17 warps; the registers
//   allow it there) take the block's units in turn, their sums added in
//   pair order: the consumers' latency, not the memory, bounded the
//   decode step with one pair;
// - a column tile whose steps fall on several blocks: in equal pieces, one
//   a block, of at most 8, the tile's blocks form a cluster that adds the
//   pieces through distributed shared memory; else (clusters of 16 blocks
//   of this size did not run at once on an H100) the pieces go to a
//   scratch and the last block to raise the tile's counter adds them. Both
//   add in block order, so the bits repeat from run to run. A step holds
//   one group, so pieces start at group boundaries. Grouped closes each
//   group at its step's end: the f32 partial rounded to bf16, scaled by gs,
//   added in f32.
// At 8 rows the planner keeps the small-M regime below where it measured
// faster: shares of at most two units, grouped or waiting on the scratch
// (a decode step's wo, and its grouped wq + wk + wv).
//
// small-M (the first design: the int4 tied head, grouped groups other than 128,
// products past 64 rows with too few tiles for wgmma, the short shares
// above). The weights are
// mma.sync m16n8k16's A operand (16 output columns a tile on its M) and x
// its B operand (8 rows a tile on its N); a nibble pair along k goes into a
// register straight from shared memory (one byte permute of two depth
// rows' words, a mask, a bf16x2 fma). Blocks of 64 columns and 8, 16 or 32
// rows; their 4 warps take the split's 128-deep steps in turn, each warp
// with its own cp.async ring of STAGES steps (the step's x, nibbles and
// scales); the warps' sums are added in warp order. Rank-1 scales x by rs
// as its fragments are loaded; grouped keeps a second f32 sum. When the
// tiles cannot keep every SM streaming weights, K is split over a thread
// block cluster (at most 16) whose splits sum in split order through
// distributed shared memory. One launch may take up to three weights that
// share x. Tail: the same kernel with element-checked synchronous loads,
// for operands cp.async cannot copy (K % 8, a packed row that is no
// multiple of 16 bytes, unaligned bases).
//
// wgmma (M > 64 and 32 output tiles or more: rank-1 at prefill and
// capture M; grouped from 65 rows, groups of 128): matmul_int8.cu's persistent
// warp-specialised kernel: one producer thread keeps TMA loads of the bf16
// x tile (128 rows, 128B-swizzled) and of the [64 x BN/2] nibble tile in
// flight in a ring of STAGES; two consumer warpgroups run wgmma m64nBNk16
// and, while a step's products run, widen the next step's nibbles into the
// swizzled K-major bf16 tile (an 8 x 8 transpose in registers). Rank-1
// first folds rs into x once (xs into a scratch [M, K] bf16 that the
// wrapper allocates: an activation, not a weight). Grouped (128 x 128
// tiles, so a weight is read at most 8 times at 1,024 rows, from L2) keeps
// a second f32 sum and closes each 128-deep group (two steps) as stream
// does.
//
// f32 mode (the tiny test configs): CUDA-core FMAs over 32 x 32 tiles, the
// three functions in f32.
//
// Device memory sees packed weights only: nothing writes a widened copy.

// nvcc-parts: 4
// The build compiles this file once per part, with NVCC_PART = 0 .. 3 and
// NVCC_PARTS = 4 (kernels/__init__.py reads the line above): part 1 holds
// the rank-1 small-M and stream kernels, part 2 the grouped ones, part 3
// the wgmma kernels, part 0 the channel and f32 kernels and the C entry.
#ifndef NVCC_PART
#define NVCC_PART 0
#define NVCC_PARTS 1
#endif
#define IN_PART(p) (NVCC_PARTS == 1 || NVCC_PART == (p))

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace mm4 {

using namespace hop;

enum Fn { kRank1 = 0, kGrouped = 1, kChannel = 2 };
constexpr int WG_BM = 128;  // the wgmma regime's rows a tile (wg::BM)

// One weight of a launch. The small-M regime takes up to MAX_PRODUCTS
// weights of one scheme that share x (a layer's wq, wk and wv; w_gate and
// w_up) in one launch: their column tiles follow one another on the grid.
struct Product {
  const uint8_t* qp;  // [K, N/2] (rank-1, grouped) or [N, K/2] (channel)
  const float* rs;    // rank-1: K / group row scales
  const float* s;     // rank-1, channel: N column scales
  const float* gs;    // grouped: [K / group, N]
  void* out;          // [M, N] bf16 (f32)
  int n;
  int tile0;          // its first column tile on the grid
};
constexpr int MAX_PRODUCTS = 3;

struct Args {
  const void* x;  // [M, K] bf16 (f32 in the f32 mode)
  Product p[MAX_PRODUCTS];
  int count;
  long long m;
  int k, group;
};

cudaError_t small_rank1(const Args& a, bool aligned, int bm, int bn, int splits, cudaStream_t st);
cudaError_t small_grouped(const Args& a, bool aligned, int bm, int bn, int splits,
                          cudaStream_t st);
cudaError_t small_channel(const Args& a, bool aligned, int bm, int bn, int splits,
                          cudaStream_t st);
// the stream regime (rank-1 or grouped by fn): rows, persistent blocks,
// ring stages, x window steps, the cluster of a split tile's pieces (1:
// none), the partial sums' scratch and the tiles' counters
cudaError_t stream_rank1(const Args& a, int rows, int grid, int stages, int xsteps, int cluster,
                         float* ws, int* counters, cudaStream_t st);
cudaError_t stream_grouped(const Args& a, int rows, int grid, int stages, int xsteps,
                           int cluster, float* ws, int* counters, cudaStream_t st);
// the wgmma regime: rank-1 folds x into xs first, grouped reads x
cudaError_t wgmma_launch(const Args& a, int fn, int bn, void* xs, int grid, cudaStream_t st);

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// round the f32 sum to bf16, then multiply by the bf16 scale in bf16 (the
// product of two bf16 values is exact in f32, so one rounding)
__device__ __forceinline__ __nv_bfloat16 bf16_scale(float acc, float s) {
  return __float2bfloat16_rn(bf16_round(acc) * bf16_round(s));
}

// (u_lo at bits 0-3, u_hi at bits 16-19, anything at 4-15 and 20-31) ->
// the bf16 pair (u_lo - 8, u_hi - 8), exactly
__device__ __forceinline__ uint32_t nib_pair(uint32_t v) {
  uint32_t t = (v & 0x000F000Fu) | 0x43004300u, d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(t), "r"(0x3F803F80u), "r"(0xC308C308u));
  return d;
}

// 8 bf16 values (16 bytes) times f, each rounded to bf16
__device__ __forceinline__ uint4 scale8(uint4 v, float f) {
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lo = __uint_as_float(w[i] << 16) * f;
    const float hi = __uint_as_float(w[i] & 0xFFFF0000u) * f;
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    w[i] = *reinterpret_cast<const uint32_t*>(&p);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// ------------------------------------------------------------- small-M

constexpr int WARPS = 4;          // a block's warps, each streaming its own steps
constexpr int STAGES = 3;         // the ring of each warp
constexpr int TBN = 64;           // output columns of a block: four m16 tiles of a warp
constexpr int BK_MAX = 128;       // depth of a step
constexpr int MAX_SPLITS = 16;    // the largest cluster Hopper runs

// One step of one warp in shared memory, laid out so that a warp's fragment
// loads fall on 32 different banks: x [BM][BK_MAX] bf16, 16-byte chunk c of
// row r at chunk c ^ (r & 7) (lane (g, t) reads row g: banks 4 (c ^ g) +
// t); the nibble tile [BK_MAX][TBN / 2] ([K, N/2]) with depth row r at row
// kslot(r) (a lane's rows 2t, 2t + 1, 2t + 8, 2t + 9 land 32 bytes apart:
// banks 8 t + g), or [TBN][BK_MAX / 2] (channel) with rows padded to 80
// bytes (banks 20 g mod 32); then the step's scales, copied with it so that
// no global load waits inside the step: grouped the gs rows of its groups
// over the block's 64 columns, rank-1 the rs of its groups (at most 8 each).
template <int MT, bool NT, int FN>
struct Stage {
  static constexpr int BM = 8 * MT;
  static constexpr int XLD = BK_MAX * 2;
  static constexpr int QLD = NT ? BK_MAX / 2 + 16 : TBN / 2;
  static constexpr int XB = BM * XLD;
  static constexpr int QB = (NT ? TBN : BK_MAX) * QLD;
  static constexpr int SB = FN == kGrouped ? BK_MAX / 16 * TBN * 4 : FN == kRank1 ? 32 : 0;
  static constexpr int BYTES = XB + QB + SB;
  static constexpr int SMEM = WARPS * STAGES * BYTES;
  static_assert(BYTES % 16 == 0 && BM * (TBN + 4) * 4 <= SMEM, "stage layout");
};

// the row of the [K, N/2] nibble tile that holds depth row r of a step: in
// each 8 rows, the even ones first (0, 2, 4, 6 -> 0-3), then the odd ones
__device__ __forceinline__ int kslot(int r) {
  return (r & ~7) | ((r & 6) >> 1) | ((r & 1) << 2);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// d += a b: a 16 x 16 (row), b 16 x 8 (col), f32 d. Fragments (lane = 4 g +
// t): a {(g, 2t), (g + 8, 2t), (g, 2t + 8), (g + 8, 2t + 8)} pairs; b {(k
// 2t, n g), (k 2t + 8, n g)} pairs; d {(g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1)}.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a bf16 pair times f, each rounded to bf16: xs = dt(f32(x) * rs)
__device__ __forceinline__ uint32_t scale_pair(uint32_t w, float f) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(__uint_as_float(w << 16) * f,
                                                 __uint_as_float(w & 0xFFFF0000u) * f);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The weights are mma's A operand (16 output columns a tile on its M), x its
// B operand (8 rows of x a tile on its N), so a decode step's 8 rows fill
// the tile. [K, N/2]: lane (g, t) reads one word (4 bytes: 8 columns) of
// rows k 2t, 2t + 1, 2t + 8, 2t + 9 of the step's 16; byte j of the words
// feeds tile j, whose rows g and g + 8 are columns 2 (4 g + j) and 2 (4 g +
// j) + 1 of the warp's 64: the low and the high nibbles of one byte, paired
// along k by one byte permute of two rows' words. Channel ([N, K/2]): tile j
// is columns 16 j .. + 15, a byte holds a column's pair of depths, so lane
// (g, t) reads bytes t and t + 4 of the 8 that hold the 16 depths of rows g
// and g + 8.
// [K, N/2]: the four words of depths kk .. kk + 15 that lane (g, t) reads
// (depth rows kk + 2t, + 1, + 8, + 9, at kslot rows kk + t, + 4, + 8, + 12)
__device__ __forceinline__ void load_words(const unsigned char* q4, int kk, int g, int t,
                                           uint32_t (&w)[4]) {
  constexpr int QLD = Stage<1, false, kRank1>::QLD;
  const unsigned char* col = q4 + (kk + t) * QLD + 4 * g;
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = *reinterpret_cast<const uint32_t*>(col + 4 * i * QLD);
}

// [K, N/2]: the J tiles' fragments from those words (J 4), or from
// halfwords (J 2: the stream regime's), tile j from byte j of each
template <int J = 4>
__device__ __forceinline__ void words_to_fragments(const uint32_t (&w)[4], uint32_t (&af)[J][4]) {
  const uint32_t h0 = w[0] >> 4, h1 = w[1] >> 4, h2 = w[2] >> 4, h3 = w[3] >> 4;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const uint32_t sel = j | ((4 + j) << 8);  // byte j of both words, at bits 0-7 and 16-23
    af[j][0] = nib_pair(__byte_perm(w[0], w[1], sel));
    af[j][1] = nib_pair(__byte_perm(h0, h1, sel));
    af[j][2] = nib_pair(__byte_perm(w[2], w[3], sel));
    af[j][3] = nib_pair(__byte_perm(h2, h3, sel));
  }
}

template <bool NT>
__device__ __forceinline__ void a_fragments(const unsigned char* q4, int kk, int g, int t,
                                            uint32_t (&af)[4][4]) {
  constexpr int QLD = Stage<1, NT, kRank1>::QLD;
  if constexpr (!NT) {
    uint32_t w[4];
    load_words(q4, kk, g, t, w);
    words_to_fragments(w, af);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned char* row = q4 + (16 * j + g) * QLD + kk / 2 + t;
      const uint32_t u0 = row[0], u1 = row[8 * QLD], u2 = row[4], u3 = row[8 * QLD + 4];
      af[j][0] = nib_pair(u0 | (u0 << 12));  // the low nibble at bits 0-3, the high at 16-19
      af[j][1] = nib_pair(u1 | (u1 << 12));
      af[j][2] = nib_pair(u2 | (u2 << 12));
      af[j][3] = nib_pair(u3 | (u3 << 12));
    }
  }
}

// output column (of the block's 64) of accumulator element e of tile j, for
// lane row g: rows g (e < 2) and g + 8 (e >= 2) of the tile
template <bool NT>
__device__ __forceinline__ int out_col(int j, int g, int e) {
  return NT ? 16 * j + g + (e >> 1) * 8 : 2 * (4 * g + j) + (e >> 1);
}

// The last steps of a block, its f32 sums of the tile in cs ([BM][TBN + 4]):
// with one split, the epilogue. With several, the splits of a tile are one
// thread block cluster (1, 1, splits): after a cluster barrier block z sums
// the z-th slice of the tile over every split's shared memory in split order
// (the same bits on every run) and runs the epilogue; a second barrier
// keeps each block's sums alive until the others have read them.
template <int BM, int FN>
__device__ __forceinline__ void finish_tile(float* cs, const Product& pr, long long m, int n0) {
  constexpr int T = WARPS * 32;
  auto* out = static_cast<__nv_bfloat16*>(pr.out);
  const int n = pr.n;
  const long long m0 = (long long)blockIdx.y * BM;
  const int splits = gridDim.z;
  const int rows = static_cast<int>(min(static_cast<long long>(BM), m - m0));
  const int cols = min(TBN, n - n0);
  auto store = [&](int r, int c, float v) {
    out[(m0 + r) * n + n0 + c] =
        FN == kGrouped ? __float2bfloat16_rn(v) : bf16_scale(v, pr.s[n0 + c]);
  };
  if (splits == 1) {
    for (int e = threadIdx.x; e < rows * cols; e += T) {
      const int r = e / cols, c = e % cols;
      store(r, c, cs[r * (TBN + 4) + c]);
    }
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int total = rows * cols, per = (total + splits - 1) / splits;
  const int e1 = min(total, (static_cast<int>(blockIdx.z) + 1) * per);
  for (int e = blockIdx.z * per + threadIdx.x; e < e1; e += T) {
    const int r = e / cols, c = e % cols, at = r * (TBN + 4) + c;
    float v = 0.0f;
#pragma unroll 4
    for (int z = 0; z < splits; ++z) v += cluster.map_shared_rank(cs, z)[at];
    store(r, c, v);
  }
  cluster.sync();
}

// Block (x, y, z): output columns [64 x, +64), rows [BM y, +BM), the depth
// steps of split z, which its WARPS warps take in turn (warp w: steps w, w +
// WARPS, ...): more warps streaming their own depths were faster than warps
// on neighbouring columns of the same depths (PERF.md, the findings on row
// 14). Each warp keeps STAGES - 1 of its steps in flight in its own ring (cp.async;
// zero-filled past M, N and K: a zero byte widens to -8, against zeros of
// x) and computes on the oldest: no block-wide barrier until the end,
// where the warps' sums are added in warp order. Rank-1 scales x by rs as
// its fragments are loaded; grouped closes a partial at each group's end
// (a step holds whole groups: bk = group x (128 / group)).
// ALIGNED: the copies are cp.async (K % 8, packed rows of whole 16-byte
// pieces, aligned bases); else each element is checked and copied through
// registers.
template <int MT, bool NT, int FN, bool ALIGNED>
__global__ void __launch_bounds__(WARPS * 32)
mm4_small(const Args a, int steps_per_split, int bk) {
  using S = Stage<MT, NT, FN>;
  constexpr int BM = S::BM;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  Product pr = a.p[0];  // this block's weight
#pragma unroll
  for (int i = 1; i < MAX_PRODUCTS; ++i)
    if (i < a.count && static_cast<int>(blockIdx.x) >= a.p[i].tile0) pr = a.p[i];
  const auto* x = static_cast<const uint16_t*>(a.x);
  const long long m = a.m;
  const int n = pr.n, k = a.k;
  const int n0 = (blockIdx.x - pr.tile0) * TBN;
  const long long m0 = (long long)blockIdx.y * BM;
  const int s_begin = blockIdx.z * steps_per_split + warp;
  const int s_end = min((k + bk - 1) / bk, static_cast<int>(blockIdx.z + 1) * steps_per_split);
  const int mine = s_begin < s_end ? (s_end - s_begin + WARPS - 1) / WARPS : 0;
  unsigned char* ring = smem + warp * STAGES * S::BYTES;
  const uint32_t ring_a = smem_u32(ring);
  const long long q_rows = NT ? n : k;  // rows of qp
  const int q_row_bytes = (NT ? k : n) / 2;

  // this warp's i-th step into stage sg
  auto issue = [&](int i, int sg) {
    const int k0 = (s_begin + i * WARPS) * bk;
    const int xc = bk / 8;  // 16-byte pieces of an x row
    for (int c = lane; c < BM * xc; c += 32) {
      const int r = c / xc, kc = (c % xc) * 8;
      const long long row = m0 + r;
      const int at = sg * S::BYTES + r * S::XLD + (((kc >> 3) ^ (r & 7)) << 4);
      if constexpr (ALIGNED) {
        const bool ok = row < m && k0 + kc < k;
        cp_async16(ring_a + at, ok ? x + row * k + k0 + kc : x, ok);
      } else {
        __align__(16) uint16_t h[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        if (row < m) {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (k0 + kc + e < k) h[e] = x[row * k + k0 + kc + e];
        }
        *reinterpret_cast<uint4*>(ring + at) = *reinterpret_cast<const uint4*>(h);
      }
    }
    const int rows = NT ? TBN : bk, qc = (NT ? bk / 2 : TBN / 2) / 16;
    for (int c = lane; c < rows * qc; c += 32) {
      const int r = c / qc, off = (c % qc) * 16;
      const long long qr = NT ? (long long)n0 + r : (long long)k0 + r;  // row of qp
      const int qb = (NT ? k0 / 2 : n0 / 2) + off;                       // its byte
      const int at = sg * S::BYTES + S::XB + (NT ? r : kslot(r)) * S::QLD + off;
      if constexpr (ALIGNED) {
        const bool ok = qr < q_rows && qb < q_row_bytes;
        cp_async16(ring_a + at, ok ? pr.qp + qr * q_row_bytes + qb : pr.qp, ok);
      } else {
        __align__(16) uint8_t b[16] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
        if (qr < q_rows) {
#pragma unroll
          for (int e = 0; e < 16; ++e)
            if (qb + e < q_row_bytes) b[e] = pr.qp[qr * q_row_bytes + qb + e];
        }
        *reinterpret_cast<uint4*>(ring + at) = *reinterpret_cast<const uint4*>(b);
      }
    }
    const int sat = sg * S::BYTES + S::XB + S::QB;
    if constexpr (FN == kGrouped) {  // gs rows k0 / group .. of columns [n0, n0 + 64)
      const int groups = bk / a.group, g0 = k0 / a.group;
      for (int c = lane; c < groups * (TBN / 4); c += 32) {
        const int gi = c / (TBN / 4), col = (c % (TBN / 4)) * 4;
        const bool ok = (g0 + gi) * a.group < k && n0 + col < n;
        const float* src = pr.gs + (long long)(g0 + gi) * n + n0 + col;
        if constexpr (ALIGNED) {
          cp_async16(ring_a + sat + (gi * TBN + col) * 4, ok ? src : pr.gs, ok);
        } else {
          float* d = reinterpret_cast<float*>(ring + sat) + gi * TBN + col;
#pragma unroll
          for (int e = 0; e < 4; ++e) d[e] = ok && n0 + col + e < n ? src[e] : 0.0f;
        }
      }
    }
    if constexpr (FN == kRank1) {  // rs of the groups that depths k0 .. k0 + bk - 1 fall in
      const int g0 = k0 / a.group, last = (min(k, k0 + bk) - 1) / a.group;
      if (lane <= last - g0) {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(ring_a + sat + 4 * lane),
                     "l"(pr.rs + g0 + lane)
                     : "memory");
      }
    }
  };

  float acc[4][MT][4], tot[4][MT][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][mt][e] = tot[j][mt][e] = 0.0f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < mine) issue(i, i);
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  for (int i = 0; i < mine; ++i) {
    const int sg = i % STAGES, k0 = (s_begin + i * WARPS) * bk;
    asm volatile("cp.async.wait_group %0;" ::"n"(STAGES - 2) : "memory");
    __syncwarp();  // step i landed for every lane; every lane is past step i - 1
    if (i + STAGES - 1 < mine) issue(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    asm volatile("cp.async.commit_group;" ::: "memory");
    const unsigned char* xs = ring + sg * S::BYTES;
    const unsigned char* q4 = xs + S::XB;
    const float* sc = reinterpret_cast<const float*>(q4 + S::QB);  // the step's scales
    // x's fragments for depths [kk, kk + 16): chunks kk / 8 and kk / 8 + 1
    // of row 8 mt + g
    auto x_fragments = [&](int kk, uint32_t (&b)[MT][2]) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const unsigned char* xr = xs + (8 * mt + g) * S::XLD + 4 * t;
        b[mt][0] = *reinterpret_cast<const uint32_t*>(xr + (((kk >> 3) ^ g) << 4));
        b[mt][1] = *reinterpret_cast<const uint32_t*>(xr + ((((kk >> 3) + 1) ^ g) << 4));
      }
    };
    // the products of depths [kk, kk + 16) on fragments already loaded
    auto mma_step = [&](int kk, uint32_t (&b)[MT][2], const uint32_t (&af)[4][4]) {
      if constexpr (FN == kRank1) {
        const float f = sc[(k0 + kk) / a.group - k0 / a.group];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          b[mt][0] = scale_pair(b[mt][0], f);
          b[mt][1] = scale_pair(b[mt][1], f);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma16816(acc[j][mt], af[j], b[mt][0], b[mt][1]);
    };
    auto products = [&](int kk) {
      uint32_t b[MT][2], af[4][4];
      x_fragments(kk, b);
      a_fragments<NT>(q4, kk, g, t, af);
      mma_step(kk, b, af);
    };
    // the group that ends at depth kk of the step: round, scale, add
    auto close_group = [&](int kk) {
      const float* gr = sc + kk / a.group * TBN;  // zeros past N
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = out_col<NT>(j, g, 0);  // even; c + 1 is the tile's row g + 8
        const float2 gv = *reinterpret_cast<const float2*>(gr + c);
        const float g0 = gv.x, g1 = gv.y;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            tot[j][mt][e] = __fadd_rn(tot[j][mt][e],
                                      __fmul_rn(bf16_round(acc[j][mt][e]), e >> 1 ? g1 : g0));
            acc[j][mt][e] = 0.0f;
          }
      }
    };
    if (bk == BK_MAX && k0 + BK_MAX <= k && (FN != kGrouped || a.group == BK_MAX)) {
      // a whole step (grouped: one group of 128): no branch between its
      // products; at up to 16 rows every load of the step is issued before
      // the first product
      if constexpr (!NT && MT <= 2) {
        uint32_t w[BK_MAX / 16][4], b[BK_MAX / 16][MT][2];
#pragma unroll
        for (int s8 = 0; s8 < BK_MAX / 16; ++s8) {
          load_words(q4, 16 * s8, g, t, w[s8]);
          x_fragments(16 * s8, b[s8]);
        }
#pragma unroll
        for (int s8 = 0; s8 < BK_MAX / 16; ++s8) {
          uint32_t af[4][4];
          words_to_fragments(w[s8], af);
          mma_step(16 * s8, b[s8], af);
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < BK_MAX; kk += 16) products(kk);
      }
      if constexpr (FN == kGrouped) close_group(BK_MAX - 16);
    } else {
#pragma unroll
      for (int kk = 0; kk < BK_MAX; kk += 16) {
        if (kk >= bk || k0 + kk >= k) break;
        products(kk);
        if (FN == kGrouped && (k0 + kk + 16) % a.group == 0) close_group(kk);
      }
    }
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();  // every warp's copies landed and were read: the rings are free
  float* cs = reinterpret_cast<float*>(smem);
  constexpr int CLD = TBN + 4;
  for (int w = 0; w < WARPS; ++w) {  // the warps' sums, added in warp order
    if (warp == w) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int at = (8 * mt + 2 * t + (e & 1)) * CLD + out_col<NT>(j, g, e);
            const float v = FN == kGrouped ? tot[j][mt][e] : acc[j][mt][e];
            cs[at] = w == 0 ? v : cs[at] + v;
          }
    }
    __syncthreads();
  }
  finish_tile<BM, FN>(cs, pr, m, n0);
}

// Launches kernel on grid (N tiles, M tiles, splits); the splits of a tile
// form one cluster.
template <typename Kernel>
cudaError_t launch_split(Kernel kernel, dim3 grid, int smem, cudaStream_t stream, const Args& a,
                         int per, int bk) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(WARPS * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = grid.z;
  cfg.attrs = attr;
  cfg.numAttrs = grid.z > 1 ? 1 : 0;
  cudaError_t err = cudaSuccess;
  if (grid.z > 8)  // clusters of up to 16 blocks are not portable but run on Hopper
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, kernel, a, per, bk);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int FN, int MT, bool ALIGNED>
cudaError_t launch_tile(const Args& a, int splits, cudaStream_t stream) {
  constexpr bool NT = FN == kChannel;
  constexpr int BM = 8 * MT;
  // a step holds whole groups (group <= 128, group % 16 == 0)
  if (FN == kGrouped && a.group > BK_MAX) return cudaErrorInvalidValue;
  const int bk = FN == kGrouped ? BK_MAX / a.group * a.group : BK_MAX;
  const long long mt = (a.m + BM - 1) / BM;
  if (mt > 65535 || splits < 1 || splits > MAX_SPLITS) return cudaErrorInvalidValue;
  const int nsteps = (a.k + bk - 1) / bk;
  const int per = (nsteps + splits - 1) / splits;
  if ((splits - 1) * per >= nsteps) return cudaErrorInvalidValue;  // an empty split
  const int tiles = a.p[a.count - 1].tile0 + (a.p[a.count - 1].n + TBN - 1) / TBN;
  dim3 grid(tiles, static_cast<unsigned>(mt), splits);
  return launch_split(mm4_small<MT, NT, FN, ALIGNED>, grid, Stage<MT, NT, FN>::SMEM, stream, a, per,
                      bk);
}

// bm 8, 16 or 32 rows (one, two or four 8-row tiles of x), bn 64
template <int FN>
cudaError_t launch_small(const Args& a, bool aligned, int bm, int bn, int splits,
                         cudaStream_t stream) {
  if (bn != TBN) return cudaErrorInvalidValue;
  if (aligned) {
    if (bm == 8) return launch_tile<FN, 1, true>(a, splits, stream);
    if (bm == 16) return launch_tile<FN, 2, true>(a, splits, stream);
    if (bm == 32) return launch_tile<FN, 4, true>(a, splits, stream);
  } else {
    if (bm == 8) return launch_tile<FN, 1, false>(a, splits, stream);
    if (bm == 16) return launch_tile<FN, 2, false>(a, splits, stream);
    if (bm == 32) return launch_tile<FN, 4, false>(a, splits, stream);
  }
  return cudaErrorInvalidValue;
}

// -------------------------------------------------------------- stream

namespace st {

constexpr int BN = 256;                  // a unit's columns: 128 bytes of each depth row
constexpr int BK = 128;                  // a unit's depth (grouped: one group)
constexpr int UNIT = BK * BN / 2;        // a unit's nibbles, one TMA box: 16 KB
constexpr int CONSUMERS = 256;           // a pair of warpgroups, 128 columns each
constexpr int MAX_STAGES = 16;
constexpr int MAX_TILES = 4096;          // the counters ops/matmul.py keeps
constexpr int SMEM_MAX = 232448;         // a block's dynamic shared memory on Hopper
constexpr int XBAR = 1;                  // the consumers' named barrier
constexpr int EBAR = 2;                  // pair 0's, for a split tile's scratch

// Shared memory from a base aligned to 1024: the ring of units, the x
// window (xsteps steps of BK depths; each 64 depths NR rows of 128 bytes
// in the 128-byte swizzle), the full and empty barriers, two flags, and at
// 8 rows (two pairs of consumer warpgroups) the second pair's sums.
// ops/matmul.py::stream_smem is the same sum.
struct Layout {
  int stages, xsteps, nr;
  __host__ __device__ int xwin() const { return stages * UNIT; }
  __host__ __device__ int bars() const { return xwin() + xsteps * nr * BK * 2; }
  __host__ __device__ int flags() const { return bars() + 16 * stages; }
  __host__ __device__ int pairs() const { return flags() + 16; }
  __host__ __device__ int alloc() const {
    return pairs() + (nr == 8 ? nr * CONSUMERS * 4 : 0) + 1024;
  }
};

// the row tile that holds m rows (m <= 64)
__host__ __device__ constexpr int rows_for(long long m) {
  return m <= 8 ? 8 : m <= 16 ? 16 : m <= 32 ? 32 : m <= 40 ? 40 : 64;
}

// The launch's units in order: unit T * steps + s is step s of column tile
// T, the products' tiles one after another. Block b takes units [start(b),
// start(b + 1)): per + 1 of them for the first rem blocks, per after.
struct Shares {
  int steps, per, rem;
  __device__ Shares(int k, int tiles, int grid)
      : steps((k + BK - 1) / BK), per(tiles * steps / grid), rem(tiles * steps % grid) {}
  __device__ int start(int b) const { return b * per + min(b, rem); }
  __device__ int block_of(int u) const {
    const int big = rem * (per + 1);
    return u < big ? u / (per + 1) : rem + (u - big) / per;
  }
};

// the product whose column tiles hold tile t, and its index
__device__ __forceinline__ Product pick(const Args& a, int t, int& index) {
  Product pr = a.p[0];
  index = 0;
#pragma unroll
  for (int i = 1; i < MAX_PRODUCTS; ++i)
    if (i < a.count && t >= a.p[i].tile0) {
      pr = a.p[i];
      index = i;
    }
  return pr;
}

// This lane's four halfwords of k16 step kk of the unit at stg (TMA's
// 128-byte swizzle: 16-byte chunk q of row r at chunk q ^ (r & 7)): depth
// rows 16 kk + 2t, + 1, + 8, + 9, bytes 2g and 2g + 1 of chunk `chunk`
// (the warp's 16 bytes: 32 columns). A warp's 32 lanes touch 4 chunks (one
// per t) x 4 words: no bank conflict.
__device__ __forceinline__ void unit_halfwords(const uint8_t* stg, int kk, int chunk, int g, int t,
                                               uint32_t (&h)[4]) {
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int r = 16 * kk + 2 * t + (d & 1) + 8 * (d >> 1);
    h[d] = *reinterpret_cast<const uint16_t*>(stg + r * 128 + ((chunk ^ (r & 7)) << 4) + 2 * g);
  }
}

// x rows [0, NR) at the depths of steps [x0, x0 + xn) into the window,
// 16-byte piece q of a row at its 64 depths' 128-byte swizzle; rank-1
// folds rs into it (xs = dt(f32(x) * rs)); zeros past M and K
template <int FN, int NR, int CT>
__device__ __forceinline__ void fill_window(uint8_t* win, const uint16_t* x, const float* rs,
                                            long long m, int k, int group, int x0, int xn,
                                            int tid) {
  const int pieces = xn * (BK / 8);
  for (int e = tid; e < NR * pieces; e += CT) {
    const int r = e / pieces, q = e % pieces, d = x0 * BK + 8 * q;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < m && d < k) {
      v = __ldg(reinterpret_cast<const uint4*>(x + r * static_cast<long long>(k) + d));
      if constexpr (FN == kRank1) v = scale8(v, __ldg(rs + d / group));
    }
    *reinterpret_cast<uint4*>(win + (q >> 3) * NR * 128 + sw128(r, q & 7)) = v;
  }
}

// The outputs a consumer thread holds, val[j][i][2 h + c] (mma j's sums
// over x rows 8 i ..: its row g + 8 h is weight column col + 2 j + h, its
// column 2t + c the x row 8 i + 2t + c), rounded (rank-1: times the bf16
// scale) and stored 4 columns at a time.
template <int FN, int NR>
__device__ __forceinline__ void store_tile(const float (&val)[2][NR / 8][4], const Product& pr,
                                           long long m, int col, int t) {
  if (col >= pr.n) return;
  auto* out = static_cast<__nv_bfloat16*>(pr.out);
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if constexpr (FN == kRank1) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[e] = __ldg(pr.s + col + e);
  }
#pragma unroll
  for (int i = 0; i < NR / 8; ++i)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int row = 8 * i + 2 * t + c;
      if (row >= m) continue;
      const float v[4] = {val[0][i][c], val[0][i][2 + c], val[1][i][c], val[1][i][2 + c]};
      uint32_t w[2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        __nv_bfloat162 b;
        b.x = FN == kGrouped ? __float2bfloat16_rn(v[2 * p]) : bf16_scale(v[2 * p], s[2 * p]);
        b.y = FN == kGrouped ? __float2bfloat16_rn(v[2 * p + 1])
                             : bf16_scale(v[2 * p + 1], s[2 * p + 1]);
        w[p] = *reinterpret_cast<const uint32_t*>(&b);
      }
      *reinterpret_cast<uint2*>(out + row * pr.n + col) = make_uint2(w[0], w[1]);
    }
}

// Block b: units [start(b), start(b + 1)) (Shares), walked as pieces (the
// steps of one column tile). The last warp is the producer: its first lane
// loads each unit's nibble box by TMA into the ring's next stage once the
// consumers have released it. Before it come PAIRS pairs of consumer
// warpgroups (two at 8 rows, where the registers allow 17 warps; else
// one); pair p takes the block's units p, p + PAIRS, ... and warpgroup c of
// a pair columns [128 c, + 128) of each: a warp loads its halfwords of the
// unit (32 registers a lane), releases the stage, and per 16 depths widens
// them into two mma.sync A fragments (two m16 tiles: 32 columns) and runs
// them against x's B fragments from the window (NR / 8 n8 tiles). Rank-1
// sums a piece in f32; grouped closes each step's group (round, scale by
// gs, add in f32). At a piece's end the pairs' sums are added in pair
// order and pair 0 finishes it: a whole tile is stored; a piece of a tile
// split over blocks either waits in shared memory for the cluster (the
// plan's `cluster` blocks, one tile's pieces in block order) to add the
// pieces through distributed shared memory, or, without a cluster, goes to
// the scratch (slot 0 for the block's first piece, 1 for its last), and
// the block that raises the tile's counter to its pieces' count adds every
// piece in block order and stores the tile. Either way the sums repeat
// bit for bit from run to run.
template <int NR>
struct Team {
  static constexpr int PAIRS = NR == 8 ? 2 : 1;
  static constexpr int CONSUMER_THREADS = PAIRS * CONSUMERS;
  static constexpr int THREADS = CONSUMER_THREADS + 32;
};

// the tile's outputs a pair-0 thread holds, written as NR / 4 float4s:
// float4 q of thread tid at [q * CONSUMERS + tid]
template <int NT>
__device__ __forceinline__ void put_sums(float4* dst, const float (&val)[2][NT][4], int tid) {
#pragma unroll
  for (int q = 0; q < 2 * NT; ++q) {
    const float(&e)[4] = val[q / NT][q % NT];
    dst[q * CONSUMERS + tid] = make_float4(e[0], e[1], e[2], e[3]);
  }
}

template <int NT>
__device__ __forceinline__ void add_sums(float (&val)[2][NT][4], float4 f, int q) {
  float(&e)[4] = val[q / NT][q % NT];
  e[0] += f.x;
  e[1] += f.y;
  e[2] += f.z;
  e[3] += f.w;
}

// column (of a tile) and row lane t of pair-0 consumer thread tid
__device__ __forceinline__ int thread_col(int tid) {
  const int warp = tid >> 5, g = (tid & 31) >> 2;
  return 128 * (warp >> 2) + 32 * (warp & 3) + 4 * g;
}

template <int FN, int NR>
__global__ void __launch_bounds__(Team<NR>::THREADS, 1)
mm4_stream(const Args a, const __grid_constant__ CUtensorMap q0,
           const __grid_constant__ CUtensorMap q1, const __grid_constant__ CUtensorMap q2,
           int stages, int xsteps, int cluster, float* __restrict__ ws,
           int* __restrict__ counters) {
  constexpr int NT = NR / 8;  // n8 tiles of x rows
  constexpr int PAIRS = Team<NR>::PAIRS, CT = Team<NR>::CONSUMER_THREADS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const Layout L{stages, xsteps, NR};
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + L.bars(), empty = full + 8 * stages;
  volatile int* last = reinterpret_cast<volatile int*>(smem + L.flags());
  float4* pair_sums = reinterpret_cast<float4*>(smem + L.pairs());
  int tiles = 0;
#pragma unroll
  for (int i = 0; i < MAX_PRODUCTS; ++i)
    if (i < a.count) tiles = a.p[i].tile0 + (a.p[i].n + BN - 1) / BN;
  const Shares sh(a.k, tiles, gridDim.x);
  const int u0 = sh.start(blockIdx.x), u1 = sh.start(blockIdx.x + 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, CONSUMERS / 32);  // the warps of the pair that takes the unit
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == CT / 32) {  // the producer
    if (lane == 0) {
      for (int u = u0, i = 0; u < u1; ++u, ++i) {
        const int s = i % stages, tile = u / sh.steps;
        int pi;
        const Product pr = pick(a, tile, pi);
        mbar_wait(empty + 8 * s, ((i / stages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, UNIT);
        tma_load_2d(base + s * UNIT, pi == 0 ? &q0 : pi == 1 ? &q1 : &q2, full + 8 * s,
                    (tile - pr.tile0) * (BN / 2), (u - tile * sh.steps) * BK);
      }
    }
  } else {
    const int pair = warp / (CONSUMERS / 32), tid = threadIdx.x % CONSUMERS;
    const int c = (warp >> 2) & 1, w = warp & 3, g = lane >> 2, t = lane & 3;
    const int chunk = 4 * c + w, colw = 128 * c + 32 * w + 4 * g;
    uint8_t* win = smem + L.xwin();
    const auto* x = static_cast<const uint16_t*>(a.x);
    float acc[2][NT][4], tot[2][NT][4];
    int x0 = 0, xn = 0, xp = -1;  // the window: steps [x0, x0 + xn), folded for product xp
    int i = 0;                    // the block's units so far: the ring's position
    for (int u = u0; u < u1;) {
      const int tile = u / sh.steps, t0 = tile * sh.steps, pe = min(u1, t0 + sh.steps);
      int pi;
      const Product pr = pick(a, tile, pi);
      const int col = (tile - pr.tile0) * BN + colw;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i2 = 0; i2 < NT; ++i2)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][i2][e] = tot[j][i2][e] = 0.0f;
      for (int v = u; v < pe; ++v, ++i) {
        const int step = v - t0;
        if (step < x0 || step >= x0 + xn || (FN == kRank1 && pi != xp)) {
          // a new window, once every warp is done with the old one
          bar_sync(XBAR, CT);
          x0 = xsteps >= sh.steps ? 0 : step;
          xn = xsteps >= sh.steps ? sh.steps : min(xsteps, pe - v);
          xp = pi;
          fill_window<FN, NR, CT>(win, x, pr.rs, a.m, a.k, a.group, x0, xn, threadIdx.x);
          bar_sync(XBAR, CT);
        }
        if (PAIRS > 1 && i % PAIRS != pair) continue;  // the other pair's unit
        float4 gv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // grouped: the step's gs, loaded early
        if (FN == kGrouped && col < pr.n)
          gv = __ldg(reinterpret_cast<const float4*>(pr.gs + static_cast<long long>(step) * pr.n + col));
        const int sg = i % stages;
        mbar_wait(full + 8 * sg, (i / stages) & 1);
        uint32_t hw[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) unit_halfwords(smem + sg * UNIT, kk, chunk, g, t, hw[kk]);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * sg);  // this warp's loads of the stage are done
        if constexpr (FN == kGrouped) {  // a new group
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int i2 = 0; i2 < NT; ++i2)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[j][i2][e] = 0.0f;
        }
        // x's B fragments of depths 16 kk + 2t, + 1 and + 8, + 9 of row 8 i +
        // g: word t of 16-byte chunks 2 (kk % 4) and + 1 of the row's 64
        // depths, XOR-swizzled by g (32 banks)
        const uint8_t* xw = win + ((step - x0) * 2) * NR * 128 + 4 * t;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          uint32_t af[2][4];
          words_to_fragments<2>(hw[kk], af);
          const int c0 = 2 * (kk & 3);
#pragma unroll
          for (int i2 = 0; i2 < NT; ++i2) {
            const uint8_t* xr = xw + (kk >> 2) * NR * 128 + (8 * i2 + g) * 128;
            const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr + ((c0 ^ g) << 4));
            const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + (((c0 + 1) ^ g) << 4));
#pragma unroll
            for (int j = 0; j < 2; ++j) mma16816(acc[j][i2], af[j], b0, b1);
          }
        }
        if constexpr (FN == kGrouped) {  // the step's group: round, scale by gs, add
          const float gj[2][2] = {{gv.x, gv.y}, {gv.z, gv.w}};
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int i2 = 0; i2 < NT; ++i2)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                tot[j][i2][e] = __fadd_rn(tot[j][i2][e],
                                          __fmul_rn(bf16_round(acc[j][i2][e]), gj[j][e >> 1]));
        }
      }
      float(&val)[2][NT][4] = FN == kGrouped ? tot : acc;
      const bool whole = u == t0 && pe == t0 + sh.steps;
      const int slot = u == u0 ? 0 : 1;
      u = pe;
      if constexpr (PAIRS > 1) {  // the pairs' sums, added in pair order
        if (pair == 1) put_sums<NT>(pair_sums, val, tid);
        bar_sync(XBAR, CT);
        if (pair == 0) {
#pragma unroll
          for (int q = 0; q < 2 * NT; ++q) add_sums<NT>(val, pair_sums[q * CONSUMERS + tid], q);
        }
        bar_sync(XBAR, CT);
        if (pair == 1) continue;
      }
      if (whole) {
        store_tile<FN, NR>(val, pr, a.m, col, t);
      } else if (cluster > 1) {  // one piece a block: the cluster adds them below
        put_sums<NT>(reinterpret_cast<float4*>(smem), val, tid);
      } else {
        const int b0 = sh.block_of(t0), b1 = sh.block_of(t0 + sh.steps - 1);
        put_sums<NT>(reinterpret_cast<float4*>(ws) +
                         static_cast<long long>(blockIdx.x * 2 + slot) * (NR / 4) * CONSUMERS, val, tid);
        __threadfence();
        bar_sync(EBAR, CONSUMERS);
        if (tid == 0) {
          const int seen = atomicAdd(counters + tile, 1);
          const int done = seen == b1 - b0;
          if (done) counters[tile] = 0;  // ready for the next launch
          last[slot] = done;
        }
        bar_sync(EBAR, CONSUMERS);
        if (last[slot]) {  // every piece is written: add them in block order
          __threadfence();
          float sum[2][NT][4];
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int i2 = 0; i2 < NT; ++i2)
#pragma unroll
              for (int e = 0; e < 4; ++e) sum[j][i2][e] = 0.0f;
          // B pieces' loads in flight before their adds (at 8 rows; more rows
          // leave no registers for them)
          constexpr int B = NT == 1 ? 4 : 1;
          for (int b = b0; b <= b1; b += B) {
            float4 f[B][2 * NT];
#pragma unroll
            for (int r = 0; r < B; ++r) {
              const int bb = min(b + r, b1);
              const float4* p = reinterpret_cast<const float4*>(ws) +
                                static_cast<long long>(bb * 2 + (sh.start(bb) >= t0 ? 0 : 1)) *
                                    (NR / 4) * CONSUMERS + tid;
#pragma unroll
              for (int q = 0; q < 2 * NT; ++q) f[r][q] = __ldcg(p + q * CONSUMERS);
            }
#pragma unroll
            for (int r = 0; r < B; ++r)
              if (b + r <= b1) {
#pragma unroll
                for (int q = 0; q < 2 * NT; ++q) add_sums<NT>(sum, f[r][q], q);
              }
          }
          store_tile<FN, NR>(sum, pr, a.m, col, t);
        }
      }
    }
  }
  if (cluster > 1) {  // block z of a tile's cluster adds its slice of the pieces in block order
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();  // every piece is in its block's shared memory
    const int owners = CONSUMERS / cluster, z = static_cast<int>(cl.block_rank());
    if (static_cast<int>(threadIdx.x) < owners) {
      const int owner = z * owners + threadIdx.x, tile = blockIdx.x / cluster;
      int pi;
      const Product pr = pick(a, tile, pi);
      float sum[2][NT][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i2 = 0; i2 < NT; ++i2)
#pragma unroll
          for (int e = 0; e < 4; ++e) sum[j][i2][e] = 0.0f;
      for (int r = 0; r < cluster; ++r) {
        const float4* p = reinterpret_cast<const float4*>(cl.map_shared_rank(smem, r)) + owner;
#pragma unroll
        for (int q = 0; q < 2 * NT; ++q) add_sums<NT>(sum, p[q * CONSUMERS], q);
      }
      store_tile<FN, NR>(sum, pr, a.m, (tile - pr.tile0) * BN + thread_col(owner), owner & 3);
    }
    cl.sync();  // no block leaves while the others read its shared memory
  }
}

template <int FN, int NR>
cudaError_t launch_nr(const Args& a, const CUtensorMap (&maps)[MAX_PRODUCTS], int grid,
                      int stages, int xsteps, int cluster, float* ws, int* counters,
                      cudaStream_t stream) {
  const int smem = Layout{stages, xsteps, NR}.alloc();
  auto kernel = mm4_stream<FN, NR>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cluster > 8)  // clusters of up to 16 are not portable but run on Hopper
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(Team<NR>::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cluster > 1) {  // a cluster a tile only if every tile's cluster runs at once
    int fit = 0;
    err = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (fit * cluster < grid) cluster = attr[0].val.clusterDim.x = 1;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, a, maps[0], maps[1], maps[2], stages, xsteps, cluster,
                           ws, counters);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// a TMA map of each weight's [K, N/2] nibbles, boxes of one unit
template <int FN>
cudaError_t launch(const Args& a, int rows, int grid, int stages, int xsteps, int cluster,
                   float* ws, int* counters, cudaStream_t stream) {
  CUtensorMap maps[MAX_PRODUCTS];
  for (int i = 0; i < a.count; ++i)
    if (!tensor_map(&maps[i], CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.p[i].qp, a.k, a.p[i].n / 2, BK,
                    BN / 2, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B))
      return cudaErrorInvalidValue;
  for (int i = a.count; i < MAX_PRODUCTS; ++i) maps[i] = maps[0];
  switch (rows) {
    case 8: return launch_nr<FN, 8>(a, maps, grid, stages, xsteps, cluster, ws, counters, stream);
    case 16: return launch_nr<FN, 16>(a, maps, grid, stages, xsteps, cluster, ws, counters, stream);
    case 32: return launch_nr<FN, 32>(a, maps, grid, stages, xsteps, cluster, ws, counters, stream);
    case 40: return launch_nr<FN, 40>(a, maps, grid, stages, xsteps, cluster, ws, counters, stream);
    case 64: return launch_nr<FN, 64>(a, maps, grid, stages, xsteps, cluster, ws, counters, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace st

#if IN_PART(1)
cudaError_t small_rank1(const Args& a, bool aligned, int bm, int bn, int splits,
                        cudaStream_t st) {
  return launch_small<kRank1>(a, aligned, bm, bn, splits, st);
}
cudaError_t stream_rank1(const Args& a, int rows, int grid, int stages, int xsteps, int cluster,
                         float* ws, int* counters, cudaStream_t stream) {
  return st::launch<kRank1>(a, rows, grid, stages, xsteps, cluster, ws, counters, stream);
}
#endif
#if IN_PART(2)
cudaError_t small_grouped(const Args& a, bool aligned, int bm, int bn, int splits,
                          cudaStream_t st) {
  return launch_small<kGrouped>(a, aligned, bm, bn, splits, st);
}
cudaError_t stream_grouped(const Args& a, int rows, int grid, int stages, int xsteps,
                           int cluster, float* ws, int* counters, cudaStream_t stream) {
  return st::launch<kGrouped>(a, rows, grid, stages, xsteps, cluster, ws, counters, stream);
}
#endif

#if IN_PART(0)
cudaError_t small_channel(const Args& a, bool aligned, int bm, int bn, int splits,
                          cudaStream_t st) {
  return launch_small<kChannel>(a, aligned, bm, bn, splits, st);
}
#endif  // IN_PART(0)

#if IN_PART(3)

// ---------------------------------------------------------------- wgmma

namespace wg {

constexpr int BM = WG_BM;           // output rows per tile: two warpgroups of 64
constexpr int BK = 64;              // depth per step: one 128-byte bf16 row
constexpr int STAGES = 4;           // TMA ring of x and nibble tiles
constexpr int WIDE = 2;             // ring of widened bf16 weight tiles
constexpr int THREADS = 384;        // consumers (warps 0-7), producer (8-11)
constexpr int WIDEN_THREADS = 256;  // the consumers widen the weight tiles
// setmaxnreg moves registers only within the block: the 384 x 168 it was
// launched with, so 2 x (CONSUMER - 168) <= 168 - PRODUCER
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;

template <int BN>
struct Smem {
  static constexpr int X = BM * BK * 2;   // bf16 x tile, 128B-swizzled
  static constexpr int Q = BK * BN / 2;   // nibble tile as TMA wrote it
  static constexpr int W = BN * BK * 2;   // widened bf16 tile, K-major, swizzled
  static constexpr int X_OFF = 0;
  static constexpr int Q_OFF = X_OFF + STAGES * X;
  static constexpr int W_OFF = Q_OFF + STAGES * Q;
  static constexpr int BAR_OFF = W_OFF + WIDE * W;
  static constexpr int BYTES = BAR_OFF + 8 * (2 * STAGES + 2 * WIDE);
  static constexpr int ALLOC = BYTES + 1024;  // room to align the base to 1024
  static_assert(Q_OFF % 1024 == 0 && W_OFF % 1024 == 0 && W % 1024 == 0, "swizzle atoms");
};

__device__ __forceinline__ void fence_acc(float& v) { asm volatile("" : "+f"(v)::"memory"); }

// The [BK, BN/2] nibble tile (row k: columns n as nibble pairs) into the
// K-major bf16 tile (row n: 64 depths, 128B-swizzled). Thread block b covers
// 8 rows (k) x 4 bytes (8 columns n) and writes 8 rows (n) of 16 bytes (k):
// for each pair of k rows one byte permute takes byte c / 2 of both (high
// nibbles after a shift for odd c) and nib_pair widens them. Blocks run
// n-fastest over the lanes, so the 4-byte reads of a warp fill one 128-byte
// row; each lane writes its 8 rows starting at row (lane & 7), so the
// 16-byte writes of an 8-lane phase land in 8 different chunks of the
// swizzle: both conflict-free.
template <int BN>
__device__ __forceinline__ void widen_kn4(const uint8_t* q4, uint8_t* wb, int wt) {
  constexpr int NB = BN / 8;
  constexpr int PER = ((BK / 8) * NB + WIDEN_THREADS - 1) / WIDEN_THREADS;
  const int rot = wt & 7;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int b = wt + i * WIDEN_THREADS;
    if (b >= (BK / 8) * NB) break;
    const int nb = b % NB, kb = b / NB;
    uint32_t u[8], h[8];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      u[kk] = *reinterpret_cast<const uint32_t*>(q4 + (kb * 8 + kk) * (BN / 2) + nb * 4);
      h[kk] = u[kk] >> 4;
    }
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int c = it ^ rot;  // this write's column of the block
      const uint32_t sel = static_cast<uint32_t>(c >> 1) | (static_cast<uint32_t>(4 + (c >> 1)) << 8);
      uint32_t o[4];
#pragma unroll
      for (int p = 0; p < 4; ++p)
        o[p] = nib_pair(c & 1 ? __byte_perm(h[2 * p], h[2 * p + 1], sel)
                              : __byte_perm(u[2 * p], u[2 * p + 1], sel));
      *reinterpret_cast<uint4*>(wb + sw128(nb * 8 + c, kb)) = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

// xs = dt(f32(x) * rs[k / group]) over x [M, K] bf16, 8 values a thread
// (group % 16 == 0, K % 8 == 0): the fold of rank-1's group factor, once
// per product, before the wgmma kernel reads xs. Folding each x tile in
// shared memory instead repeats it for every column tile (64 times at N
// 16,384), and was slower both in the consumer warpgroups and in the
// producer's idle warps (PERF.md, the findings on row 14).
__global__ void __launch_bounds__(256)
mm4_fold(const uint4* __restrict__ x, const float* __restrict__ rs, uint4* __restrict__ xs,
         long long chunks, int k, int group) {
  const long long c = blockIdx.x * 256ll + threadIdx.x;
  if (c < chunks) xs[c] = scale8(x[c], __ldg(rs + (c * 8 % k) / group));
}

// Persistent warp-specialised kernel (matmul_int8.cu's) over xs (rank-1)
// or x (grouped): block b takes tiles b, b + grid, ... of 128 x BN outputs,
// tile t at rows (t / tiles_n) * 128 and columns (t % tiles_n) * BN; every
// role walks the same steps g. sc: rank-1's column scales s [N], grouped's
// gs [K / 128, N], whose group of 128 is two steps: its sums start afresh
// at the group's first step and close after its second (round to bf16,
// scale by gs, add in f32).
template <int BN, int FN>
__global__ void __launch_bounds__(THREADS, 1)
mm4_wgmma(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap qmap,
          const float* __restrict__ sc, __nv_bfloat16* __restrict__ out, long long m, int n,
          int k) {
  using L = Smem<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + L::BAR_OFF;    // TMA landed: x and nibbles of a stage
  const uint32_t empty = full + 8 * STAGES;   // stage read by consumers and wideners
  const uint32_t wfull = empty + 8 * STAGES;  // widened tile (and scaled x) written
  const uint32_t wempty = wfull + 8 * WIDE;   // widened tile read by wgmma
  const int tiles_n = (n + BN - 1) / BN;
  const long long tiles = (m + BM - 1) / BM * tiles_n;
  const int steps = (k + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 8);  // 8 consumer warps
    }
    for (int i = 0; i < WIDE; ++i) {
      mbar_init(wfull + 8 * i, WIDEN_THREADS);
      mbar_init(wempty + 8 * i, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const long long total = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x * steps;

  if (warp >= 8) {  // producer warpgroup: its first thread issues the TMA loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 256) {
      for (long long g = 0; g < total; ++g) {
        const long long t = blockIdx.x + g / steps * gridDim.x;
        const int st = static_cast<int>(g % steps);
        const int m0 = static_cast<int>(t / tiles_n) * BM, n0 = static_cast<int>(t % tiles_n) * BN;
        const int sg = static_cast<int>(g % STAGES);
        mbar_wait(empty + 8 * sg, ((g / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * sg, L::X + L::Q);
        tma_load_2d(base + L::X_OFF + sg * L::X, &xmap, full + 8 * sg, st * BK, m0);
        tma_load_2d(base + L::Q_OFF + sg * L::Q, &qmap, full + 8 * sg, n0 / 2, st * BK);
      }
    }
  } else {  // two consumer warpgroups: rows [64 * cg, +64) of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    const int cgi = warp >> 2, wq = warp & 3;
    // widen step g's nibbles, once the consumers have released the widened
    // buffer's previous step (g - WIDE)
    auto widen = [&](long long g) {
      const int sg = static_cast<int>(g % STAGES), wg_ = static_cast<int>(g % WIDE);
      mbar_wait(wempty + 8 * wg_, ((g / WIDE) & 1) ^ 1);
      mbar_wait(full + 8 * sg, (g / STAGES) & 1);
      widen_kn4<BN>(smem + L::Q_OFF + sg * L::Q, smem + L::W_OFF + wg_ * L::W, threadIdx.x);
      // the generic-proxy writes, visible to wgmma's async proxy
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(wfull + 8 * wg_);
    };
    auto release = [&](long long g) {  // step g's products have read its buffers
      if (lane == 0) {
        mbar_arrive(empty + 8 * static_cast<int>(g % STAGES));
        mbar_arrive(wempty + 8 * static_cast<int>(g % WIDE));
      }
    };
    constexpr bool GROUPED = FN == kGrouped;
    float acc[BN / 2], tot[GROUPED ? BN / 2 : 1];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    if (total > 0) widen(0);
    long long g = 0;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      const long long m0 = t / tiles_n * BM;
      const int n0 = static_cast<int>(t % tiles_n) * BN;
      // step st of the tile; fresh: its sums start from zero
      auto step = [&](int st, bool fresh) {
        const int sg = static_cast<int>(g % STAGES), wg_ = static_cast<int>(g % WIDE);
        mbar_wait(wfull + 8 * wg_, (g / WIDE) & 1);  // its x landed before it was widened
        const uint32_t xa = base + L::X_OFF + sg * L::X + cgi * 64 * 128;
        const uint32_t wa = base + L::W_OFF + wg_ * L::W;
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_bf16_ss(Int<BN>{}, acc, desc_sw128(xa + kk * 32), desc_sw128(wa + kk * 32),
                        !fresh || kk > 0);
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        // keep this step in flight; the previous one has finished reading
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        if (st > 0) release(g - 1);
        // the next step's weights, widened while this step's products run
        if (g + 1 < total) widen(g + 1);
        ++g;
      };
      if constexpr (GROUPED) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) tot[i] = 0.0f;
        const int c2 = 2 * (lane & 3);
        for (int st = 0; st < steps; st += 2) {  // a group: two steps of 64
          step(st, true);
          step(st + 1, false);
          asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) fence_acc(acc[i]);
          // acc[4 j + 2 h + c] is column n0 + 8 j + c2 + c
          const float* grow = sc + static_cast<long long>(st / 2) * n + n0 + c2;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const float2 gv = n0 + 8 * j + c2 < n ? __ldg(reinterpret_cast<const float2*>(grow + 8 * j))
                                                  : make_float2(0.0f, 0.0f);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              tot[4 * j + e] = __fadd_rn(tot[4 * j + e],
                                         __fmul_rn(bf16_round(acc[4 * j + e]), e & 1 ? gv.y : gv.x));
          }
        }
      } else {
        for (int st = 0; st < steps; ++st) step(st, st == 0);
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_acc(acc[i]);
      release(g - 1);
      // accumulator fragment: warp wq holds rows 16 wq + lane / 4 (+ 8);
      // acc[4 j + 2 h + c] is column 8 j + 2 (lane % 4) + c of row + 8 h.
      // The 4 lanes of a row hold 32 columns in 4 words each (j = 4 jg +
      // 0..3); a 4 x 4 transpose of the words across them leaves lane c
      // with columns 32 jg + 8 c .. + 7, stored as 16 bytes.
      const long long row0 = m0 + cgi * 64 + wq * 16 + (lane >> 2);
      const int c4 = lane & 3;
#pragma unroll
      for (int jg = 0; jg < BN / 32; ++jg) {
        const int col = n0 + 32 * jg + 8 * c4;
        float cs[4][2] = {};
        if constexpr (!GROUPED) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int cc = n0 + 8 * (4 * jg + jj) + 2 * c4;
            cs[jj][0] = cc < n ? __ldg(sc + cc) : 0.0f;
            cs[jj][1] = cc + 1 < n ? __ldg(sc + cc + 1) : 0.0f;
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t w[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int j = 4 * jg + jj;
            __nv_bfloat162 v;
            if constexpr (GROUPED) {
              v.x = __float2bfloat16_rn(tot[4 * j + 2 * h]);
              v.y = __float2bfloat16_rn(tot[4 * j + 2 * h + 1]);
            } else {
              v.x = bf16_scale(acc[4 * j + 2 * h], cs[jj][0]);
              v.y = bf16_scale(acc[4 * j + 2 * h + 1], cs[jj][1]);
            }
            w[jj] = *reinterpret_cast<uint32_t*>(&v);
          }
#pragma unroll
          for (int bit = 1; bit <= 2; bit <<= 1) {
            const bool hi = c4 & bit;
#pragma unroll
            for (int p0 = 0; p0 < 4; ++p0) {
              if (p0 & bit) continue;
              const uint32_t got = __shfl_xor_sync(0xffffffffu, hi ? w[p0] : w[p0 + bit], bit);
              if (hi) w[p0] = got;
              else w[p0 + bit] = got;
            }
          }
          const long long row = row0 + 8 * h;
          if (row >= m || col >= n) continue;
          __nv_bfloat16* o = out + row * n + col;
          if (col + 8 <= n && (n & 7) == 0) {
            *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
          } else {
#pragma unroll
            for (int i = 0; i < 8; ++i)
              if (col + i < n)
                o[i] = __ushort_as_bfloat16(static_cast<unsigned short>(w[i / 2] >> (16 * (i & 1))));
          }
        }
      }
    }
  }
}

template <int BN, int FN>
cudaError_t launch_wgmma(const Args& a, void* xs, int grid, cudaStream_t stream) {
  const Product& pr = a.p[0];
  const void* xt = a.x;
  cudaError_t err = cudaSuccess;
  if constexpr (FN == kRank1) {
    const long long chunks = a.m * a.k / 8;
    mm4_fold<<<static_cast<unsigned>((chunks + 255) / 256), 256, 0, stream>>>(
        static_cast<const uint4*>(a.x), pr.rs, static_cast<uint4*>(xs), chunks, a.k, a.group);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    xt = xs;
  }
  CUtensorMap xmap, qmap;
  if (!tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, xt, a.m, a.k, BM, BK,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&qmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, pr.qp, a.k, pr.n / 2, BK, BN / 2,
                  CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  auto kernel = mm4_wgmma<BN, FN>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<BN>::ALLOC);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, Smem<BN>::ALLOC, stream>>>(
      xmap, qmap, FN == kGrouped ? pr.gs : pr.s, static_cast<__nv_bfloat16*>(pr.out), a.m, pr.n,
      a.k);
  return cudaGetLastError();
}

}  // namespace wg

// rank-1: 128 x 256 or 128 x 128 tiles; grouped: 128 x 128 (its second sum
// fits beside the first)
cudaError_t wgmma_launch(const Args& a, int fn, int bn, void* xs, int grid, cudaStream_t stream) {
  if (fn == kGrouped) return bn == 128 ? wg::launch_wgmma<128, kGrouped>(a, xs, grid, stream)
                                       : cudaErrorInvalidValue;
  if (bn == 256) return wg::launch_wgmma<256, kRank1>(a, xs, grid, stream);
  if (bn == 128) return wg::launch_wgmma<128, kRank1>(a, xs, grid, stream);
  return cudaErrorInvalidValue;
}
#endif  // IN_PART(3)

#if IN_PART(0)

// ------------------------------------------------------------------ f32

// f32 mode: a 32 x 32 output tile per block, each thread a 2 x 2 block of
// it, f32 FMAs over 32-deep steps staged in shared memory; x scaled by rs
// (rank-1) as it is staged, the nibbles widened as they are staged, and the
// grouped partials closed at each group's end.
template <int FN>
__global__ void __launch_bounds__(256) mm4_f32(const Args a) {
  constexpr bool NT = FN == kChannel;
  __shared__ float xs[32][33];
  __shared__ float qs[32][33];  // qs[depth][column]
  const Product& pr = a.p[0];
  const auto* x = static_cast<const float*>(a.x);
  auto* out = static_cast<float*>(pr.out);
  const long long m = a.m;
  const int n = pr.n, k = a.k;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n0 = blockIdx.x * 32;
  const long long m0 = (long long)blockIdx.y * 32;
  float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}}, tot[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  for (int k0 = 0; k0 < k; k0 += 32) {
    for (int e = threadIdx.x; e < 32 * 32; e += 256) {
      const int i = e / 32, j = e % 32;  // j runs along the contiguous axis
      const long long row = m0 + i;
      float xv = row < m && k0 + j < k ? x[row * k + k0 + j] : 0.0f;
      if (FN == kRank1 && k0 + j < k) xv *= pr.rs[(k0 + j) / a.group];
      xs[i][j] = xv;
      if constexpr (NT) {  // qp [N, K/2]: row n0 + i, depth k0 + j
        float v = 0.0f;
        if (n0 + i < n && k0 + j < k) {
          const uint8_t b = pr.qp[(long long)(n0 + i) * (k / 2) + (k0 + j) / 2];
          v = static_cast<float>(static_cast<int>(((k0 + j) & 1 ? b >> 4 : b) & 15) - 8);
        }
        qs[j][i] = v;
      } else {  // qp [K, N/2]: depth k0 + i, column n0 + j
        float v = 0.0f;
        if (k0 + i < k && n0 + j < n) {
          const uint8_t b = pr.qp[(long long)(k0 + i) * (n / 2) + (n0 + j) / 2];
          v = static_cast<float>(static_cast<int>(((n0 + j) & 1 ? b >> 4 : b) & 15) - 8);
        }
        qs[i][j] = v;
      }
    }
    __syncthreads();
    for (int kk = 0; kk < 32 && k0 + kk < k; ++kk) {
      const float a0 = xs[ty * 2][kk], a1 = xs[ty * 2 + 1][kk];
      const float b0 = qs[kk][tx * 2], b1 = qs[kk][tx * 2 + 1];
      acc[0][0] = fmaf(a0, b0, acc[0][0]);
      acc[0][1] = fmaf(a0, b1, acc[0][1]);
      acc[1][0] = fmaf(a1, b0, acc[1][0]);
      acc[1][1] = fmaf(a1, b1, acc[1][1]);
      if (FN == kGrouped && (k0 + kk + 1) % a.group == 0) {
        const float* g = pr.gs + (long long)((k0 + kk) / a.group) * n;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int col = n0 + tx * 2 + jj;
          const float gv = col < n ? g[col] : 0.0f;
#pragma unroll
          for (int ii = 0; ii < 2; ++ii) {
            tot[ii][jj] = __fadd_rn(tot[ii][jj], __fmul_rn(acc[ii][jj], gv));
            acc[ii][jj] = 0.0f;
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const long long row = m0 + ty * 2 + i;
      const int col = n0 + tx * 2 + j;
      if (row < m && col < n) out[row * n + col] = FN == kGrouped ? tot[i][j] : acc[i][j] * pr.s[col];
    }
}

#endif  // IN_PART(0)

}  // namespace mm4

#if IN_PART(0)
namespace mm4 {

// The checks and the launch of the C entry. mode 0: x bf16, out bf16;
// mode 1: x f32, out f32. fn 0 rank-1, 1 grouped, 2 channel (qp [N, K/2];
// else [K, N/2]). The plan, from ops/matmul.py::plan_matmul_int4: regime 0
// wgmma (one weight, bm 128, grid persistent blocks: rank-1 bn 128 or 256,
// x folded first into the scratch xs [M, K], two launches; grouped bn 128,
// groups of 128), 1 small-M, 2 tail (bm 8, 16 or 32, bn 64; K splits run as
// clusters of at most 16), 3 f32 (one weight, 32 x 32 tiles), 4 stream
// (rank-1 or grouped with groups of 128, M <= bm, bm the row tile
// st::rows_for(M), bn 256, grid persistent blocks of equal shares of the
// units, splits 1 or the cluster of each column tile's pieces (grid =
// tiles x splits), stages of the ring, xsteps of the x window in the
// shared memory a block has; xs the partial sums' scratch, counters zeros
// a tile). Refuses any other plan, and operands the regime cannot read.
int run(Args& a, void* xs, int* counters, int mode, int fn, int regime, int bm, int bn,
        int splits, int grid, int stages, int xsteps, cudaStream_t stream) {
  const long long m = a.m;
  const int k = a.k, group = a.group;
  if (m <= 0 || k <= 0 || fn < kRank1 || fn > kChannel || a.count < 1 ||
      a.count > MAX_PRODUCTS || (a.count > 1 && (regime == 0 || mode != 0)))
    return cudaErrorInvalidValue;
  const bool nt = fn == kChannel;
  if (fn != kChannel && (group <= 0 || k % group != 0)) return cudaErrorInvalidValue;
  bool aligned = reinterpret_cast<uintptr_t>(a.x) % 16 == 0 && k % 8 == 0;
  int tiles = 0;
  for (int i = 0; i < a.count; ++i) {
    Product& p = a.p[i];
    if (p.n <= 0 || (nt ? k : p.n) % 2 != 0 || p.qp == nullptr || p.out == nullptr)
      return cudaErrorInvalidValue;  // nibble pairs
    if ((fn == kRank1 && (p.rs == nullptr || p.s == nullptr)) ||
        (fn == kGrouped && p.gs == nullptr) || (fn == kChannel && p.s == nullptr))
      return cudaErrorInvalidValue;
    aligned = aligned && reinterpret_cast<uintptr_t>(p.qp) % 16 == 0 &&
              ((nt ? k : p.n) / 2) % 16 == 0 &&
              (fn != kGrouped || reinterpret_cast<uintptr_t>(p.gs) % 16 == 0);
    p.tile0 = tiles;
    tiles += (p.n + TBN - 1) / TBN;
  }
  const int n = a.p[0].n;
  if (mode == 1) {
    const long long f32_tiles = (m + 31) / 32 * ((n + 31) / 32);
    if (regime != 3 || bm != 32 || bn != 32 || splits != 1 || grid != f32_tiles ||
        (m + 31) / 32 > 65535)
      return cudaErrorInvalidValue;
    dim3 blocks((n + 31) / 32, static_cast<unsigned>((m + 31) / 32));
    if (fn == kRank1) mm4_f32<kRank1><<<blocks, 256, 0, stream>>>(a);
    else if (fn == kGrouped) mm4_f32<kGrouped><<<blocks, 256, 0, stream>>>(a);
    else mm4_f32<kChannel><<<blocks, 256, 0, stream>>>(a);
    return cudaGetLastError();
  }
  if (mode != 0 || (fn != kChannel && group % 16 != 0)) return cudaErrorInvalidValue;
  if (regime == 0) {
    const long long wg_tiles = (m + WG_BM - 1) / WG_BM * ((n + bn - 1) / bn);
    const bool rank1 = fn == kRank1 && xs != nullptr && reinterpret_cast<uintptr_t>(xs) % 16 == 0;
    const bool grouped = fn == kGrouped && group == 128 && bn == 128;
    if (!(rank1 || grouped) || !aligned || bm != WG_BM || splits != 1 || grid < 1 ||
        grid > wg_tiles || m >= (1ll << 31))
      return cudaErrorInvalidValue;
    return wgmma_launch(a, fn, bn, xs, grid, stream);
  }
  if (regime == 4) {
    const int steps = (k + st::BK - 1) / st::BK;
    int tiles4 = 0;
    for (int i = 0; i < a.count; ++i) {
      a.p[i].tile0 = tiles4;
      tiles4 += (a.p[i].n + st::BN - 1) / st::BN;
    }
    // splits: the cluster of a split tile's pieces, one a block (shares of
    // steps / splits units), or 1
    const bool clustered = splits > 1 && splits <= 16 && grid == tiles4 * splits &&
                           steps % splits == 0;
    if (fn == kChannel || !aligned || (fn == kGrouped && group != st::BK) || m > 64 ||
        bm != st::rows_for(m) || bn != st::BN || (splits != 1 && !clustered) || grid < 1 ||
        static_cast<long long>(grid) > static_cast<long long>(tiles4) * steps ||
        tiles4 > st::MAX_TILES || stages < 2 || stages > st::MAX_STAGES || xsteps < 1 ||
        xsteps > steps || st::Layout{stages, xsteps, bm}.alloc() > st::SMEM_MAX ||
        xs == nullptr || reinterpret_cast<uintptr_t>(xs) % 16 != 0 || counters == nullptr)
      return cudaErrorInvalidValue;
    float* ws = static_cast<float*>(xs);
    return fn == kRank1 ? stream_rank1(a, bm, grid, stages, xsteps, splits, ws, counters, stream)
                        : stream_grouped(a, bm, grid, stages, xsteps, splits, ws, counters, stream);
  }
  if ((regime != 1 && regime != 2) || (regime == 1 && !aligned) || bm <= 0 ||
      static_cast<long long>(grid) != static_cast<long long>(tiles) * ((m + bm - 1) / bm) * splits)
    return cudaErrorInvalidValue;
  const bool cp = regime == 1;
  if (fn == kRank1) return small_rank1(a, cp, bm, bn, splits, stream);
  if (fn == kGrouped) return small_grouped(a, cp, bm, bn, splits, stream);
  return small_channel(a, cp, bm, bn, splits, stream);
}

}  // namespace mm4

// count weights (at most MAX_PRODUCTS) of one scheme times the same x: one
// launch (two in the rank-1 wgmma regime, which takes one weight). The
// arrays hold count entries each (rs, s or gs by scheme; the others may be
// null). xs: the rank-1 wgmma regime's folded x, the stream regime's
// partial sums; counters: the stream regime's, a zero a column tile.
extern "C" int matmul_int4(const void* x, const void* const* qps, const float* const* rss,
                           const float* const* ss, const float* const* gss, void* const* outs,
                           const int* ns, int count, void* xs, int mode, int fn, int regime,
                           long long m, int k, int group, int bm, int bn, int splits, int grid,
                           int stages, int xsteps, void* counters, void* stream_ptr) {
  if (count < 1 || count > mm4::MAX_PRODUCTS || qps == nullptr || outs == nullptr ||
      ns == nullptr)
    return cudaErrorInvalidValue;
  mm4::Args a = {};
  a.x = x;
  for (int i = 0; i < count; ++i)
    a.p[i] = mm4::Product{static_cast<const uint8_t*>(qps[i]), rss ? rss[i] : nullptr,
                          ss ? ss[i] : nullptr, gss ? gss[i] : nullptr, outs[i], ns[i], 0};
  a.count = count;
  a.m = m;
  a.k = k;
  a.group = group;
  return mm4::run(a, xs, static_cast<int*>(counters), mode, fn, regime, bm, bn, splits, grid,
                  stages, xsteps, static_cast<cudaStream_t>(stream_ptr));
}
#endif
