// int8-weight matrix product of the quantized LM (w8a16):
//   out[M, N] = dt(x[M, K] @ dt(q)) * dt(s[N])
// with f32 accumulation, the product rounded to dt first and then scaled in
// dt, the op order of (x @ q.astype(dt)) * s.astype(dt).
//
// Replaces probing_rag_tpu/ops/pallas_matmul.py::_mm_kernel (matmul_int8),
// which converts int8 weight tiles to the compute dtype in VMEM so that the
// weight reads from HBM stay int8. q is [K, N] (the seven layer families,
// the untied head) or, with transpose_rhs, [N, K] (the tied [V, D] head,
// read along its contiguous D); s holds one f32 scale per output column.
// ops/matmul.py::plan_matmul picks one of three regimes from the shapes.
//
// wgmma (prefill: M > 64, operands TMA can describe, and 32 output tiles
// or more, so that its unsplit persistent blocks fill the card). At M = 8
// x prompt length (~29K) the work is ~58K flop per weight byte, so the bf16 tensor
// cores bound it: 2 M N K flop at 989 TFLOP/s (2.0 ms for [29696 x 2048 ->
// 16384]). One persistent block per SM walks 128 x BN output tiles (BN 256,
// 128 for N <= 128) in N-fastest order, so the int8 weights stay in L2
// while x streams once. Warp-specialised: one thread of the producer
// warpgroup keeps TMA loads of the bf16 x tile (128B-swizzled) and of the
// int8 weight tile in flight in a ring of STAGES, mbarriers marking each
// stage full and empty. Two consumer warpgroups each run wgmma m64nBNk16
// over 64 rows of the tile, f32 sums in registers, and while a step's
// products run they widen the next step's int8 tile into bf16 in shared
// memory (exact for |q| <= 127, the widen16 trick below; one of WIDE
// buffers), K-major in the same 128B swizzle as x: a [K, N] tile is
// transposed on the way in 8 x 8 blocks in registers, an [N, K] tile is
// copied along. Device memory sees int8 weights only. The epilogue rounds
// and scales (bf16_scale) from registers and writes bf16, 16 bytes a lane
// after a 4 x 4 exchange of words within each quad of lanes.
//
// small-M (decode, and products with too few tiles for wgmma) and tail
// (operands TMA cannot describe: K % 8, N % 16 for [K, N], K % 16 for
// [N, K], unaligned bases). At decode (M = 8)
// the work is ~16 flop per weight byte, so the int8 weight read bounds it:
// 110.1 M bytes per Gemma-2B layer (33 us at 3.35 TB/s) and 524 MB for the
// tied head (156 us). Output tiles of 16 x 128 (64 x 128 above M = 16; 64
// wide where 128-wide tiles are too few to fill the card). The small-M
// kernel keeps STAGES - 1 steps of 16-byte cp.async copies, coalesced
// along the contiguous axis of either layout, in flight in a ring, widens
// each int8 tile in shared memory and runs WMMA 16x16x16 bf16 products in
// two groups of 4 warps, each over half of every step's depth (half the
// chain of dependent products); the tail kernel checks every element and
// stages one step ahead through registers. When the output tiles alone
// cannot keep every SM streaming weights, K is split over blocks, and the
// splits of a tile run as one thread block cluster: each keeps its f32
// sums in shared memory, and after a cluster barrier each block sums its
// slice of the tile over all of them (distributed shared memory) in split
// order, so the result is the same bits on every run. One launch per
// product, and no device-memory round trip for the partial sums.
//
// An f32 mode (the tiny test configs) uses f32 FMAs, no TF32. Offsets into
// x, q and out are 64-bit: a full-logits product at prefill has ~7.4 G
// outputs.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

using namespace nvcuda;
namespace cg = cooperative_groups;

namespace {

using namespace hop;

__device__ __forceinline__ __nv_bfloat16 bf16_scale(float acc, float s) {
  // round the f32 sum to bf16, then multiply by the bf16 scale in bf16 (the
  // product of two bf16 values is exact in f32, so one rounding)
  const float a = __bfloat162float(__float2bfloat16_rn(acc));
  return __float2bfloat16_rn(a * __bfloat162float(__float2bfloat16_rn(s)));
}

// 16 int8 values -> 16 bf16 values (lo: the first 8), exactly
__device__ __forceinline__ void widen16(uint4 v, uint4& lo, uint4& hi) {
  uint32_t o[8];
  hop::widen16(v, o);
  lo = make_uint4(o[0], o[1], o[2], o[3]);
  hi = make_uint4(o[4], o[5], o[6], o[7]);
}

// ---------------------------------------------------------------- wgmma

namespace wg {

constexpr int BM = 128;          // output rows per tile: two warpgroups of 64
constexpr int BK = 64;           // depth per step: one 128-byte bf16 row
constexpr int STAGES = 4;        // TMA ring of x and int8 tiles
constexpr int WIDE = 2;          // ring of widened bf16 weight tiles
constexpr int THREADS = 384;     // consumers (warps 0-7), producer (8-11)
constexpr int WIDEN_THREADS = 256;  // the consumers widen the weight tiles
// setmaxnreg moves registers only within the block: the 384 x 168 it was
// launched with, so 2 x (CONSUMER - 168) <= 168 - PRODUCER
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;

template <int BN>
struct Smem {
  static constexpr int X = BM * BK * 2;  // bf16 x tile, 128B-swizzled
  static constexpr int Q = BN * BK;      // int8 weight tile as TMA wrote it
  static constexpr int W = BN * BK * 2;  // widened bf16 tile, K-major, swizzled
  static constexpr int X_OFF = 0;
  static constexpr int Q_OFF = X_OFF + STAGES * X;
  static constexpr int W_OFF = Q_OFF + STAGES * Q;
  static constexpr int BAR_OFF = W_OFF + WIDE * W;
  static constexpr int BYTES = BAR_OFF + 8 * (2 * STAGES + 2 * WIDE);
  static constexpr int ALLOC = BYTES + 1024;  // room to align the base to 1024
};

__device__ __forceinline__ void fence_acc(float& v) { asm volatile("" : "+f"(v)::"memory"); }

// [K, N] tile: TMA wrote BK rows of BN bytes. Thread block b covers 8 rows
// (k) x 8 bytes (n) and writes 8 rows (n) of 16 bytes (k) of the K-major
// bf16 tile: the 8 x 8 transpose happens in registers. Blocks run n-fastest
// over the lanes, so the 8-byte reads of a 16-lane phase fill one 128-byte
// row; each lane writes its 8 rows starting at row (lane & 7), so the
// 16-byte writes of an 8-lane phase land in 8 different chunks of the
// swizzle: both conflict-free.
template <int BN>
__device__ __forceinline__ void widen_kn(const uint8_t* q8, uint8_t* wb, int wt) {
  constexpr int NB = BN / 8;
  constexpr int PER = ((BK / 8) * NB + WIDEN_THREADS - 1) / WIDEN_THREADS;
  const int rot = wt & 7;
  uint32_t sel[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) sel[j] = 0x7540 | ((j ^ rot) & 3);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int b = wt + i * WIDEN_THREADS;
    if (b >= (BK / 8) * NB) break;
    const int nb = b % NB, kb = b / NB;
    uint32_t lo[8], hi[8];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint2 v = *reinterpret_cast<const uint2*>(q8 + (kb * 8 + kk) * BN + nb * 8);
      // bytes n 0-3 in lo, 4-7 in hi; swapped when this lane starts at n >= 4
      lo[kk] = (rot & 4 ? v.y : v.x) ^ 0x80808080u;
      hi[kk] = (rot & 4 ? v.x : v.y) ^ 0x80808080u;
    }
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const uint32_t* w = it < 4 ? lo : hi;
      const uint32_t sl = sel[it & 3];
      float f[8];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        f[kk] = __uint_as_float(__byte_perm(w[kk], 0x4B000000u, sl)) - 8388736.0f;
      const uint4 o = make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                                 pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
      *reinterpret_cast<uint4*>(wb + sw128(nb * 8 + (it ^ rot), kb)) = o;
    }
  }
}

// [N, K] tile: TMA wrote BN rows of BK bytes, already K-major; each thread
// widens 16-byte chunks into two 16-byte chunks of the swizzled tile.
template <int BN>
__device__ __forceinline__ void widen_nk(const uint8_t* q8, uint8_t* wb, int wt) {
  constexpr int PER = BN * BK / 16 / WIDEN_THREADS;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = wt + i * WIDEN_THREADS;
    const int r = c / (BK / 16), kc = c % (BK / 16);
    uint4 lo, hi;
    widen16(*reinterpret_cast<const uint4*>(q8 + r * BK + kc * 16), lo, hi);
    *reinterpret_cast<uint4*>(wb + sw128(r, 2 * kc)) = lo;
    *reinterpret_cast<uint4*>(wb + sw128(r, 2 * kc + 1)) = hi;
  }
}

template <int BN>
__device__ __forceinline__ void wgmma_step(float (&acc)[BN / 2], uint64_t da, uint64_t db,
                                           int scale_d) {
  wgmma_bf16_ss(Int<BN>{}, acc, da, db, scale_d);
}

// Persistent warp-specialised kernel: block b takes tiles b, b + grid, ...
// of 128 x BN outputs, tile t at rows (t / tiles_n) * 128 and columns
// (t % tiles_n) * BN. Every role walks the same sequence of steps g
// (tiles x K steps): stage g % STAGES of the TMA ring and buffer g % WIDE
// of the widened ring, with the parity of g / STAGES (g / WIDE) as the
// phase of their barriers.
template <int BN, bool NT>
__global__ void __launch_bounds__(THREADS, 1)
mm_wgmma(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap qmap,
         const float* __restrict__ s, __nv_bfloat16* __restrict__ out, long long m, int n, int k) {
  using L = Smem<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + L::BAR_OFF;      // TMA landed: x and int8 of a stage
  const uint32_t empty = full + 8 * STAGES;     // stage read by consumers and wideners
  const uint32_t wfull = empty + 8 * STAGES;    // widened tile written
  const uint32_t wempty = wfull + 8 * WIDE;     // widened tile read by wgmma
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
      // step g of this block: tile blockIdx.x + (g / steps) * gridDim.x, depth g % steps
      for (long long g = 0; g < total; ++g) {
        const long long t = blockIdx.x + g / steps * gridDim.x;
        const int st = static_cast<int>(g % steps);
        const int m0 = static_cast<int>(t / tiles_n) * BM, n0 = static_cast<int>(t % tiles_n) * BN;
        const int sg = static_cast<int>(g % STAGES);
        mbar_wait(empty + 8 * sg, ((g / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * sg, L::X + L::Q);
        tma_load_2d(base + L::X_OFF + sg * L::X, &xmap, full + 8 * sg, st * BK, m0);
        if constexpr (NT) tma_load_2d(base + L::Q_OFF + sg * L::Q, &qmap, full + 8 * sg, st * BK, n0);
        else tma_load_2d(base + L::Q_OFF + sg * L::Q, &qmap, full + 8 * sg, n0, st * BK);
      }
    }
  } else {  // two consumer warpgroups: rows [64 * cg, +64) of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    const int cg = warp >> 2, wq = warp & 3;
    // widen step g's weights into its widened buffer, once the consumers
    // have released the buffer's previous step (g - WIDE)
    auto widen = [&](long long g) {
      const int sg = static_cast<int>(g % STAGES), wg_ = static_cast<int>(g % WIDE);
      mbar_wait(wempty + 8 * wg_, ((g / WIDE) & 1) ^ 1);
      mbar_wait(full + 8 * sg, (g / STAGES) & 1);
      const uint8_t* q8 = smem + L::Q_OFF + sg * L::Q;
      uint8_t* wb = smem + L::W_OFF + wg_ * L::W;
      if constexpr (NT) widen_nk<BN>(q8, wb, threadIdx.x);
      else widen_kn<BN>(q8, wb, threadIdx.x);
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
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    if (total > 0) widen(0);
    long long g = 0;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      const long long m0 = t / tiles_n * BM;
      const int n0 = static_cast<int>(t % tiles_n) * BN;
      for (int st = 0; st < steps; ++st, ++g) {
        const int sg = static_cast<int>(g % STAGES), wg_ = static_cast<int>(g % WIDE);
        mbar_wait(wfull + 8 * wg_, (g / WIDE) & 1);  // its x landed before it was widened
        const uint32_t xa = base + L::X_OFF + sg * L::X + cg * 64 * 128;
        const uint32_t wa = base + L::W_OFF + wg_ * L::W;
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_step<BN>(acc, desc_sw128(xa + kk * 32), desc_sw128(wa + kk * 32), st > 0 || kk > 0);
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        // keep this step in flight; the previous one has finished reading
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        if (st > 0) release(g - 1);
        // the next step's weights, widened while this step's products run
        if (g + 1 < total) widen(g + 1);
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
      const long long row0 = m0 + cg * 64 + wq * 16 + (lane >> 2);
      const int c4 = lane & 3;
#pragma unroll
      for (int jg = 0; jg < BN / 32; ++jg) {
        const int col = n0 + 32 * jg + 8 * c4;  // this lane's 8 columns after the transpose
        float sc[4][2];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {  // scales of the columns before the transpose
          const int cc = n0 + 8 * (4 * jg + jj) + 2 * c4;
          sc[jj][0] = cc < n ? __ldg(s + cc) : 0.0f;
          sc[jj][1] = cc + 1 < n ? __ldg(s + cc + 1) : 0.0f;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t w[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int j = 4 * jg + jj;
            __nv_bfloat162 v;
            v.x = bf16_scale(acc[4 * j + 2 * h], sc[jj][0]);
            v.y = bf16_scale(acc[4 * j + 2 * h + 1], sc[jj][1]);
            w[jj] = *reinterpret_cast<uint32_t*>(&v);
          }
          // transpose: pairs of lanes (xor 1) on word pairs (0, 1), (2, 3),
          // then (xor 2) on (0, 2), (1, 3)
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

template <int BN, bool NT>
cudaError_t launch_wgmma(const void* x, const void* q, const float* s, void* out, long long m,
                         int n, int k, int grid, cudaStream_t stream) {
  CUtensorMap xmap, qmap;
  if (!tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, m, k, BM, BK,
                  CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  const bool ok = NT ? tensor_map(&qmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, n, k, BN, BK,
                                  CU_TENSOR_MAP_SWIZZLE_NONE)
                     : tensor_map(&qmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, k, n, BK, BN,
                                  CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!ok) return cudaErrorInvalidValue;
  auto kernel = mm_wgmma<BN, NT>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<BN>::ALLOC);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, Smem<BN>::ALLOC, stream>>>(xmap, qmap, s,
                                                     static_cast<__nv_bfloat16*>(out), m, n, k);
  return cudaGetLastError();
}

}  // namespace wg

// ------------------------------------------------------- small-M and tail

constexpr int THREADS = 128;  // 4 warps
constexpr int BN = 128;       // output columns per block
constexpr int CLD = BN + 4;   // f32 row stride of the epilogue tile
constexpr int MAX_SPLITS = 16;  // the largest cluster Hopper runs

// BM rows of x per block, BK depth per step; warps laid WARPS_M x WARPS_N.
template <int BM>
struct Cfg;
template <>
struct Cfg<16> {
  static constexpr int BK = 64, WARPS_M = 1, WARPS_N = 4;
};
template <>
struct Cfg<64> {
  static constexpr int BK = 32, WARPS_M = 2, WARPS_N = 2;
};

// The last steps of a block of either kernel, its f32 sums of the tile in
// cs ([BM][TBN + 4]): with one split, the epilogue. With several, the splits of
// a tile are one thread block cluster (1, 1, splits), its blocks on
// neighbouring SMs: after a cluster barrier block z sums the z-th slice of
// the tile over every split's shared memory, in split order (the same bits
// on every run), and runs the epilogue; a second barrier keeps each block's
// sums alive until the others have read them.
template <int BM, int T, int TBN>
__device__ __forceinline__ void finish_tile(float* cs, const float* __restrict__ s,
                                            __nv_bfloat16* __restrict__ out, long long m, int n) {
  const int n0 = blockIdx.x * TBN;
  const long long m0 = (long long)blockIdx.y * BM;
  const int splits = gridDim.z;
  const int rows = static_cast<int>(min(static_cast<long long>(BM), m - m0));
  const int cols = min(TBN, n - n0);
  if (splits == 1) {
    for (int e = threadIdx.x; e < rows * cols; e += T) {
      const int r = e / cols, c = e % cols;
      out[(m0 + r) * n + n0 + c] = bf16_scale(cs[r * (TBN + 4) + c], s[n0 + c]);
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
    out[(m0 + r) * n + n0 + c] = bf16_scale(v, s[n0 + c]);
  }
  cluster.sync();
}

// ----- small-M: a ring of cp.async stages, STAGES - 1 steps in flight

constexpr int STAGES = 4;
constexpr int RING16_BK = 64;  // depth of a step of the 16-row tiles

template <int BM, bool NT, int TBN>
struct Ring {
  static constexpr int BK = BM == 16 ? RING16_BK : Cfg<BM>::BK;
  static constexpr int XLD = BK + 8;                  // bf16 row stride of x
  static constexpr int QLD = NT ? BK + 8 : TBN + 8;    // bf16 row stride of widened q
  static constexpr int XB = BM * XLD * 2;             // x stage, bf16
  static constexpr int QB = BK * TBN;                  // q stage, int8 as in memory
  static constexpr int WB = (NT ? TBN : BK) * QLD * 2; // widened q, bf16
  static constexpr int BYTES = STAGES * (XB + QB) + WB + 128;  // + alignment
  static_assert(BM * (TBN + 4) * 4 <= STAGES * (XB + QB), "epilogue tile over the stages");
};

// A 16-byte copy into shared memory, zero-filled where !valid. The L2
// fetches the whole 128-byte line: a tile's row of weights is 64 bytes (a
// 64-wide [K, N] tile, or a 64-deep step of an [N, K] one), and its
// neighbour's half of the line is read next.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// Block (x, y, z): output columns [x*BN, +BN), rows [y*BM, +BM), depth
// steps of split z, with SM_THREADS: two groups of 4 warps, each taking
// half of every step's depth, so a warp's chain of products is half as
// long; the two groups' sums are added in a fixed order at the end. Each
// step's x tile (bf16) and int8 weight tile land in a stage of the ring by
// cp.async (zero-filled past M, N and K); the weights are widened into one
// bf16 tile, then the WMMA products. Needs K % 16 and, for [K, N], N % 16,
// with 16-byte-aligned bases.
constexpr int SM_THREADS = 2 * THREADS;
constexpr int KGROUPS = SM_THREADS / THREADS;

template <int BM, bool NT, int TBN>
__global__ void __launch_bounds__(SM_THREADS)
mm_small_m(const uint16_t* __restrict__ x, const int8_t* __restrict__ q,
           const float* __restrict__ s, __nv_bfloat16* __restrict__ out,
           long long m, int n, int k, int steps_per_split) {
  using R = Ring<BM, NT, TBN>;
  constexpr int SCLD = TBN + 4;  // f32 row stride of the epilogue tile
  constexpr int BK = R::BK, HK = BK / KGROUPS;
  constexpr int WM = BM / Cfg<BM>::WARPS_M, WN = TBN / Cfg<BM>::WARPS_N;
  constexpr int FM = WM / 16, FN = WN / 16;
  extern __shared__ unsigned char ring_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(ring_raw) + 127) & ~static_cast<uintptr_t>(127));
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(ring + STAGES * (R::XB + R::QB));

  const int n0 = blockIdx.x * TBN;
  const long long m0 = (long long)blockIdx.y * BM;
  const int nsteps = (k + BK - 1) / BK;
  const int s_begin = blockIdx.z * steps_per_split;
  const int count = min(nsteps, s_begin + steps_per_split) - s_begin;
  const int warp = threadIdx.x >> 5;
  const int kg = warp / 4;  // depth group: [kg * HK, +HK) of each step
  const int wr = (warp % 4 / Cfg<BM>::WARPS_N) * WM;
  const int wc = (warp % 4 % Cfg<BM>::WARPS_N) * WN;

  // step st's copies into stage sg: x [BM][XLD] then q [BK][TBN] or [TBN][BK]
  auto issue = [&](int st, int sg) {
    const int k0 = st * BK;
    const uint32_t xd = base + sg * (R::XB + R::QB), qd = xd + R::XB;
#pragma unroll
    for (int i = 0; i < (BM * BK / 8 + SM_THREADS - 1) / SM_THREADS; ++i) {
      const int c = threadIdx.x + i * SM_THREADS;
      if (c >= BM * BK / 8) break;
      const int r = c / (BK / 8), kc = k0 + (c % (BK / 8)) * 8;
      const bool ok = m0 + r < m && kc < k;
      cp_async16(xd + (r * R::XLD + (c % (BK / 8)) * 8) * 2, ok ? x + (m0 + r) * k + kc : x, ok);
    }
#pragma unroll
    for (int i = 0; i < (BK * TBN / 16 + SM_THREADS - 1) / SM_THREADS; ++i) {
      const int c = threadIdx.x + i * SM_THREADS;
      if (c >= BK * TBN / 16) break;
      const int outer = NT ? c / (BK / 16) : c / (TBN / 16);
      const int inner = (NT ? c % (BK / 16) : c % (TBN / 16)) * 16;
      const long long orow = NT ? (long long)n0 + outer : (long long)k0 + outer;
      const int ocol = NT ? k0 + inner : n0 + inner;
      const bool ok = orow < (NT ? n : k) && ocol < (NT ? k : n);
      cp_async16(qd + c * 16, ok ? q + orow * (NT ? k : n) + ocol : q, ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  using BLayout = typename std::conditional<NT, wmma::col_major, wmma::row_major>::type;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < count) issue(s_begin + i, i);
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  for (int i = 0; i < count; ++i) {
    const int sg = i % STAGES;
    asm volatile("cp.async.wait_group %0;" ::"n"(STAGES - 2) : "memory");
    __syncthreads();  // step i landed; every warp is past step i - 1's products
    const unsigned char* q8 = ring + sg * (R::XB + R::QB) + R::XB;
#pragma unroll
    for (int j = 0; j < (BK * TBN / 16 + SM_THREADS - 1) / SM_THREADS; ++j) {
      const int c = threadIdx.x + j * SM_THREADS;
      if (c >= BK * TBN / 16) break;
      const int outer = NT ? c / (BK / 16) : c / (TBN / 16);
      const int inner = (NT ? c % (BK / 16) : c % (TBN / 16)) * 16;
      uint4* dst = reinterpret_cast<uint4*>(qs + outer * R::QLD + inner);
      widen16(*reinterpret_cast<const uint4*>(q8 + c * 16), dst[0], dst[1]);
    }
    __syncthreads();
    // the stage of step i - 1, free now
    if (i + STAGES - 1 < count) issue(s_begin + i + STAGES - 1, (i + STAGES - 1) % STAGES);
    asm volatile("cp.async.commit_group;" ::: "memory");
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(ring + sg * (R::XB + R::QB));
#pragma unroll
    for (int kk = kg * HK; kk < kg * HK + HK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[FM];
#pragma unroll
      for (int f = 0; f < FM; ++f)
        wmma::load_matrix_sync(a[f], xs + (wr + f * 16) * R::XLD + kk, R::XLD);
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> b;
        const int col = wc + j * 16;
        if constexpr (NT) wmma::load_matrix_sync(b, qs + col * R::QLD + kk, R::QLD);
        else wmma::load_matrix_sync(b, qs + kk * R::QLD + col, R::QLD);
#pragma unroll
        for (int f = 0; f < FM; ++f) wmma::mma_sync(acc[f][j], a[f], b, acc[f][j]);
      }
    }
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  // group 0 stores its sums; each later group adds its own to them in
  // turn (the same fragment layout, one f32 addition per output)
  float* cs = reinterpret_cast<float*>(ring);
  for (int g = 0; g < KGROUPS; ++g) {
    if (kg == g) {
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) {
          float* t = cs + (wr + i * 16) * SCLD + wc + j * 16;
          if (g > 0) {
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> sum;
            wmma::load_matrix_sync(sum, t, SCLD, wmma::mem_row_major);
#pragma unroll
            for (int e = 0; e < sum.num_elements; ++e) acc[i][j].x[e] = sum.x[e] + acc[i][j].x[e];
          }
          wmma::store_matrix_sync(t, acc[i][j], SCLD, wmma::mem_row_major);
        }
    }
    __syncthreads();
  }
  finish_tile<BM, SM_THREADS, TBN>(cs, s, out, m, n);
}

// ----- tail: every element checked, one step staged through registers

// One thread's share of a step's operands, held in registers between the
// global load and the shared-memory stage.
template <int BM, bool NT>
struct Tiles {
  static constexpr int BK = Cfg<BM>::BK;
  static constexpr int XPT = BM * BK / 8 / THREADS;   // 16-byte chunks of x (8 bf16)
  static constexpr int QPT = BK * BN / 16 / THREADS;  // 16-byte chunks of q (16 int8)
  uint4 x[XPT];
  uint4 q[QPT];
};

// Loads step k0's chunks, each element checked against M, N and K.
template <int BM, bool NT>
__device__ __forceinline__ void load_step(Tiles<BM, NT>& t, const uint16_t* __restrict__ x,
                                          const int8_t* __restrict__ q, long long m,
                                          int n, int k, long long m0, int n0, int k0) {
  constexpr int BK = Cfg<BM>::BK;
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < Tiles<BM, NT>::XPT; ++i) {
    const int c = tid + i * THREADS;
    const int r = c / (BK / 8), kc = k0 + (c % (BK / 8)) * 8;
    const long long row = m0 + r;
    __align__(16) uint16_t h[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (row < m) {
      const uint16_t* p = x + row * k + kc;
#pragma unroll
      for (int e = 0; e < 8; ++e) h[e] = kc + e < k ? p[e] : 0;
    }
    t.x[i] = *reinterpret_cast<const uint4*>(h);
  }
#pragma unroll
  for (int i = 0; i < Tiles<BM, NT>::QPT; ++i) {
    const int c = tid + i * THREADS;
    // [K, N]: BK rows of BN bytes; [N, K]: BN rows of BK bytes
    const int outer = NT ? c / (BK / 16) : c / (BN / 16);
    const int inner = (NT ? c % (BK / 16) : c % (BN / 16)) * 16;
    const long long orow = NT ? (long long)n0 + outer : (long long)k0 + outer;
    const int ocol = NT ? k0 + inner : n0 + inner;
    const long long rows = NT ? n : k;
    const int cols = NT ? k : n;
    __align__(16) int8_t b[16] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
    if (orow < rows) {
      const int8_t* p = q + orow * cols + ocol;
#pragma unroll
      for (int e = 0; e < 16; ++e) b[e] = ocol + e < cols ? p[e] : 0;
    }
    t.q[i] = *reinterpret_cast<const uint4*>(b);
  }
}

// Writes the registers into shared memory, widening int8 to bf16.
// xs: [BM][BK + 8] row-major; qs: [BK][BN + 8] (q is [K, N]) or
// [BN][BK + 8] (q is [N, K], read as a column-major [K, N]).
template <int BM, bool NT>
__device__ __forceinline__ void stage_step(const Tiles<BM, NT>& t, __nv_bfloat16* xs,
                                           __nv_bfloat16* qs) {
  constexpr int BK = Cfg<BM>::BK;
  constexpr int XLD = BK + 8;
  constexpr int QLD = NT ? BK + 8 : BN + 8;
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < Tiles<BM, NT>::XPT; ++i) {
    const int c = tid + i * THREADS;
    *reinterpret_cast<uint4*>(xs + (c / (BK / 8)) * XLD + (c % (BK / 8)) * 8) = t.x[i];
  }
#pragma unroll
  for (int i = 0; i < Tiles<BM, NT>::QPT; ++i) {
    const int c = tid + i * THREADS;
    const int outer = NT ? c / (BK / 16) : c / (BN / 16);
    const int inner = (NT ? c % (BK / 16) : c % (BN / 16)) * 16;
    uint4* dst = reinterpret_cast<uint4*>(qs + outer * QLD + inner);
    widen16(t.q[i], dst[0], dst[1]);
  }
}

// Block (x, y, z) as in mm_small_m, for any shape and alignment: the next
// step's global loads are issued before this step's products.
template <int BM, bool NT>
__global__ void __launch_bounds__(THREADS)
mm_tail(const uint16_t* __restrict__ x, const int8_t* __restrict__ q,
        const float* __restrict__ s, __nv_bfloat16* __restrict__ out,
        long long m, int n, int k, int steps_per_split) {
  constexpr int BK = Cfg<BM>::BK;
  constexpr int WM = BM / Cfg<BM>::WARPS_M, WN = BN / Cfg<BM>::WARPS_N;
  constexpr int FM = WM / 16, FN = WN / 16;
  constexpr int XLD = BK + 8;
  constexpr int QLD = NT ? BK + 8 : BN + 8;
  constexpr int XS = BM * XLD * 2, QS = (NT ? BN : BK) * QLD * 2;
  constexpr int CS = BM * CLD * 4;
  constexpr int SMEM = (XS + QS) > CS ? (XS + QS) : CS;
  __shared__ __align__(128) unsigned char smem[SMEM];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + XS);
  float* cs = reinterpret_cast<float*>(smem);  // after the last step

  const int n0 = blockIdx.x * BN;
  const long long m0 = (long long)blockIdx.y * BM;
  const int nsteps = (k + BK - 1) / BK;
  const int s_begin = blockIdx.z * steps_per_split;
  const int s_end = min(nsteps, s_begin + steps_per_split);
  const int warp = threadIdx.x >> 5;
  const int wr = (warp / Cfg<BM>::WARPS_N) * WM;
  const int wc = (warp % Cfg<BM>::WARPS_N) * WN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  using BLayout = typename std::conditional<NT, wmma::col_major, wmma::row_major>::type;
  Tiles<BM, NT> t;
  if (s_begin < s_end) load_step<BM, NT>(t, x, q, m, n, k, m0, n0, s_begin * BK);
  for (int st = s_begin; st < s_end; ++st) {
    stage_step<BM, NT>(t, xs, qs);
    __syncthreads();
    if (st + 1 < s_end) load_step<BM, NT>(t, x, q, m, n, k, m0, n0, (st + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[FM];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], xs + (wr + i * 16) * XLD + kk, XLD);
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> b;
        const int col = wc + j * 16;
        if constexpr (NT) wmma::load_matrix_sync(b, qs + col * QLD + kk, QLD);
        else wmma::load_matrix_sync(b, qs + kk * QLD + col, QLD);
#pragma unroll
        for (int i = 0; i < FM; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(cs + (wr + i * 16) * CLD + wc + j * 16, acc[i][j], CLD,
                              wmma::mem_row_major);
  __syncthreads();
  finish_tile<BM, THREADS, BN>(cs, s, out, m, n);
}

// f32 mode: a 32 x 32 output tile per block, each thread a 2 x 2 block of
// it, f32 FMAs over 32-deep steps staged in shared memory.
template <bool NT>
__global__ void __launch_bounds__(256)
mm_int8_f32(const float* __restrict__ x, const int8_t* __restrict__ q,
            const float* __restrict__ s, float* __restrict__ out, long long m, int n, int k) {
  __shared__ float xs[32][33];
  __shared__ float qs[32][33];  // qs[depth][column]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n0 = blockIdx.x * 32;
  const long long m0 = (long long)blockIdx.y * 32;
  float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  for (int k0 = 0; k0 < k; k0 += 32) {
    for (int e = threadIdx.x; e < 32 * 32; e += 256) {
      const int a = e / 32, b = e % 32;  // b runs along the contiguous axis
      const long long row = m0 + a;
      xs[a][b] = row < m && k0 + b < k ? x[row * k + k0 + b] : 0.0f;
      if constexpr (NT) {  // q [N, K]: row n0 + a, depth k0 + b
        qs[b][a] = n0 + a < n && k0 + b < k
                       ? static_cast<float>(q[(long long)(n0 + a) * k + k0 + b]) : 0.0f;
      } else {  // q [K, N]: depth k0 + a, column n0 + b
        qs[a][b] = k0 + a < k && n0 + b < n
                       ? static_cast<float>(q[(long long)(k0 + a) * n + n0 + b]) : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < 32; ++kk) {
      const float a0 = xs[ty * 2][kk], a1 = xs[ty * 2 + 1][kk];
      const float b0 = qs[kk][tx * 2], b1 = qs[kk][tx * 2 + 1];
      acc[0][0] = fmaf(a0, b0, acc[0][0]);
      acc[0][1] = fmaf(a0, b1, acc[0][1]);
      acc[1][0] = fmaf(a1, b0, acc[1][0]);
      acc[1][1] = fmaf(a1, b1, acc[1][1]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const long long row = m0 + ty * 2 + i;
      const int col = n0 + tx * 2 + j;
      if (row < m && col < n) out[row * n + col] = acc[i][j] * s[col];
    }
}

// Launches kernel on grid (N tiles, M tiles, splits); the splits of a tile
// form one cluster.
template <typename... Params, typename... Args>
cudaError_t launch_split(void (*kernel)(Params...), dim3 grid, int threads, int smem,
                         cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
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
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int BM, bool NT, int TBN>
cudaError_t launch_bf16(const void* x, const void* q, const float* s, void* out, long long m,
                        int n, int k, int splits, bool tail, cudaStream_t stream) {
  const int BK = tail ? Cfg<BM>::BK : Ring<BM, NT, TBN>::BK;
  const long long mt = (m + BM - 1) / BM;
  if (mt > 65535 || splits > MAX_SPLITS) return cudaErrorInvalidValue;
  const int nsteps = (k + BK - 1) / BK;
  const int per = (nsteps + splits - 1) / splits;
  if ((splits - 1) * per >= nsteps) return cudaErrorInvalidValue;  // an empty split
  dim3 grid((n + TBN - 1) / TBN, static_cast<unsigned>(mt), splits);
  const auto* xp = static_cast<const uint16_t*>(x);
  const auto* qp = static_cast<const int8_t*>(q);
  const auto* sp = s;
  auto* op = static_cast<__nv_bfloat16*>(out);
  if constexpr (TBN == BN)
    if (tail) return launch_split(mm_tail<BM, NT>, grid, THREADS, 0, stream, xp, qp, sp, op, m, n, k, per);
  return launch_split(mm_small_m<BM, NT, TBN>, grid, SM_THREADS, Ring<BM, NT, TBN>::BYTES, stream,
                      xp, qp, sp, op, m, n, k, per);
}

}  // namespace

// One launch per product. mode 0: x bf16, out bf16; mode 1: x f32, out f32.
// transpose_rhs: q is [N, K]; else [K, N]. regime (mode 0, from
// ops/matmul.py::plan_matmul): 0 wgmma (bn 128 or 256, grid persistent
// blocks), 1 small-M, 2 tail (element-checked loads); bm 16 or 64 for
// regimes 1 and 2, whose K splits (at most MAX_SPLITS) run as clusters.
extern "C" int matmul_int8(const void* x, const void* q, const float* s, void* out, int mode,
                           int transpose_rhs, int regime, long long m, int n, int k, int bm,
                           int bn, int splits, int grid, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (m <= 0 || n <= 0 || k <= 0 || splits < 1) return cudaErrorInvalidValue;
  if (mode == 1) {
    if (splits != 1 || (m + 31) / 32 > 65535) return cudaErrorInvalidValue;
    dim3 blocks((n + 31) / 32, static_cast<unsigned>((m + 31) / 32));
    const auto* xp = static_cast<const float*>(x);
    const auto* qp = static_cast<const int8_t*>(q);
    auto* op = static_cast<float*>(out);
    if (transpose_rhs) mm_int8_f32<true><<<blocks, 256, 0, stream>>>(xp, qp, s, op, m, n, k);
    else mm_int8_f32<false><<<blocks, 256, 0, stream>>>(xp, qp, s, op, m, n, k);
    return cudaGetLastError();
  }
  if (mode != 0) return cudaErrorInvalidValue;
  const bool nt = transpose_rhs != 0;
  if (regime == 0) {
    if (splits != 1 || grid < 1 || m >= (1ll << 31)) return cudaErrorInvalidValue;
    if (bn == 256)
      return nt ? wg::launch_wgmma<256, true>(x, q, s, out, m, n, k, grid, stream)
                : wg::launch_wgmma<256, false>(x, q, s, out, m, n, k, grid, stream);
    if (bn == 128)
      return nt ? wg::launch_wgmma<128, true>(x, q, s, out, m, n, k, grid, stream)
                : wg::launch_wgmma<128, false>(x, q, s, out, m, n, k, grid, stream);
    return cudaErrorInvalidValue;
  }
  const bool tail = regime == 2;
  if ((regime != 1 && !tail) || (bn != BN && (tail || bn != BN / 2))) return cudaErrorInvalidValue;
  if (bn == BN / 2) {
    if (bm == 16)
      return nt ? launch_bf16<16, true, BN / 2>(x, q, s, out, m, n, k, splits, false, stream)
                : launch_bf16<16, false, BN / 2>(x, q, s, out, m, n, k, splits, false, stream);
    if (bm == 64)
      return nt ? launch_bf16<64, true, BN / 2>(x, q, s, out, m, n, k, splits, false, stream)
                : launch_bf16<64, false, BN / 2>(x, q, s, out, m, n, k, splits, false, stream);
    return cudaErrorInvalidValue;
  }
  if (bm == 16)
    return nt ? launch_bf16<16, true, BN>(x, q, s, out, m, n, k, splits, tail, stream)
              : launch_bf16<16, false, BN>(x, q, s, out, m, n, k, splits, tail, stream);
  if (bm == 64)
    return nt ? launch_bf16<64, true, BN>(x, q, s, out, m, n, k, splits, tail, stream)
              : launch_bf16<64, false, BN>(x, q, s, out, m, n, k, splits, tail, stream);
  return cudaErrorInvalidValue;
}
