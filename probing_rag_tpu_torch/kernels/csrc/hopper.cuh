// Hopper building blocks of the kernels that run wgmma (dense_topk.cu,
// ivf_topk.cu, matmul_int8.cu, prefill_attention.cu): mbarriers, TMA tile
// loads (2-D and 4-D) and their tensor maps, bulk copies, named barriers,
// wgmma operand descriptors and products at the power-of-two widths,
// resident operand tiles, and the exact int8 -> bf16 widening.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hop {

template <int V>
struct Int {};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// waits until the phase of parity `parity` of the barrier has completed; a
// wait of more than ~2^35 cycles (~17 s, a lost arrival) faults the launch
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 35)) __trap();
  }
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// generic-proxy writes to shared memory, visible to wgmma's async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on the barrier's transaction count
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// one arrival on the barrier once every cp.async this thread issued has
// landed (the barrier's count includes it: no pending-count increment)
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
}

// barrier `id` (1-15) over `count` threads, a multiple of 32
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// an arrival on barrier `id` without waiting (a bar_sync of the other
// threads completes it)
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// the same barrier, returning whether any of the threads passed true
__device__ __forceinline__ bool bar_any(int id, int count, bool p) {
  uint32_t r;
  asm volatile(
      "{\n.reg .pred pi, po;\nsetp.ne.u32 pi, %1, 0;\n"
      "bar.red.or.pred po, %2, %3, pi;\nselp.u32 %0, 1, 0, po;\n}\n"
      : "=r"(r)
      : "r"(static_cast<uint32_t>(p)), "r"(id), "r"(count)
      : "memory");
  return r != 0;
}

// wgmma descriptor of a tile in the swizzle of span SW (128 or 64 bytes),
// 8-row groups 8 x SW bytes apart. K-major (rows hold the depth): lbo is
// unused. MN-major (rows run along the depth, 16-byte chunks along M or N):
// lbo is the byte offset between blocks of SW bytes along M or N.
template <int SW>
__device__ __forceinline__ uint64_t desc_sw(uint32_t addr, uint32_t lbo = 16) {
  constexpr uint64_t kLayout = SW == 128 ? 1 : 2;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(8 * SW / 16) << 32) | (kLayout << 62);
}

// a K-major tile in the 128-byte swizzle: rows of 128 bytes, 8-row groups
// 1024 bytes apart
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) { return desc_sw<128>(addr); }

// byte offset of 16-byte chunk c of row r in the swizzle of span SW (TMA's
// CU_TENSOR_MAP_SWIZZLE_128B / _64B: address bits 4.. of a chunk XOR
// address bits 7..), the tile based at a multiple of 8 x SW bytes
template <int SW>
__device__ __forceinline__ uint32_t swz_row(int r, int c) {
  return r * SW + ((c ^ ((r * SW >> 7) & (SW / 16 - 1))) << 4);
}
__device__ __forceinline__ uint32_t sw128(int r, int c) { return swz_row<128>(r, c); }

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// ---- wgmma m64nWk16 (bf16, f32 sums) and m64nWk32 (s8, s32 sums) at the
// power-of-two widths W = 8 .. 256. The accumulator fragment of a warp
// group: warp w holds rows 16 w + lane / 4 (+ 8); d[4 j + 2 h + c] is column
// 8 j + 2 (lane % 4) + c of row + 8 h. _ss reads A (64 x 16, K-major) and B
// (W x 16, K-major) through descriptors; _rs takes A from registers in the
// same fragment layout as the accumulator's rows: a[0] = (row, k 2 (lane % 4)
// + 0, 1), a[1] = (row + 8, the same k), a[2] and a[3] the same at k + 8.
// _rs_tb reads B MN-major (transposed: its rows run along k), as a [k, n]
// tile stored n-contiguous.

#define WG_ACC8 "%0, %1, %2, %3"
#define WG_ACC16 "%0, %1, %2, %3, %4, %5, %6, %7"
#define WG_ACC32 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define WG_ACC64 WG_ACC32 ", %16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31"
#define WG_ACC128 WG_ACC64 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, " \
  "%62, %63"
#define WG_ACC256 WG_ACC128 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, " \
  "%76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, " \
  "%94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, " \
  "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, " \
  "%125, %126, %127"

// the accumulators as in-out operands: c is "+f" or "+r"
#define WG_D4(c, i) c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3])
#define WG_D8(c, i) WG_D4(c, i), WG_D4(c, i + 4)
#define WG_D16(c, i) WG_D8(c, i), WG_D8(c, i + 8)
#define WG_D32(c, i) WG_D16(c, i), WG_D16(c, i + 16)
#define WG_D64(c, i) WG_D32(c, i), WG_D32(c, i + 32)
#define WG_D128(c, i) WG_D64(c, i), WG_D64(c, i + 64)

#define WG_STR(x) #x
#define WG_XSTR(x) WG_STR(x)

// W: width; ACC, D: its operand string and list; A0: number of the first
// operand after the accumulators (W / 2)
#define WG_DEFINE(W, ACC, D, A0, A1, A2, A3, A4, A5)                                          \
  __device__ __forceinline__ void wgmma_bf16_ss(Int<W>, float* d, uint64_t da, uint64_t db,  \
                                                int scale_d) {                               \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" WG_XSTR(A2) ", 0;\n"                    \
                 "wgmma.mma_async.sync.aligned.m64n" WG_XSTR(W) "k16.f32.bf16.bf16 {" ACC    \
                 "}, %" WG_XSTR(A0) ", %" WG_XSTR(A1) ", p, 1, 1, 0, 0;\n}\n"                 \
                 : D("+f", 0)                                                                \
                 : "l"(da), "l"(db), "r"(scale_d));                                          \
  }                                                                                          \
  __device__ __forceinline__ void wgmma_bf16_rs(Int<W>, float* d, const uint32_t (&a)[4],    \
                                                uint64_t db, int scale_d) {                  \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" WG_XSTR(A5) ", 0;\n"                    \
                 "wgmma.mma_async.sync.aligned.m64n" WG_XSTR(W) "k16.f32.bf16.bf16 {" ACC    \
                 "}, {%" WG_XSTR(A0) ", %" WG_XSTR(A1) ", %" WG_XSTR(A2) ", %" WG_XSTR(A3)    \
                 "}, %" WG_XSTR(A4) ", p, 1, 1, 0;\n}\n"                                      \
                 : D("+f", 0)                                                                \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));       \
  }                                                                                          \
  __device__ __forceinline__ void wgmma_bf16_rs_tb(Int<W>, float* d, const uint32_t (&a)[4], \
                                                   uint64_t db, int scale_d) {               \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" WG_XSTR(A5) ", 0;\n"                    \
                 "wgmma.mma_async.sync.aligned.m64n" WG_XSTR(W) "k16.f32.bf16.bf16 {" ACC    \
                 "}, {%" WG_XSTR(A0) ", %" WG_XSTR(A1) ", %" WG_XSTR(A2) ", %" WG_XSTR(A3)    \
                 "}, %" WG_XSTR(A4) ", p, 1, 1, 1;\n}\n"                                      \
                 : D("+f", 0)                                                                \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));       \
  }                                                                                          \
  __device__ __forceinline__ void wgmma_s8_ss(Int<W>, int* d, uint64_t da, uint64_t db,      \
                                              int scale_d) {                                 \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" WG_XSTR(A2) ", 0;\n"                    \
                 "wgmma.mma_async.sync.aligned.m64n" WG_XSTR(W) "k32.s32.s8.s8 {" ACC        \
                 "}, %" WG_XSTR(A0) ", %" WG_XSTR(A1) ", p;\n}\n"                             \
                 : D("+r", 0)                                                                \
                 : "l"(da), "l"(db), "r"(scale_d));                                          \
  }

WG_DEFINE(8, WG_ACC8, WG_D4, 4, 5, 6, 7, 8, 9)
WG_DEFINE(16, WG_ACC16, WG_D8, 8, 9, 10, 11, 12, 13)
WG_DEFINE(32, WG_ACC32, WG_D16, 16, 17, 18, 19, 20, 21)
WG_DEFINE(64, WG_ACC64, WG_D32, 32, 33, 34, 35, 36, 37)
WG_DEFINE(128, WG_ACC128, WG_D64, 64, 65, 66, 67, 68, 69)
WG_DEFINE(256, WG_ACC256, WG_D128, 128, 129, 130, 131, 132, 133)

#undef WG_DEFINE

// The widest power of two <= n, at most 256 (n >= 8).
__host__ __device__ constexpr int wg_width(int n) {
  return n >= 256 ? 256 : n >= 128 ? 128 : n >= 64 ? 64 : n >= 32 ? 32 : n >= 16 ? 16 : 8;
}

// One k-step of a product with N columns (a multiple of 8): one wgmma per
// set bit of N / 8, widest first, each on the B rows at its column offset.
// Accumulator d[4 j + 2 h + c] is column 8 j + 2 (lane % 4) + c whatever the
// split, since a width-W product holds W / 2 registers. B's rows are 128
// bytes apart in the swizzled layout, so column offset OFF moves the start
// address by OFF * 128 bytes (OFF * 8 in the descriptor's 16-byte units).
template <int N, int OFF = 0>
__device__ __forceinline__ void mma_bf16_ss(float* d, uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N > 0) {
    constexpr int W = wg_width(N);
    wgmma_bf16_ss(Int<W>{}, d + OFF / 2, da, db + OFF * 8, scale_d);
    mma_bf16_ss<N - W, OFF + W>(d, da, db, scale_d);
  }
}

template <int N, int OFF = 0>
__device__ __forceinline__ void mma_bf16_rs(float* d, const uint32_t (&a)[4], uint64_t db,
                                            int scale_d) {
  if constexpr (N > 0) {
    constexpr int W = wg_width(N);
    wgmma_bf16_rs(Int<W>{}, d + OFF / 2, a, db + OFF * 8, scale_d);
    mma_bf16_rs<N - W, OFF + W>(d, a, db, scale_d);
  }
}

template <int N, int OFF = 0>
__device__ __forceinline__ void mma_s8_ss(int* d, uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N > 0) {
    constexpr int W = wg_width(N);
    wgmma_s8_ss(Int<W>{}, d + OFF / 2, da, db + OFF * 8, scale_d);
    mma_s8_ss<N - W, OFF + W>(d, da, db, scale_d);
  }
}

// An int8 value as a byte u = q + 128 (q ^ 0x80) placed in the mantissa of
// 2^23 makes the float 2^23 + u; subtracting 2^23 + 128 leaves q exactly,
// without the quarter-rate conversion instructions. A small integer's f32
// bits end in 16 zeros, so its top half is its bf16.
__device__ __forceinline__ float byte_f32(uint32_t w, int j) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | j)) - 8388736.0f;
}

// two floats holding small integers -> their bf16 pair (a low, b high)
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// 16 int8 values -> 8 words of bf16 pairs: o[i] holds bytes 2 i, 2 i + 1
__device__ __forceinline__ void widen16(uint4 v, uint32_t (&o)[8]) {
  const uint32_t w[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u, v.z ^ 0x80808080u,
                         v.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = pack_bf16(byte_f32(w[i], 0), byte_f32(w[i], 1));
    o[2 * i + 1] = pack_bf16(byte_f32(w[i], 2), byte_f32(w[i], 3));
  }
}

// A K-major operand tile resident in shared memory: rows [0, n_rows) of a
// row-major matrix of rb bytes a row (a multiple of 16) at src, 128 bytes of
// depth per k-step in the 128-byte swizzle, k-step ch at dst + ch * n_rows *
// 128. Rows at or past `valid` and depth past rb are zeros. With PERMUTE
// (bf16 rows against an int8 A widened into registers, see the kernels),
// the 64 depths of a step are permuted: 16-byte chunk p holds the row's
// words (bf16 pairs) p, p + 8, p + 16, p + 24 of the step.
template <bool PERMUTE>
__device__ void fill_b_tile(const uint8_t* __restrict__ src, int rb, int valid, int n_rows,
                            int chunks, uint8_t* dst, int tid, int nthreads) {
  for (int i = tid; i < chunks * n_rows * 8; i += nthreads) {
    const int p = i & 7, r = (i >> 3) % n_rows, ch = i / (8 * n_rows);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < valid) {
      const uint8_t* row = src + (size_t)r * rb + ch * 128;
      const int left = rb - ch * 128;  // bytes of this step inside the row
      if constexpr (PERMUTE) {
        uint32_t w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int off = 4 * (p + 8 * j);
          w[j] = off < left ? *reinterpret_cast<const uint32_t*>(row + off) : 0u;
        }
        v = make_uint4(w[0], w[1], w[2], w[3]);
      } else if (16 * p < left) {
        v = *reinterpret_cast<const uint4*>(row + 16 * p);
      }
    }
    *reinterpret_cast<uint4*>(dst + ch * n_rows * 128 + sw128(r, p)) = v;
  }
}

// The A fragments of an int8 tile of 64-byte rows (one k-step of 64), rows
// r and r + 8 of a warpgroup's 64 (r = 16 warp + lane / 4): this lane's 16
// bytes 16 (lane % 4) .. + 15 of each, widened to bf16. a[kk] is k16 step
// kk's fragment in the permuted depth order of fill_b_tile: k16 step kk,
// slot 2 (lane % 4) + j (+ 8 h) holds depth 16 (lane % 4) + 4 kk + 2 h + j.
__device__ __forceinline__ void int8_a_fragments(const uint8_t* row_r, uint32_t (&a)[4][4]) {
  uint32_t lo[8], hi[8];
  widen16(*reinterpret_cast<const uint4*>(row_r), lo);
  widen16(*reinterpret_cast<const uint4*>(row_r + 8 * 64), hi);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = lo[2 * kk];
    a[kk][1] = hi[2 * kk];
    a[kk][2] = lo[2 * kk + 1];
    a[kk][3] = hi[2 * kk + 1];
  }
}

// ---- host side: tensor maps

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point query, so the
// library needs no link against libcuda
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a tensor of rank 2-5 given innermost first: dims, byte strides of dims
// 1.. (multiples of 16), boxes; elements past a dim load as zeros
inline bool tensor_map_nd(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* ptr,
                          const cuuint64_t* dims, const cuuint64_t* strides,
                          const cuuint32_t* box, CUtensorMapSwizzle swizzle,
                          CUtensorMapL2promotion l2 = CU_TENSOR_MAP_L2_PROMOTION_L2_256B) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t estr[5] = {1, 1, 1, 1, 1};
  return encode(map, type, rank, const_cast<void*>(ptr), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, l2,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a row-major [rows, cols] tensor of elem-byte elements, boxes of
// [box_rows, box_cols]; rows and columns past the tensor load as zeros
inline bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* ptr,
                       long long rows, long long cols, int box_rows, int box_cols,
                       CUtensorMapSwizzle swizzle,
                       CUtensorMapL2promotion l2 = CU_TENSOR_MAP_L2_PROMOTION_L2_256B) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  return tensor_map_nd(map, type, 2, ptr, dims, strides, box, swizzle, l2);
}

}  // namespace hop
