// The Contriever encoder's MLP activation: exact GELU of the biased first
// product, gelu(bf16(h + b)), in place.
//
// Replaces no Pallas kernel: the JAX package's encoder
// (probing_rag_tpu/models/encoder.py:132, jax.nn.gelu(xin @ w1 + b1,
// approximate=False)) is one jitted program, and XLA fuses the bias add and
// the GELU into the product's epilogue. The plain ops write h + b, then read
// it for each step of the GELU: six kernels and [N, d_ff] temporaries.
//
// Bound on this card: device-memory bytes at the index build's 512 x ~380
// rows of d_ff 3072 (h read once, the result written once into h's buffer,
// the product's output, a temporary); latency at a query batch's 8 x ~40
// rows. Computed in place, libdevice's erfcf (kept for bit-equality with
// torch.erfc) is ~40 instructions an element, which made the first design
// (one pass, a vector a thread) bound by operations: 56% of its byte bound.
//
// Design: the GELU's input is one bf16 value, x = bf16(h + b), so the map
// from x to the bf16 result has 65,536 entries.
//   - gelu_table_build computes them once, at first use on a device (the
//     wrapper caches the table by device), by the exact device function
//     below: entry i is the result for the bf16 value whose bits are i.
//   - the pass forms x exactly as the plain version does (one f32 add,
//     rounded to bf16) and looks its 16 bits up. The result is bit-equal to
//     the exact path by construction, on every input: +-0, +-inf, NaN (as
//     NaN), subnormals.
//   - lookups into the 128 KB table in device memory are scattered 2-byte
//     gathers, so each block first copies a window of it into shared
//     memory: the bf16 values with |x| in [2^-16, 2^8), 24 binades of 128
//     of each sign (12 KB). An index outside the window reads the device
//     table (measured on an H100: 4.2e-4 of chip_smoke.py's synthetic
//     inputs, 2.2e-5 of the encoder's GELU inputs at random weights).
//   - a window fill pays off only over many vectors, so the grid is two
//     resident blocks of 512 an SM (ops/encoder.py::plan_bias_gelu; the
//     entry checks it against bgelu::accepts and reads the SM count
//     itself; other block shapes measured within 2%: scripts/bias_gelu_variants.py). A
//     thread walks vectors of 8 bf16 values (16 bytes), kUnroll at a step,
//     neighbouring threads on neighbouring vectors, the grid's threads apart,
//     and loads the next step's vectors before it looks up the current
//     ones. The first step's loads are issued before the window fill. d_ff
//     is a multiple of 8, so a vector never crosses a row; its bias is
//     vector (i mod d_ff / 8) of the bias row, the column kept by adds.
//
// Numerics, as JAX computes jax.nn.gelu(approximate=False) in f32: x =
// bf16(h + b) (torch's bf16 add), then (0.5 x) erfc(-x sqrt(1/2)) in f32
// (erfcf: libdevice's, as torch.erfc on the card; the erfc form keeps its
// precision where x is negative, where 1 + erf(x / sqrt 2) cancels),
// rounded to bf16 (ops/encoder.py::bias_gelu_plain).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bgelu {

// The plan's rule; ops/encoder.py::plan_bias_gelu holds the same constants.
// Host code only (tests/test_torch_encoder_kernels.py compiles this
// namespace with the host compiler and holds the planner's plans to it).
constexpr int kVec = 8;  // bf16 values a thread's vector (16 bytes)
constexpr int kThreads = 512;
constexpr int kBlocksPerSm = 2;  // resident blocks an SM
constexpr int kUnroll = 2;       // vectors a thread takes a step
constexpr int kWinLo = 0x3780;   // the window's least magnitude bits: 2^-16
constexpr int kWinLen = 24 * 128;  // its patterns of each sign: 24 binades, to 2^8
constexpr int kTable = 65536;      // the table's entries, one a bf16 pattern
constexpr long long kMaxIndex = 2147483647;  // vector indices in 32-bit ints

struct Plan {
  int vec, threads, blocks, unroll, win_lo, win_len;
};

// false where (rows, f) takes no plan: f not a multiple of the vector, or
// vector indices (with a step past the last) past 32-bit ints
inline bool plan(long long rows, int f, int sms, Plan* p) {
  if (rows < 1 || f < kVec || f % kVec || sms < 1) return false;
  const long long vecs = rows * (f / kVec);
  const long long step = static_cast<long long>(kThreads) * kUnroll;  // a block's
  const long long want = (vecs + step - 1) / step;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  const long long blocks = want < cap ? want : cap;
  if (vecs + blocks * step > kMaxIndex) return false;
  *p = Plan{kVec, kThreads, static_cast<int>(blocks), kUnroll, kWinLo, kWinLen};
  return true;
}

// The entry's check: (rows, f) takes a plan on sms SMs and the caller's
// fields are the rule's.
inline bool accepts(long long rows, int f, int sms, int vec, int threads, int blocks, int unroll,
                    int win_lo, int win_len, Plan* p) {
  return plan(rows, f, sms, p) && p->vec == vec && p->threads == threads &&
         p->blocks == blocks && p->unroll == unroll && p->win_lo == win_lo &&
         p->win_len == win_len;
}

}  // namespace bgelu

namespace {

using bgelu::kThreads;
using bgelu::kUnroll;
using bgelu::kWinLen;
using bgelu::kWinLo;

// sqrt(0.5) rounded to f32, as np.sqrt(0.5).astype(float32) in jax.nn.gelu
constexpr float kSqrtHalf = 0.70710678118654752440f;

// Entry i: the exact GELU of the bf16 value whose bits are i, rounded to bf16.
__global__ void __launch_bounds__(256) gelu_table_build(uint16_t* table) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  const float x = __uint_as_float(static_cast<uint32_t>(i) << 16);
  const float y = __fmul_rn(__fmul_rn(0.5f, x), erfcf(__fmul_rn(-x, kSqrtHalf)));
  table[i] = __bfloat16_as_ushort(__float2bfloat16_rn(y));
}

__device__ __forceinline__ float lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// the result for the bf16 pattern u: the window's entry, else the table's
__device__ __forceinline__ uint32_t look(uint32_t u, const uint16_t* win,
                                         const uint16_t* __restrict__ table) {
  const uint32_t off = (u & 0x7fffu) - kWinLo;
  return off < kWinLen ? win[(u >> 15) * kWinLen + off] : __ldg(table + u);
}

// two elements: x = bf16(h + b) of each half, looked up
__device__ __forceinline__ uint32_t gelu2(uint32_t h, uint32_t b, const uint16_t* win,
                                          const uint16_t* __restrict__ table) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(__fadd_rn(lo(h), lo(b)), __fadd_rn(hi(h), hi(b)));
  const uint32_t u = *reinterpret_cast<const uint32_t*>(&x);
  return look(u & 0xffffu, win, table) | (look(u >> 16, win, table) << 16);
}

// A block's step covers kThreads x kUnroll vectors; a thread takes vectors
// i, i + kThreads, ... of it, and the grid's steps lie `stride` apart.
__global__ void __launch_bounds__(kThreads, bgelu::kBlocksPerSm)
    bias_gelu_pass(uint4* h, const uint4* __restrict__ bias, const uint16_t* __restrict__ table,
                   int vecs, int row_vecs) {
  __shared__ __align__(16) uint16_t win[2 * kWinLen];  // [sign][kWinLen]
  const int stride = gridDim.x * kThreads * kUnroll;
  const int step_col = stride % row_vecs;
  int i0 = blockIdx.x * kThreads * kUnroll + threadIdx.x;
  uint4 x[kUnroll];
  int col[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = i0 + u * kThreads;
    col[u] = i % row_vecs;
    if (i < vecs) x[u] = h[i];
  }
  // the window: patterns kWinLo .. of each sign, 16-byte pieces
  constexpr int kPieces = kWinLen * 2 / 16;
  for (int e = threadIdx.x; e < 2 * kPieces; e += kThreads) {
    const int sign = e / kPieces, piece = e - sign * kPieces;
    reinterpret_cast<uint4*>(win)[e] =
        __ldg(reinterpret_cast<const uint4*>(table + (sign << 15) + kWinLo) + piece);
  }
  __syncthreads();
  for (; i0 < vecs; i0 += stride) {
    uint4 next[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {  // the next step's loads, in flight
      const int i = i0 + stride + u * kThreads;
      if (i < vecs) next[u] = h[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      if (i < vecs) {
        const uint4 b = __ldg(bias + col[u]);
        h[i] = make_uint4(gelu2(x[u].x, b.x, win, table), gelu2(x[u].y, b.y, win, table),
                          gelu2(x[u].z, b.z, win, table), gelu2(x[u].w, b.w, win, table));
      }
      x[u] = next[u];
      col[u] += step_col;
      if (col[u] >= row_vecs) col[u] -= row_vecs;
    }
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

}  // namespace

// table: [65536] bf16, 16-byte aligned, filled with the exact GELU of each
// bf16 pattern (one launch).
extern "C" int gelu_table(void* table, void* stream) {
  gelu_table_build<<<bgelu::kTable / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint16_t*>(table));
  return static_cast<int>(cudaGetLastError());
}

// h: [rows, f] bf16, overwritten with the result; bias: [f] bf16; table:
// gelu_table's; all 16-byte aligned. The plan (ops/encoder.py::plan_bias_gelu,
// for the current device's SM count): vec, threads, blocks, unroll, win_lo,
// win_len; any other is refused (cudaErrorInvalidConfiguration).
extern "C" int bias_gelu(void* h, const void* bias, const void* table, int rows, int f, int vec,
                         int threads, int blocks, int unroll, int win_lo, int win_len,
                         void* stream) {
  bgelu::Plan p;
  if (!bgelu::accepts(rows, f, sm_count(), vec, threads, blocks, unroll, win_lo, win_len, &p))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int row_vecs = f / bgelu::kVec;
  bias_gelu_pass<<<p.blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(h), static_cast<const uint4*>(bias),
      static_cast<const uint16_t*>(table), rows * row_vecs, row_vecs);
  return static_cast<int>(cudaGetLastError());
}
