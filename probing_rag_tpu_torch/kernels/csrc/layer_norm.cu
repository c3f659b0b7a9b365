// The Contriever encoder's LayerNorm of the f32 residual stream, with the
// bias add and the residual add before it folded in.
//
// Replaces no Pallas kernel: the JAX package's encoder
// (probing_rag_tpu/models/encoder.py::encoder_forward) is one jitted
// program, and XLA fuses the bias add of the attention output and of the
// MLP output, the residual add and _ln (:80-83) into the products' epilogue
// and one reduction. In the port one launch computes, for each row of [N,
// D],
//
//   x   = resid + f32(bf16(delta + bias))       (with a delta: :124-131, :134-139)
//   out = (x - mean) * rsqrt(var + eps) * w + b  (f32; mean and var of x)
//   xin = bf16(out)                              (the next product's input)
//
// or, without a delta, the LayerNorm of the embedding sum (:97-102). The
// plain ops take about a dozen kernels with f32 temporaries for it.
//
// Bound on this card: device-memory bytes (a few operations a byte) at the
// index build's 512 x ~380 rows; latency at a query batch's 8 x ~40. The
// kernel reads resid, delta and the row's parameters once and writes out
// and xin once: 12 bytes an element with a delta, 10 without.
//
// Design (the plan is ops/encoder.py::plan_layer_norm's; the entry checks
// it against lnorm::accepts): a warp a row, kWarps rows a block, no
// grid-stride loop. The row is the encoder's D 768, the one width a
// configuration of the repo runs here: lane l takes the 4-wide vectors l +
// 32 j, j < kPer = 6 (16-byte f32 loads of resid, 8-byte bf16 loads of
// delta), issues every load of its row before its first add, and keeps its
// 24 values in registers from the loads to the stores. The mean and the
// variance are two sums over those registers (two passes, as jnp.var
// computes it), each reduced by a butterfly of shfl_xor over the warp:
// every lane ends with the same sum, so no shared memory and no barrier.
// w and b are f32 (models/encoder.py::prepare_params keeps the norms' in
// f32). out may be resid (the caller's residual, updated in place): each
// element is read and written by one thread, and no thread touches
// another's.
//
// Numerics: the bias add is one f32 add rounded to bf16 (torch's bf16 add),
// the residual add and each step of the norm single IEEE f32 operations
// (__fadd_rn, __fmul_rn: nvcc contracts nothing) in the plain version's
// order, so they equal the plain ops given the same mean and variance.
// Those are f32 sums in another order than torch's (whose var is a Welford
// reduction), so out may differ from the plain version by a few f32 ulps
// of the mean and the variance; ops/encoder.py states the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lnorm {

// The plan's rule; ops/encoder.py::plan_layer_norm holds the same
// constants. Host code only (tests/test_torch_encoder_kernels.py compiles
// this namespace with the host compiler and holds the planner's plans to it).
constexpr int kVec = 4;       // f32 values a lane's vector
constexpr int kWarps = 4;     // rows a block, a warp each
constexpr int kWidth = 768;   // the row: Contriever's D
constexpr int kPer = kWidth / (32 * kVec);  // vectors a lane
static_assert(kPer * 32 * kVec == kWidth, "every lane holds whole vectors");
constexpr long long kMaxBlocks = 2147483647;

struct Plan {
  int per, warps, blocks;
};

// false where (rows, d) takes no plan: a row other than kWidth, no rows,
// or more blocks than a grid holds
inline bool plan(long long rows, int d, Plan* p) {
  if (rows < 1 || d != kWidth) return false;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) return false;
  *p = Plan{kPer, kWarps, static_cast<int>(blocks)};
  return true;
}

// The entry's check: (rows, d) takes a plan and the caller's fields are the rule's.
inline bool accepts(long long rows, int d, int per, int warps, int blocks, Plan* p) {
  return plan(rows, d, p) && p->per == per && p->warps == warps && p->blocks == blocks;
}

}  // namespace lnorm

namespace {

using lnorm::kPer;
using lnorm::kWarps;
using lnorm::kWidth;

__device__ __forceinline__ float lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  return s;
}

// Row r = blockIdx.x * kWarps + warp. DELTA: add bf16(delta + bias) first.
template <bool DELTA>
__global__ void __launch_bounds__(kWarps * 32)
    add_layer_norm_rows(const float* resid, const __nv_bfloat16* __restrict__ delta,
                        const __nv_bfloat16* __restrict__ bias, const float* __restrict__ w,
                        const float* __restrict__ b, float* out, __nv_bfloat16* __restrict__ xin,
                        int rows, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long long base = row * kWidth;
  float x[kPer][4];
  uint2 dl[kPer], bb[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {  // every load before the first add
    const int v = lane + 32 * j;
    const float4 r = *reinterpret_cast<const float4*>(resid + base + 4 * v);
    x[j][0] = r.x, x[j][1] = r.y, x[j][2] = r.z, x[j][3] = r.w;
    if constexpr (DELTA) {
      dl[j] = __ldg(reinterpret_cast<const uint2*>(delta + base + 4 * v));
      bb[j] = __ldg(reinterpret_cast<const uint2*>(bias + 4 * v));
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if constexpr (DELTA) {
      const float dv[4] = {lo(dl[j].x), hi(dl[j].x), lo(dl[j].y), hi(dl[j].y)};
      const float bv[4] = {lo(bb[j].x), hi(bb[j].x), lo(bb[j].y), hi(bb[j].y)};
#pragma unroll
      for (int e = 0; e < 4; ++e) x[j][e] = __fadd_rn(x[j][e], round_bf16(__fadd_rn(dv[e], bv[e])));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) s = __fadd_rn(s, x[j][e]);
  }
  const float fd = static_cast<float>(kWidth);
  const float mean = __fdiv_rn(warp_sum(s), fd);
  float ss = 0.0f;
#pragma unroll
  for (int j = 0; j < kPer; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float c = __fsub_rn(x[j][e], mean);
      ss = __fadd_rn(ss, __fmul_rn(c, c));
    }
  const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(ss), fd), eps));
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int v = lane + 32 * j;
    const float4 wv = __ldg(reinterpret_cast<const float4*>(w + 4 * v));
    const float4 bv4 = __ldg(reinterpret_cast<const float4*>(b + 4 * v));
    const float ws[4] = {wv.x, wv.y, wv.z, wv.w}, bs[4] = {bv4.x, bv4.y, bv4.z, bv4.w};
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      y[e] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x[j][e], mean), rstd), ws[e]), bs[e]);
    *reinterpret_cast<float4*>(out + base + 4 * v) = make_float4(y[0], y[1], y[2], y[3]);
    *reinterpret_cast<uint2*>(xin + base + 4 * v) =
        make_uint2(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]));
  }
}

template <bool DELTA>
int launch(const lnorm::Plan& p, const void* resid, const void* delta, const void* bias,
           const void* w, const void* b, void* out, void* xin, int rows, float eps,
           cudaStream_t st) {
  add_layer_norm_rows<DELTA><<<p.blocks, kWarps * 32, 0, st>>>(
      static_cast<const float*>(resid), static_cast<const __nv_bfloat16*>(delta),
      static_cast<const __nv_bfloat16*>(bias), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(out), static_cast<__nv_bfloat16*>(xin),
      rows, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// resid, out: [rows, d] f32 (out may be resid); delta: [rows, d] bf16 and
// bias [d] bf16, or both null (no add); w, b: [d] f32; xin: [rows, d] bf16.
// All 16-byte aligned. The plan (ops/encoder.py::plan_layer_norm): per,
// warps, blocks; any other, or d other than lnorm::kWidth, is refused
// (cudaErrorInvalidConfiguration).
extern "C" int layer_norm(const void* resid, const void* delta, const void* bias, const void* w,
                          const void* b, void* out, void* xin, int rows, int d, float eps,
                          int per, int warps, int blocks, void* stream) {
  if ((delta == nullptr) != (bias == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  lnorm::Plan p;
  if (!lnorm::accepts(rows, d, per, warps, blocks, &p))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return delta != nullptr ? launch<true>(p, resid, delta, bias, w, b, out, xin, rows, eps, st)
                          : launch<false>(p, resid, delta, bias, w, b, out, xin, rows, eps, st);
}
