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
// rows of d_ff 3072 (4 bytes an element against ~30 instructions, most of
// them erfcf's: the arithmetic is most of the byte time, so the loads must
// overlap it); latency at a query batch's 8 x ~40 rows. The kernel reads h
// once and writes the result once, into h's buffer (the product's output,
// a temporary); the bias row stays in L1 and L2.
//
// Design (the plan is ops/encoder.py::plan_bias_gelu's; the entry checks it
// against bgelu::accepts): one pass, a 16-byte vector of 8 bf16 values a
// thread, neighbouring threads on neighbouring vectors, kThreads a block and
// as many blocks as the vectors need. No loop and 32-bit indices: a thread
// issues its two loads, computes, stores and exits (gated_act.cu's design,
// which on this card takes a same-bytes add's time at a prefill's rows).
// d_ff is a multiple of 8, so a vector never crosses a row and its bias is
// vector (i mod d_ff / 8) of the bias row. In place: each vector is read,
// then written, by one thread.
//
// Numerics, as JAX computes jax.nn.gelu(approximate=False) in f32: x =
// bf16(h + b) (one f32 add rounded to bf16, torch's bf16 add), then
// (0.5 x) erfc(-x sqrt(1/2)) in f32 (erfcf: libdevice's, as torch.erfc on
// the card; the erfc form keeps its precision where x is negative, where
// 1 + erf(x / sqrt 2) cancels), rounded to bf16. Each step is one IEEE f32
// operation, so the result is expected bit-equal to the plain version
// (ops/encoder.py::bias_gelu_plain) on the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bgelu {

// The plan's rule; ops/encoder.py::plan_bias_gelu holds the same constants.
// Host code only (tests/test_torch_encoder_kernels.py compiles this
// namespace with the host compiler and holds the planner's plans to it).
constexpr int kVec = 8;  // bf16 values a thread's vector (16 bytes)
constexpr int kThreads = 128;
constexpr long long kMaxIndex = 2147483647;  // the grid's threads in 32-bit ints

struct Plan {
  int vec, threads, blocks;
};

// false where (rows, f) takes no plan: f not a multiple of the vector, or
// threads past 32-bit indices
inline bool plan(long long rows, int f, Plan* p) {
  if (rows < 1 || f < kVec || f % kVec) return false;
  const long long vecs = rows * (f / kVec);
  const long long blocks = (vecs + kThreads - 1) / kThreads;
  if (blocks * kThreads > kMaxIndex) return false;
  *p = Plan{kVec, kThreads, static_cast<int>(blocks)};
  return true;
}

// The entry's check: (rows, f) takes a plan and the caller's fields are the rule's.
inline bool accepts(long long rows, int f, int vec, int threads, int blocks, Plan* p) {
  return plan(rows, f, p) && p->vec == vec && p->threads == threads && p->blocks == blocks;
}

}  // namespace bgelu

namespace {

using bgelu::kThreads;

// sqrt(0.5) rounded to f32, as np.sqrt(0.5).astype(float32) in jax.nn.gelu
constexpr float kSqrtHalf = 0.70710678118654752440f;

__device__ __forceinline__ float lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ float gelu(float h, float b) {
  const float x = __bfloat162float(__float2bfloat16_rn(__fadd_rn(h, b)));
  return __fmul_rn(__fmul_rn(0.5f, x), erfcf(__fmul_rn(-x, kSqrtHalf)));
}

__device__ __forceinline__ uint32_t gelu2(uint32_t h, uint32_t b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(gelu(lo(h), lo(b)), gelu(hi(h), hi(b)));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Thread i takes vector i of the `vecs` vectors; a row holds `row_vecs`.
__global__ void __launch_bounds__(kThreads)
    bias_gelu_pass(uint4* h, const uint4* __restrict__ bias, int vecs, int row_vecs) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= vecs) return;
  const uint4 x = h[i];
  const uint4 b = __ldg(bias + i % row_vecs);
  h[i] = make_uint4(gelu2(x.x, b.x), gelu2(x.y, b.y), gelu2(x.z, b.z), gelu2(x.w, b.w));
}

}  // namespace

// h: [rows, f] bf16, overwritten with the result; bias: [f] bf16; both
// 16-byte aligned. The plan (ops/encoder.py::plan_bias_gelu): vec, threads,
// blocks; any other is refused (cudaErrorInvalidConfiguration).
extern "C" int bias_gelu(void* h, const void* bias, int rows, int f, int vec, int threads,
                         int blocks, void* stream) {
  bgelu::Plan p;
  if (!bgelu::accepts(rows, f, vec, threads, blocks, &p))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int row_vecs = f / bgelu::kVec;
  bias_gelu_pass<<<p.blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(h), static_cast<const uint4*>(bias), rows * row_vecs, row_vecs);
  return static_cast<int>(cudaGetLastError());
}
