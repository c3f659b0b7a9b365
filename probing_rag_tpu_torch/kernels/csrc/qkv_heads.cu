// The Contriever encoder's q/k/v split: the biases of the three attention
// projections added to one [N, 3 D] product of the concatenated wq | wk |
// wv, and the heads laid out as prefill_attention.cu reads them.
//
// Replaces no Pallas kernel: the JAX package's encoder
// (probing_rag_tpu/models/encoder.py:111-119) takes three products, adds
// each bias and reshapes to [B, T, H, hd]; XLA fuses the bias adds into the
// products and the layouts into the attention's dots. The plain ops add
// each bias in a pass of its own and copy k and v once more into the
// [B, H, T, hd] slot rows the attention kernel reads.
//
// Bound on this card: device-memory bytes (one add an element) at the index
// build's 512 x ~380 rows; latency at a query batch's 8 x ~40. The kernel
// reads the product once and writes q, k and v once: 12 bytes a row
// element of D; the bias rows stay in L1 and L2.
//
// Design (the plan is ops/encoder.py::plan_qkv_heads's; the entry checks it
// against qkvh::accepts): one pass, no loop, 32-bit thread indices. Thread i
// takes one 16-byte vector (8 bf16 lanes) at row n, column vector c of D:
// it loads the three vectors at c, D + c and 2 D + c of row n and the three
// bias vectors at c, adds, and stores q at [n, c] ([B, T, H, hd]
// contiguous, the product's own order) and k and v at [b, head, t, lane]
// ([B, H, T, hd], contiguous slot rows): neighbouring threads on
// neighbouring vectors of a row, so each head's 128 bytes of a row are
// written whole. hd is a multiple of 8, so a vector never crosses a head.
//
// Numerics: each add is one f32 add rounded to bf16 (torch's bf16 add), so
// q, k and v are bit-equal to the plain version
// (ops/encoder.py::qkv_heads_plain).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qkvh {

// The plan's rule; ops/encoder.py::plan_qkv_heads holds the same constants.
// Host code only (tests/test_torch_encoder_kernels.py compiles this
// namespace with the host compiler and holds the planner's plans to it).
constexpr int kVec = 8;  // bf16 lanes a thread's vector (16 bytes)
constexpr int kThreads = 128;
constexpr long long kMaxIndex = 2147483647;  // the grid's threads in 32-bit ints

struct Plan {
  int vec, threads, blocks;
};

// false where (b, t, h, hd) takes no plan: hd not a multiple of the
// vector, or threads past 32-bit indices
inline bool plan(long long b, long long t, int h, int hd, Plan* p) {
  if (b < 1 || t < 1 || h < 1 || hd < kVec || hd % kVec) return false;
  const long long units = b * t * (static_cast<long long>(h) * hd / kVec);
  const long long blocks = (units + kThreads - 1) / kThreads;
  if (blocks * kThreads > kMaxIndex) return false;
  *p = Plan{kVec, kThreads, static_cast<int>(blocks)};
  return true;
}

// The entry's check: the shape takes a plan and the caller's fields are the rule's.
inline bool accepts(long long b, long long t, int h, int hd, int vec, int threads, int blocks,
                    Plan* p) {
  return plan(b, t, h, hd, p) && p->vec == vec && p->threads == threads && p->blocks == blocks;
}

}  // namespace qkvh

namespace {

using qkvh::kThreads;

__device__ __forceinline__ uint32_t add2(uint32_t x, uint32_t y) {
  const float a0 = __uint_as_float(x << 16), a1 = __uint_as_float(x & 0xffff0000u);
  const float b0 = __uint_as_float(y << 16), b1 = __uint_as_float(y & 0xffff0000u);
  const __nv_bfloat162 v = __floats2bfloat162_rn(__fadd_rn(a0, b0), __fadd_rn(a1, b1));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint4 add8(uint4 x, uint4 b) {
  return make_uint4(add2(x.x, b.x), add2(x.y, b.y), add2(x.z, b.z), add2(x.w, b.w));
}

// dv = D / 8 vectors a row of each part, hv = hd / 8 a head; units = rows x dv
__global__ void __launch_bounds__(kThreads)
    qkv_heads_pass(const uint4* __restrict__ y, const uint4* __restrict__ bq,
                   const uint4* __restrict__ bk, const uint4* __restrict__ bv,
                   uint4* __restrict__ q, uint4* __restrict__ k, uint4* __restrict__ v, int units,
                   int dv, int hv, int t, int h) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= units) return;
  const int n = i / dv, c = i - n * dv;
  const uint4* row = y + static_cast<long long>(n) * 3 * dv;
  const uint4 yq = row[c], yk = row[dv + c], yv = row[2 * dv + c];
  const uint4 cq = __ldg(bq + c), ck = __ldg(bk + c), cv = __ldg(bv + c);
  const int head = c / hv, lane = c - head * hv;
  const int bi = n / t, ti = n - bi * t;
  const long long slot = ((static_cast<long long>(bi) * h + head) * t + ti) * hv + lane;
  q[i] = add8(yq, cq);
  k[slot] = add8(yk, ck);
  v[slot] = add8(yv, cv);
}

}  // namespace

// y: [b, t, 3 h hd] bf16 (q | k | v columns); bq, bk, bv: [h hd] bf16; q:
// [b, t, h, hd], k and v: [b, h, t, hd], bf16. All 16-byte aligned. The
// plan (ops/encoder.py::plan_qkv_heads): vec, threads, blocks; any other is
// refused (cudaErrorInvalidConfiguration).
extern "C" int qkv_heads(const void* y, const void* bq, const void* bk, const void* bv, void* q,
                         void* k, void* v, int b, int t, int h, int hd, int vec, int threads,
                         int blocks, void* stream) {
  qkvh::Plan p;
  if (!qkvh::accepts(b, t, h, hd, vec, threads, blocks, &p))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int dv = h * hd / qkvh::kVec;
  qkv_heads_pass<<<p.blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(y), static_cast<const uint4*>(bq), static_cast<const uint4*>(bk),
      static_cast<const uint4*>(bv), static_cast<uint4*>(q), static_cast<uint4*>(k),
      static_cast<uint4*>(v), b * t * dv, dv, hd / qkvh::kVec, t, h);
  return static_cast<int>(cudaGetLastError());
}
