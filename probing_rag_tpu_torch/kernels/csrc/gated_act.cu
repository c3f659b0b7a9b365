// The gated MLP activation: act(gate) * up, for GeGLU (tanh gelu) and
// SwiGLU (silu).
//
// Replaces no Pallas kernel: the JAX package's act(gate) * up
// (probing_rag_tpu/models/gemma.py:915-932) is fused by XLA into its
// products' neighbours. The plain ops write act(gate) to device memory and
// read it back for the product: two kernels and a [N, d_ff] temporary.
//
// Bound on this card: device-memory bytes at a prefill's or a capture's
// rows (about 20 operations for 6 bytes at bf16, but ~40 instructions an
// element with libdevice's tanhf: the arithmetic is most of the byte
// time, so the loads must overlap it); latency at a decode step's 8 rows.
// The kernel reads gate and up once and writes the result once, into
// gate's buffer when the caller passes it as out (the product's output, a
// temporary: at a Gemma-2B prefill of 29,696 rows that saves a 973 MB
// allocation).
//
// Design (the plan is ops/block.py::plan_act's; the entry checks it
// against its own copy of the rule below, gact::accepts): one pass at
// every size, a vector of kVecBytes (4 bf16 or 2 f32 values) a thread,
// neighbouring threads on neighbouring vectors, in blocks of kThreads, as
// many blocks as the vectors need, the last vector ragged where n is not a
// multiple of it. No loop and 32-bit indices: a thread issues its two
// loads, computes, stores and exits, so at a decode step's [8 x 16,384]
// the work spreads as 256 blocks over every SM with four gelus a thread.
// On the card this takes a same-bytes torch.add(gate, up, out=gate)'s time
// at a prefill's rows and a few percent more at a decode step's
// (chip_smoke.py phase 9a prints both); a resident grid walking the tensor
// with each thread's next loads in flight was slower at a prefill. The
// instantiation without a ragged vector holds no code for one (code run
// once from a cold instruction cache is latency at a decode step).
// In place: each vector is read, then written, by one thread, and no
// thread touches another's, so out may be gate (neither is __restrict__).
//
// Numerics, as torch's CUDA kernels compute them: act in f32 from the
// compute-type gate (gelu: 0.5 x (1 + tanhf(kBeta (x + kKappa x^3))) with
// torch's constants and expression, silu: x / (1 + expf(-x))), rounded to
// the compute type; then the product of the two compute-type values in
// f32 (exact for bf16), rounded to the compute type. tanhf and expf are
// libdevice's full-precision functions (no fast-math); nvcc may contract
// the gelu expression differently from torch's build, so act may differ
// from the plain one by a few f32 ulps (ops/block.py states the bound).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gact {

// The plan's rule; ops/block.py::plan_act holds the same constants. Host
// code only (tests/test_torch_block_plan.py compiles this namespace with
// the host compiler and holds the planner's plans to it).
constexpr int kVecBytes = 8;
constexpr int kThreads = 128;
constexpr long long kMaxIndex = 2147483647;  // the grid's threads in 32-bit ints

struct Plan {
  int vec_bytes, threads, blocks;
};

// false where n takes no plan (its threads past 32-bit indices)
inline bool plan(long long n, int es, Plan* p) {
  const long long per = kVecBytes / es;
  long long blocks = ((n + per - 1) / per + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks * kThreads > kMaxIndex) return false;
  *p = Plan{kVecBytes, kThreads, static_cast<int>(blocks)};
  return true;
}

// The entry's check: n takes a plan and the caller's fields are the rule's.
inline bool accepts(long long n, int es, int vec_bytes, int threads, int blocks, Plan* p) {
  return plan(n, es, p) && p->vec_bytes == vec_bytes && p->threads == threads &&
         p->blocks == blocks;
}

}  // namespace gact

namespace {

using gact::kThreads;

// torch's constants: M_SQRT2 * M_2_SQRTPI * 0.5 in double, then f32
constexpr float kBeta = static_cast<float>(1.41421356237309504880 * 1.12837916709551257390 * 0.5);
constexpr float kKappa = 0.044715f;

template <int ACT>
__device__ __forceinline__ float act(float x) {
  if constexpr (ACT == 0) {
    const float x_cube = x * x * x;
    const float inner = kBeta * (x + kKappa * x_cube);
    return 0.5f * x * (1.0f + tanhf(inner));
  } else {
    return x / (1.0f + expf(-x));
  }
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16& y) { y = __float2bfloat16_rn(x); }
__device__ __forceinline__ void from_f32(float x, float& y) { y = x; }

template <typename T, int ACT>
__device__ __forceinline__ T gated(T g, T u) {
  T a, out;
  from_f32(act<ACT>(to_f32(g)), a);  // rounded to the compute type
  from_f32(__fmul_rn(to_f32(a), to_f32(u)), out);
  return out;
}

// A thread's vector, loaded and stored as one.
using Vec = uint2;
static_assert(sizeof(Vec) == gact::kVecBytes, "the rule's vector");

template <typename T, int ACT>
__device__ __forceinline__ Vec gated_vec(Vec g, const Vec u) {
  constexpr int kPer = sizeof(Vec) / sizeof(T);
  T* gs = reinterpret_cast<T*>(&g);
  const T* us = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int j = 0; j < kPer; ++j) gs[j] = gated<T, ACT>(gs[j], us[j]);
  return g;
}

// The ragged vector's `tail` values, one at a time (only where n is not a
// multiple of the vector).
template <typename T, int ACT>
__device__ __noinline__ void ragged_vec(const T* gate, const T* up, T* out, int tail) {
  for (int e = 0; e < tail; ++e) out[e] = gated<T, ACT>(gate[e], up[e]);
}

// Thread i takes vector i of `full` whole vectors, or the ragged vector of
// `tail` values at i == full.
template <typename T, int ACT, bool RAGGED>
__global__ void __launch_bounds__(kThreads)
    gated_act_pass(const T* gate, const T* __restrict__ up, T* out, int full, int tail) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < full) {
    const Vec g = reinterpret_cast<const Vec*>(gate)[i];
    const Vec u = reinterpret_cast<const Vec*>(up)[i];
    reinterpret_cast<Vec*>(out)[i] = gated_vec<T, ACT>(g, u);
  }
  if constexpr (RAGGED) {
    constexpr long long kPer = sizeof(Vec) / sizeof(T);
    if (i == full)
      ragged_vec<T, ACT>(gate + kPer * full, up + kPer * full, out + kPer * full, tail);
  }
}

template <typename T, int ACT>
int launch(const gact::Plan& p, const void* gate, const void* up, void* out, long long n,
           cudaStream_t st) {
  const int per = p.vec_bytes / static_cast<int>(sizeof(T));
  const int full = static_cast<int>(n / per);
  const int tail = static_cast<int>(n % per);
  const T* g = static_cast<const T*>(gate);
  const T* u = static_cast<const T*>(up);
  T* o = static_cast<T*>(out);
  if (tail)
    gated_act_pass<T, ACT, true><<<p.blocks, kThreads, 0, st>>>(g, u, o, full, tail);
  else
    gated_act_pass<T, ACT, false><<<p.blocks, kThreads, 0, st>>>(g, u, o, full, tail);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// gate, up and out: n values of dt (0 bf16, 1 f32), 16-byte aligned; out
// may be gate. act 0 gelu (tanh form), 1 silu. The plan (ops/block.py::
// plan_act): vec_bytes, threads, blocks; any field other than the rule's
// is refused (cudaErrorInvalidConfiguration).
extern "C" int gated_act(const void* gate, const void* up, void* out, int dt, int act, long long n,
                         int vec_bytes, int threads, int blocks, void* stream) {
  if (dt < 0 || dt > 1 || act < 0 || act > 1 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  gact::Plan p;
  if (!gact::accepts(n, dt == 0 ? 2 : 4, vec_bytes, threads, blocks, &p))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dt == 0)
    return act == 0 ? launch<__nv_bfloat16, 0>(p, gate, up, out, n, st)
                    : launch<__nv_bfloat16, 1>(p, gate, up, out, n, st);
  return act == 0 ? launch<float, 0>(p, gate, up, out, n, st)
                  : launch<float, 1>(p, gate, up, out, n, st);
}
