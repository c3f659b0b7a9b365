// The gated MLP activation: act(gate) * up, for GeGLU (tanh gelu) and
// SwiGLU (silu).
//
// Replaces no Pallas kernel: the JAX package's act(gate) * up
// (probing_rag_tpu/models/gemma.py:915-932) is fused by XLA into its
// products' neighbours. The plain ops write act(gate) to device memory and
// read it back for the product: two kernels and a [N, d_ff] temporary.
//
// Bound on this card: device-memory bytes (about 20 operations for 6 bytes
// at bf16). The kernel reads gate and up once and writes the result once,
// into gate's buffer when the caller passes it as out (the product's
// output, a temporary: at a Gemma-2B prefill of 29,696 rows that saves a
// 973 MB allocation). Design: a grid-stride loop over 16-byte vectors
// (8 bf16 or 4 f32 values a thread a step), neighbouring threads on
// neighbouring addresses, then the ragged tail one value a thread.
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
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
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

// gate and out may be one buffer: each value is read, then written, by
// the same thread.
template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads) gated_act_kernel(const T* gate,
                                                             const T* __restrict__ up, T* out,
                                                             long long n) {
  constexpr int kPer = 16 / sizeof(T);
  const long long vecs = n / kPer;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (long long i = first; i < vecs; i += stride) {
    uint4 gv = reinterpret_cast<const uint4*>(gate)[i];
    const uint4 uv = reinterpret_cast<const uint4*>(up)[i];
    T* g = reinterpret_cast<T*>(&gv);
    const T* u = reinterpret_cast<const T*>(&uv);
#pragma unroll
    for (int j = 0; j < kPer; ++j) g[j] = gated<T, ACT>(g[j], u[j]);
    reinterpret_cast<uint4*>(out)[i] = gv;
  }
  for (long long i = vecs * kPer + first; i < n; i += stride) out[i] = gated<T, ACT>(gate[i], up[i]);
}

template <typename T, int ACT>
int launch(const void* gate, const void* up, void* out, long long n, int sms, cudaStream_t st) {
  constexpr int kPer = 16 / sizeof(T);
  long long blocks = (n / kPer + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * 8;  // a grid-stride loop beyond
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  gated_act_kernel<T, ACT><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const T*>(gate), static_cast<const T*>(up), static_cast<T*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// gate, up and out: n values of dt (0 bf16, 1 f32), 16-byte aligned; out
// may be gate. act 0 gelu (tanh form), 1 silu.
extern "C" int gated_act(const void* gate, const void* up, void* out, int dt, int act, long long n,
                         int sms, void* stream) {
  if (dt < 0 || dt > 1 || act < 0 || act > 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dt == 0)
    return act == 0 ? launch<__nv_bfloat16, 0>(gate, up, out, n, sms, st)
                    : launch<__nv_bfloat16, 1>(gate, up, out, n, sms, st);
  return act == 0 ? launch<float, 0>(gate, up, out, n, sms, st)
                  : launch<float, 1>(gate, up, out, n, sms, st);
}
