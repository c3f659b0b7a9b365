// RMSNorm of the f32 residual stream, with the residual add folded in.
//
// Replaces no Pallas kernel: the JAX package's rms_norm
// (probing_rag_tpu/models/gemma.py:338-346) and the residual adds beside it
// (:913, :947) are fused by XLA. In the port one launch computes, for each
// row of [N, D],
//
//   resid  = x + f32(delta)                      (when there is a delta)
//   normed = dt(resid * rsqrt(mean(resid^2) + eps) * (1 + w) | w)
//
// which the plain ops do in about nine kernels with f32 temporaries.
//
// Bound on this card: device-memory bytes (a few operations a byte). The
// kernel reads x, delta and w once and writes resid and normed once.
// Design: a row is summed by the threads torch's CUDA reduction would give
// it (a warp for the many rows of a prefill or a capture forward, 64 at a
// decode step's 8 rows), a grid-stride loop over the rows. From 128 wide a
// thread takes 4-wide vectors (16-byte f32 loads), vector t + width k for
// k = 0, 1, ..; up to 16 of them stay in registers between the sum and the
// output pass, more are read again (from L2).
//
// Numerics: the add and the products are single IEEE f32 operations
// (__fadd_rn / __fmul_rn: nvcc contracts nothing), equal to the plain
// ops'. The sum of squares is taken in the order of torch's CUDA reduction
// (ATen/native/cuda/Reduce.cuh, as of torch 2.11-2.13): four partial sums
// a thread, one for each element of a vector (from 128 wide), or for
// element t + width k the partial k mod 4 (narrower), then the four added
// in order; the threads' sums halved in shared memory down to a warp, then
// combined by shfl_down at offsets 16, 8, .., 1; the mean as a product by
// 1 / D. So normed is expected bit-equal to the plain version; where torch
// lays its reduction out otherwise, it may differ by a few f32 ulps before
// the cast to dt (ops/block.py states the bound).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kKeep = 16;     // vectors a lane keeps in registers: rows up to 2048
constexpr int kMaxD = 16384;  // widest row

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  uint2 u;
  *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(v.x, v.y);
  *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* p) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}
__device__ __forceinline__ float square_add(float acc, float v) {
  return __fadd_rn(acc, __fmul_rn(v, v));
}
__device__ __forceinline__ float scaled(float v, float r, float w, int plus_one) {
  return __fmul_rn(__fmul_rn(v, r), plus_one ? __fadd_rn(1.0f, w) : w);
}

// The threads torch's reduction gives one row (its block_width, from
// setReduceConfig in ATen/native/cuda/Reduce.cuh): rows of `units` loads (4-
// wide vectors from 128 wide on, else elements) over `rows` rows, at most
// 512 threads a block.
__host__ __device__ inline int last_pow2(int n) {
  int p = 1;
  while (p * 2 <= n) p *= 2;
  return p;
}
inline int torch_row_threads(int units, int rows) {
  const int max_threads = 512;
  const int d0 = units < max_threads ? last_pow2(units) : max_threads;
  const int d1 = rows < max_threads ? last_pow2(rows) : max_threads;
  int width = d0 < 32 ? d0 : 32;
  const int height = d1 < max_threads / width ? d1 : max_threads / width;
  width = d0 < max_threads / height ? d0 : max_threads / height;
  return width < 32 ? 32 : width;
}

// VEC: rows of 128 or more, in 4-wide vectors; KEEP: a thread's vectors stay
// in registers (at most kKeep). DT: the delta's type (void: no delta), WT
// the weight's, OT normed's. `width` threads (a power of two, 32 to 512) a
// row, max(width, 256) a block.
template <bool VEC, bool KEEP, typename DT, typename WT, typename OT>
__global__ void __launch_bounds__(512) rms_norm_kernel(
    const float* __restrict__ x, const DT* __restrict__ delta, const WT* __restrict__ w,
    float* __restrict__ resid, OT* __restrict__ normed, int rows, int d, float eps,
    int plus_one, int width) {
  constexpr bool kDelta = !std::is_same<DT, void>::value;
  constexpr int kUnroll = KEEP ? kKeep : 1;
  __shared__ float partial[512];
  __shared__ float row_scale[16];
  const int t = threadIdx.x % width, group = threadIdx.x / width;
  const int groups = blockDim.x / width;
  const int units = VEC ? d / 4 : d;
  const float inv_d = 1.0f / static_cast<float>(d);  // torch's mean factor
  for (long long row0 = static_cast<long long>(blockIdx.x) * groups; row0 < rows;
       row0 += static_cast<long long>(gridDim.x) * groups) {
    const long long row = row0 + group;  // a group past the last row sums nothing
    const bool live = row < rows;
    const float* xr = x + row * d;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // torch's four partial sums a thread
    float4 kept[KEEP ? kKeep : 1];
    if (live) {
      if constexpr (VEC) {
#pragma unroll kUnroll
        for (int k = 0; k < (KEEP ? kKeep : units); ++k) {
          const int v = t + width * k;
          if (v >= units) break;
          float4 r = load4(xr + 4 * v);
          if constexpr (kDelta) {
            r = add4(r, load4(delta + row * d + 4 * v));
            store4(resid + row * d + 4 * v, r);
          }
          if constexpr (KEEP) kept[k] = r;
          acc[0] = square_add(acc[0], r.x);
          acc[1] = square_add(acc[1], r.y);
          acc[2] = square_add(acc[2], r.z);
          acc[3] = square_add(acc[3], r.w);
        }
      } else {
        for (int k = 0; t + width * k < d; ++k) {
          const int e = t + width * k;
          float r = xr[e];
          if constexpr (kDelta) {
            r = __fadd_rn(r, to_f32(delta[row * d + e]));
            resid[row * d + e] = r;
          }
          acc[k & 3] = square_add(acc[k & 3], r);
        }
      }
    }
    float sq = __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]);
    if (width > 32) {  // torch's block_x_reduce: halving in shared memory down to a warp
      partial[threadIdx.x] = sq;
      for (int off = width / 2; off >= 32; off >>= 1) {
        __syncthreads();
        if (t < off) {
          sq = __fadd_rn(sq, partial[threadIdx.x + off]);
          partial[threadIdx.x] = sq;
        }
      }
    }
    // then shfl_down at offsets 16, 8, .., 1 (lane 0 of the row's first warp)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sq = __fadd_rn(sq, __shfl_down_sync(0xffffffffu, sq, off));
    if (width > 32) {
      if (t == 0) row_scale[group] = sq;
      __syncthreads();
      sq = row_scale[group];
      __syncthreads();  // read before the next rows write
    } else {
      sq = __shfl_sync(0xffffffffu, sq, 0);
    }
    const float r = rsqrtf(__fadd_rn(__fmul_rn(sq, inv_d), eps));
    if (!live) continue;  // a thread reads back only what it stored itself
    if constexpr (VEC) {
#pragma unroll kUnroll
      for (int k = 0; k < (KEEP ? kKeep : units); ++k) {
        const int v = t + width * k;
        if (v >= units) break;
        float4 val;
        if constexpr (KEEP) {
          val = kept[k];
        } else {
          val = kDelta ? load4(resid + row * d + 4 * v) : load4(xr + 4 * v);
        }
        const float4 wv = load4(w + 4 * v);
        store4(normed + row * d + 4 * v,
               make_float4(scaled(val.x, r, wv.x, plus_one), scaled(val.y, r, wv.y, plus_one),
                           scaled(val.z, r, wv.z, plus_one), scaled(val.w, r, wv.w, plus_one)));
      }
    } else {
      for (int e = t; e < d; e += width) {
        const float val = kDelta ? resid[row * d + e] : xr[e];
        from_f32(scaled(val, r, to_f32(w[e]), plus_one), normed + row * d + e);
      }
    }
  }
}

template <bool VEC, bool KEEP, typename DT, typename WT, typename OT>
int launch(const void* x, const void* delta, const void* w, void* resid, void* normed, int rows,
           int d, float eps, int plus_one, int sms, int width, cudaStream_t st) {
  const int threads = width > 256 ? width : 256;
  const int groups = threads / width;
  long long blocks = (rows + groups - 1) / groups;
  const long long cap = static_cast<long long>(sms) * 16;  // a grid-stride loop beyond
  if (blocks > cap) blocks = cap;
  rms_norm_kernel<VEC, KEEP, DT, WT, OT><<<static_cast<unsigned>(blocks), threads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const DT*>(delta), static_cast<const WT*>(w),
      static_cast<float*>(resid), static_cast<OT*>(normed), rows, d, eps, plus_one, width);
  return static_cast<int>(cudaGetLastError());
}

template <typename DT, typename WT, typename OT>
int by_width(const void* x, const void* delta, const void* w, void* resid, void* normed,
             int rows, int d, float eps, int plus_one, int sms, cudaStream_t st) {
  if (d < 128) {
    const int width = torch_row_threads(d, rows);
    return launch<false, false, DT, WT, OT>(x, delta, w, resid, normed, rows, d, eps, plus_one,
                                            sms, width, st);
  }
  const int width = torch_row_threads(d / 4, rows);
  if (d / 4 <= width * kKeep)
    return launch<true, true, DT, WT, OT>(x, delta, w, resid, normed, rows, d, eps, plus_one,
                                          sms, width, st);
  return launch<true, false, DT, WT, OT>(x, delta, w, resid, normed, rows, d, eps, plus_one, sms,
                                         width, st);
}

template <typename DT, typename WT>
int by_out(int out_kind, const void* x, const void* delta, const void* w, void* resid,
           void* normed, int rows, int d, float eps, int plus_one, int sms, cudaStream_t st) {
  return out_kind == 0
             ? by_width<DT, WT, __nv_bfloat16>(x, delta, w, resid, normed, rows, d, eps,
                                               plus_one, sms, st)
             : by_width<DT, WT, float>(x, delta, w, resid, normed, rows, d, eps, plus_one, sms,
                                       st);
}

template <typename DT>
int by_weight(int w_kind, int out_kind, const void* x, const void* delta, const void* w,
              void* resid, void* normed, int rows, int d, float eps, int plus_one, int sms,
              cudaStream_t st) {
  return w_kind == 0 ? by_out<DT, __nv_bfloat16>(out_kind, x, delta, w, resid, normed, rows, d,
                                                 eps, plus_one, sms, st)
                     : by_out<DT, float>(out_kind, x, delta, w, resid, normed, rows, d, eps,
                                         plus_one, sms, st);
}

}  // namespace

// x [rows, d] f32; delta [rows, d] (delta_kind 0 none, 1 bf16, 2 f32);
// w [d] (w_kind 0 bf16, 1 f32); resid [rows, d] f32 (written when there is
// a delta); normed [rows, d] (out_kind 0 bf16, 1 f32). d a multiple of 8 up
// to 16384; every pointer 16-byte aligned.
extern "C" int rms_norm(const void* x, const void* delta, const void* w, void* resid,
                        void* normed, int delta_kind, int w_kind, int out_kind, int rows, int d,
                        float eps, int plus_one, int sms, void* stream) {
  if (d % 8 || d > kMaxD || delta_kind < 0 || delta_kind > 2 || w_kind < 0 || w_kind > 1 ||
      out_kind < 0 || out_kind > 1 || (delta_kind && !delta))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (delta_kind) {
    case 0:
      return by_weight<void>(w_kind, out_kind, x, delta, w, resid, normed, rows, d, eps,
                             plus_one, sms, st);
    case 1:
      return by_weight<__nv_bfloat16>(w_kind, out_kind, x, delta, w, resid, normed, rows, d, eps,
                                      plus_one, sms, st);
    default:
      return by_weight<float>(w_kind, out_kind, x, delta, w, resid, normed, rows, d, eps,
                              plus_one, sms, st);
  }
}
