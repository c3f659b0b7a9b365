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
// Bound on this card: device-memory bytes at a prefill's or a capture's
// rows (a few operations a byte), latency at a decode step's 8 rows. The
// kernel reads x, delta and w once and writes resid and normed once.
//
// Design (the plan is ops/block.py::plan_norm's; the entry checks it): a
// row is summed by the `width` threads torch's CUDA reduction would give
// it (a warp for the many rows of a prefill or a capture forward, 64 at a
// decode step's 8 rows), `rows_block` rows a block, one row for each group
// of `width` threads and no grid-stride loop: at a decode step one row a
// block, so the 8 rows run on 8 SMs. From 128 wide a thread takes 4-wide
// vectors (16-byte f32 loads), vector t + width k for k = 0, 1, ..; it
// issues every load of a chunk of C vectors (x, the delta and, when the
// row fits in one chunk, w) before its first add, so a row waits on one
// round trip of loads, then the sum, the reduction and the stores. A
// thread's vectors stay in registers from the sum to the output when they
// fit in one chunk (C up to 16: rows up to 2048 at a warp a row, 4096 at a
// decode step's 64 threads); a wider row (Mistral-7B's 4096 at prefill) is
// summed a chunk at a time and each chunk read again (from L2, where it was
// just written) for the output: 32 vectors a thread in registers spill.
//
// Numerics: the add and the products are single IEEE f32 operations
// (__fadd_rn / __fmul_rn: nvcc contracts nothing), equal to the plain
// ops'. The sum of squares is taken in the order of torch's CUDA reduction
// (ATen/native/cuda/Reduce.cuh, as of torch 2.11-2.13): four partial sums
// a thread, one for each element of a vector (from 128 wide), or for
// element t + width k the partial k mod 4 (narrower), then the four added
// in order; the threads' sums halved in shared memory down to a warp, then
// combined by shfl_down at offsets 16, 8, .., 1; the mean as a product by
// 1 / D. Each warp of a row takes the last halving step itself (the same
// operands in the same order), so the row's scale needs no second barrier.
// So normed is expected bit-equal to the plain version; where torch lays
// its reduction out otherwise, it may differ by a few f32 ulps before the
// cast to dt (ops/block.py states the bound).

// nvcc-parts: 3
// The build compiles this file once per part (kernels/__init__.py reads
// the line above): part p holds the kernels of delta kind p (none, bf16,
// f32); part 0 also holds the C entry.
#ifndef NVCC_PART
#define NVCC_PART 0
#define NVCC_PARTS 1
#endif
#define IN_PART(p) (NVCC_PARTS == 1 || NVCC_PART == (p))

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace rmsn {

constexpr int kMaxD = 16384;     // widest row
constexpr int kMaxThreads = 512;  // a block; 256 for chunks of 8 vectors or more

struct Args {
  const void* x;
  const void* delta;
  const void* w;
  void* resid;
  void* normed;
  int rows, d, plus_one, width, rows_block, blocks, chunk;
  float eps;
};

cudaError_t launch_no_delta(int w_kind, int out_kind, const Args& a, cudaStream_t st);
cudaError_t launch_bf16_delta(int w_kind, int out_kind, const Args& a, cudaStream_t st);
cudaError_t launch_f32_delta(int w_kind, int out_kind, const Args& a, cudaStream_t st);

// The threads torch's reduction gives one row (its block_width, from
// setReduceConfig in ATen/native/cuda/Reduce.cuh): rows of `units` loads (4-
// wide vectors from 128 wide on, else elements) over `rows` rows, at most
// 512 threads a block. ops/block.py::torch_row_threads is its copy.
inline int last_pow2(int n) {
  int p = 1;
  while (p * 2 <= n) p *= 2;
  return p;
}
inline int torch_row_threads(int units, int rows) {
  const int max_threads = kMaxThreads;
  const int d0 = units < max_threads ? last_pow2(units) : max_threads;
  const int d1 = rows < max_threads ? last_pow2(rows) : max_threads;
  int width = d0 < 32 ? d0 : 32;
  const int height = d1 < max_threads / width ? d1 : max_threads / width;
  width = d0 < max_threads / height ? d0 : max_threads / height;
  return width < 32 ? 32 : width;
}

}  // namespace rmsn

namespace {

using rmsn::Args;

// Four elements of T as they lie in memory, and widened to f32.
template <typename T>
struct Raw4 {
  using type = float4;
};
template <>
struct Raw4<__nv_bfloat16> {
  using type = uint2;
};
template <typename T>
__device__ __forceinline__ typename Raw4<T>::type load_raw(const T* p) {
  return *reinterpret_cast<const typename Raw4<T>::type*>(p);
}
__device__ __forceinline__ float4 widen(float4 v) { return v; }
__device__ __forceinline__ float4 widen(uint2 u) {
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
__device__ __forceinline__ float4 scaled4(float4 v, float r, float4 w, int plus_one) {
  return make_float4(scaled(v.x, r, w.x, plus_one), scaled(v.y, r, w.y, plus_one),
                     scaled(v.z, r, w.z, plus_one), scaled(v.w, r, w.w, plus_one));
}

// A row's sum of squares from each thread's sum `sq`, in torch's order:
// halving in shared memory while more than 64 threads hold sums, the last
// halving step (to a warp) taken by every warp of the row alike, then
// shfl_down at offsets 16 .. 1 and lane 0's total to every lane.
__device__ __forceinline__ float row_sum(float sq, int t, int width, float* partial) {
  if (width > 32) {
    const int base = threadIdx.x - t;
    partial[threadIdx.x] = sq;
    for (int off = width / 2; off > 32; off >>= 1) {
      __syncthreads();
      if (t < off) {
        sq = __fadd_rn(sq, partial[threadIdx.x + off]);
        partial[threadIdx.x] = sq;
      }
    }
    __syncthreads();
    const int l = t % 32;
    sq = __fadd_rn(partial[base + l], partial[base + l + 32]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sq = __fadd_rn(sq, __shfl_down_sync(0xffffffffu, sq, off));
  return __shfl_sync(0xffffffffu, sq, 0);
}

// Rows of 128 or more, in 4-wide vectors, C vectors a thread a chunk. DT:
// the delta's type (void: no delta), WT the weight's, OT normed's.
template <int C, typename DT, typename WT, typename OT>
__global__ void __launch_bounds__(C >= 8 ? 256 : 512) rms_norm_vec(Args a) {
  constexpr bool kDelta = !std::is_same<DT, void>::value;
  using DRaw = typename Raw4<typename std::conditional<kDelta, DT, float>::type>::type;
  using WRaw = typename Raw4<WT>::type;
  __shared__ float partial[rmsn::kMaxThreads];
  const int width = a.width, d = a.d;
  const int t = threadIdx.x % width;
  const long long row = static_cast<long long>(blockIdx.x) * a.rows_block + threadIdx.x / width;
  const bool live = row < a.rows;  // a group past the last row sums nothing
  const int units = d / 4;
  const int chunks = ((units + width - 1) / width + C - 1) / C;
  const float* xr = static_cast<const float*>(a.x) + row * d;
  const DT* dr = nullptr;
  if constexpr (kDelta) dr = static_cast<const DT*>(a.delta) + row * d;
  float* rr = static_cast<float*>(a.resid) + row * d;
  const WT* w = static_cast<const WT*>(a.w);
  OT* out = static_cast<OT*>(a.normed) + row * d;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // torch's four partial sums a thread
  // chunk c's vectors of x and the delta, every load before the first add
  auto load_chunk = [&](float4(&xs)[C], DRaw(&ds)[C], int c) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int v = t + width * (c * C + k);
      if (live && v < units) {
        xs[k] = load_raw(xr + 4 * v);
        if constexpr (kDelta) ds[k] = load_raw(dr + 4 * v);
      }
    }
  };
  // x + delta into xs and resid, the squares into the partial sums in order
  auto add_chunk = [&](float4(&xs)[C], const DRaw(&ds)[C], int c) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int v = t + width * (c * C + k);
      if (live && v < units) {
        if constexpr (kDelta) {
          xs[k] = add4(xs[k], widen(ds[k]));
          store4(rr + 4 * v, xs[k]);
        }
        acc[0] = square_add(acc[0], xs[k].x);
        acc[1] = square_add(acc[1], xs[k].y);
        acc[2] = square_add(acc[2], xs[k].z);
        acc[3] = square_add(acc[3], xs[k].w);
      }
    }
  };
  auto row_scale = [&]() {
    const float sq = __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]);
    return rsqrtf(__fadd_rn(__fmul_rn(row_sum(sq, t, width, partial),
                                      1.0f / static_cast<float>(d)), a.eps));
  };
  if (chunks == 1) {  // the row in registers from the loads to the output; w loaded with x
    float4 xs[C];
    DRaw ds[C];
    WRaw ws[C];
    load_chunk(xs, ds, 0);
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int v = t + width * k;
      if (live && v < units) ws[k] = load_raw(w + 4 * v);
    }
    add_chunk(xs, ds, 0);
    const float r = row_scale();
    if (!live) return;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int v = t + width * k;
      if (v < units) store4(out + 4 * v, scaled4(xs[k], r, widen(ws[k]), a.plus_one));
    }
    return;
  }
  // a row wider than a chunk: summed a chunk at a time, each chunk read
  // again for the output (a thread reads back only what it stored itself)
  for (int c = 0; c < chunks; ++c) {
    float4 xs[C];
    DRaw ds[C];
    load_chunk(xs, ds, c);
    add_chunk(xs, ds, c);
  }
  const float r = row_scale();
  if (!live) return;
  const float* back = kDelta ? rr : xr;
  for (int c = 0; c < chunks; ++c) {
    float4 xs[C];
    WRaw ws[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int v = t + width * (c * C + k);
      if (v < units) {
        xs[k] = load_raw(back + 4 * v);
        ws[k] = load_raw(w + 4 * v);
      }
    }
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int v = t + width * (c * C + k);
      if (v < units) store4(out + 4 * v, scaled4(xs[k], r, widen(ws[k]), a.plus_one));
    }
  }
}

// Rows narrower than 128, an element at a time: element t + width k into
// the partial k mod 4 (a row is at most 127 wide, so a thread takes at most
// 4 elements).
template <typename DT, typename WT, typename OT>
__global__ void __launch_bounds__(512) rms_norm_narrow(Args a) {
  constexpr bool kDelta = !std::is_same<DT, void>::value;
  __shared__ float partial[rmsn::kMaxThreads];
  const int width = a.width, d = a.d;
  const int t = threadIdx.x % width;
  const long long row = static_cast<long long>(blockIdx.x) * a.rows_block + threadIdx.x / width;
  const bool live = row < a.rows;
  const float* xr = static_cast<const float*>(a.x) + row * d;
  float* rr = static_cast<float*>(a.resid) + row * d;
  const WT* w = static_cast<const WT*>(a.w);
  float xs[4], ds[4], ws[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // every load first
    const int e = t + width * k;
    if (live && e < d) {
      xs[k] = xr[e];
      if constexpr (kDelta) ds[k] = to_f32(static_cast<const DT*>(a.delta)[row * d + e]);
      ws[k] = to_f32(w[e]);
    }
  }
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int e = t + width * k;
    if (live && e < d) {
      if constexpr (kDelta) {
        xs[k] = __fadd_rn(xs[k], ds[k]);
        rr[e] = xs[k];
      }
      acc[k] = square_add(acc[k], xs[k]);
    }
  }
  float sq = __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]);
  sq = row_sum(sq, t, width, partial);
  const float r = rsqrtf(__fadd_rn(__fmul_rn(sq, 1.0f / static_cast<float>(d)), a.eps));
  if (!live) return;
  OT* out = static_cast<OT*>(a.normed) + row * d;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int e = t + width * k;
    if (e < d) from_f32(scaled(xs[k], r, ws[k], a.plus_one), out + e);
  }
}

template <typename DT, typename WT, typename OT>
cudaError_t by_chunk(const Args& a, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(a.blocks)), block(a.rows_block * a.width);
  if (a.d < 128) {
    rms_norm_narrow<DT, WT, OT><<<grid, block, 0, st>>>(a);
  } else {
    switch (a.chunk) {
      case 4: rms_norm_vec<4, DT, WT, OT><<<grid, block, 0, st>>>(a); break;
      case 8: rms_norm_vec<8, DT, WT, OT><<<grid, block, 0, st>>>(a); break;
      default: rms_norm_vec<16, DT, WT, OT><<<grid, block, 0, st>>>(a); break;
    }
  }
  return cudaGetLastError();
}

template <typename DT>
cudaError_t by_types(int w_kind, int out_kind, const Args& a, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  if (w_kind == 0)
    return out_kind == 0 ? by_chunk<DT, bf16, bf16>(a, st) : by_chunk<DT, bf16, float>(a, st);
  return out_kind == 0 ? by_chunk<DT, float, bf16>(a, st) : by_chunk<DT, float, float>(a, st);
}

}  // namespace

namespace rmsn {

#if IN_PART(0)
cudaError_t launch_no_delta(int w_kind, int out_kind, const Args& a, cudaStream_t st) {
  return by_types<void>(w_kind, out_kind, a, st);
}
#endif
#if IN_PART(1)
cudaError_t launch_bf16_delta(int w_kind, int out_kind, const Args& a, cudaStream_t st) {
  return by_types<__nv_bfloat16>(w_kind, out_kind, a, st);
}
#endif
#if IN_PART(2)
cudaError_t launch_f32_delta(int w_kind, int out_kind, const Args& a, cudaStream_t st) {
  return by_types<float>(w_kind, out_kind, a, st);
}
#endif

}  // namespace rmsn

#if IN_PART(0)

// x [rows, d] f32; delta [rows, d] (delta_kind 0 none, 1 bf16, 2 f32);
// w [d] (w_kind 0 bf16, 1 f32); resid [rows, d] f32 (written when there is
// a delta); normed [rows, d] (out_kind 0 bf16, 1 f32). d a multiple of 8 up
// to 16384; every pointer 16-byte aligned. The plan (ops/block.py::
// plan_norm): `width` threads a row, which must be torch's; `rows_block`
// rows a block, `blocks` blocks covering the rows; `chunk` vectors a
// thread takes at a time (4, 8 or 16; 4 below 128 wide; 256 threads a
// block at most from 8).
extern "C" int rms_norm(const void* x, const void* delta, const void* w, void* resid,
                        void* normed, int delta_kind, int w_kind, int out_kind, int rows, int d,
                        float eps, int plus_one, int width, int rows_block, int blocks, int chunk,
                        void* stream) {
  if (d % 8 || d > rmsn::kMaxD || delta_kind < 0 || delta_kind > 2 || w_kind < 0 ||
      w_kind > 1 || out_kind < 0 || out_kind > 1 || (delta_kind && !delta))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const int units = d < 128 ? d : d / 4;
  const int max_threads = chunk >= 8 ? 256 : rmsn::kMaxThreads;
  const bool chunk_ok = d < 128 ? chunk == 4 : (chunk == 4 || chunk == 8 || chunk == 16);
  if (width != rmsn::torch_row_threads(units, rows) || !chunk_ok || rows_block < 1 ||
      static_cast<long long>(rows_block) * width > max_threads || blocks < 1 ||
      static_cast<long long>(blocks) * rows_block < rows ||
      static_cast<long long>(blocks - 1) * rows_block >= rows)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const Args a{x, delta, w, resid, normed, rows, d, plus_one, width, rows_block, blocks, chunk,
               eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (delta_kind) {
    case 0: err = rmsn::launch_no_delta(w_kind, out_kind, a, st); break;
    case 1: err = rmsn::launch_bf16_delta(w_kind, out_kind, a, st); break;
    default: err = rmsn::launch_f32_delta(w_kind, out_kind, a, st); break;
  }
  return static_cast<int>(err);
}

#endif  // IN_PART(0)
