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
//
// Bound on the H100: at decode (M = batch = 8) the work is ~16 flop per
// weight byte, so the int8 weight read bounds it: 110.1 M bytes per
// Gemma-2B layer (33 us at 3.35 TB/s) and 524 MB for the tied head
// (156 us). At prefill (M = 8 x prompt length, ~29K) it is ~58K flop per
// weight byte and the bf16 tensor cores bound it (2 M N K flop at
// 989 TFLOP/s). The design: each thread loads 16 weight bytes at a time,
// coalesced along the contiguous axis of either layout, and widens them to
// bf16 only in shared memory (exact for |q| <= 127), so device memory sees
// int8; the products run on the tensor cores (WMMA 16x16x16 bf16, f32
// accumulation) with the next step's global loads issued before this
// step's products. The M tile follows M: 16 rows at decode (a 64-row tile
// would be 7/8 padding), 64 at prefill. When the output tiles alone cannot
// keep every SM streaming weights (few columns, long K), K is split over
// blocks and a second pass sums the f32 partials in a fixed order before
// the epilogue. An f32 mode (the tiny test configs) uses f32 FMAs, no TF32.
// Offsets into x, q and out are 64-bit: a full-logits product at prefill
// has ~7.4 G outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int THREADS = 128;  // 4 warps
constexpr int BN = 128;       // output columns per block
constexpr int CLD = BN + 4;   // f32 row stride of the epilogue tile

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

__device__ __forceinline__ __nv_bfloat16 bf16_scale(float acc, float s) {
  // round the f32 sum to bf16, then multiply by the bf16 scale in bf16 (the
  // product of two bf16 values is exact in f32, so one rounding)
  const float a = __bfloat162float(__float2bfloat16_rn(acc));
  return __float2bfloat16_rn(a * __bfloat162float(__float2bfloat16_rn(s)));
}

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

// Loads step k0's chunks. Without TAIL a chunk lies wholly inside or
// wholly outside the operand (K % 16 == 0, N % 16 == 0 for [K, N], aligned
// pointers) and is one vector load or zeros; with TAIL each element is
// checked.
template <int BM, bool NT, bool TAIL>
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
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row < m) {
      const uint16_t* p = x + row * k + kc;
      if constexpr (TAIL) {
        __align__(16) uint16_t h[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) h[e] = kc + e < k ? p[e] : 0;
        v = *reinterpret_cast<const uint4*>(h);
      } else if (kc < k) {
        v = *reinterpret_cast<const uint4*>(p);
      }
    }
    t.x[i] = v;
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
    uint4 v = make_uint4(0, 0, 0, 0);
    if (orow < rows) {
      const int8_t* p = q + orow * cols + ocol;
      if constexpr (TAIL) {
        __align__(16) int8_t b[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) b[e] = ocol + e < cols ? p[e] : 0;
        v = *reinterpret_cast<const uint4*>(b);
      } else if (ocol < cols) {
        v = *reinterpret_cast<const uint4*>(p);
      }
    }
    t.q[i] = v;
  }
}

// 16 int8 values -> 16 bf16 values (lo: the first 8), exactly, without
// the quarter-rate conversion instructions: a byte u = q + 128 placed in
// the mantissa of 2^23 makes the float 2^23 + u, and subtracting 2^23 + 128
// leaves q; a small integer's f32 bits end in 16 zeros, so its top half is
// its bf16.
__device__ __forceinline__ void widen16(uint4 v, uint4& lo, uint4& hi) {
  const uint32_t w[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u, v.z ^ 0x80808080u,
                         v.w ^ 0x80808080u};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float f[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[j] = __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7540 | j)) - 8388736.0f;
    o[2 * i] = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
    o[2 * i + 1] = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
  }
  lo = make_uint4(o[0], o[1], o[2], o[3]);
  hi = make_uint4(o[4], o[5], o[6], o[7]);
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

// Block (x, y, z): output columns [x*BN, +BN), rows [y*BM, +BM), depth
// steps of split z. With one split the epilogue writes out in bf16; with
// several, the raw f32 sums go to partial[z][M][N].
template <int BM, bool NT, bool TAIL>
__global__ void __launch_bounds__(THREADS)
mm_int8_bf16(const uint16_t* __restrict__ x, const int8_t* __restrict__ q,
             const float* __restrict__ s, __nv_bfloat16* __restrict__ out,
             float* __restrict__ partial, long long m, int n, int k, int steps_per_split) {
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
  if (s_begin < s_end) load_step<BM, NT, TAIL>(t, x, q, m, n, k, m0, n0, s_begin * BK);
  for (int st = s_begin; st < s_end; ++st) {
    stage_step<BM, NT>(t, xs, qs);
    __syncthreads();
    if (st + 1 < s_end) load_step<BM, NT, TAIL>(t, x, q, m, n, k, m0, n0, (st + 1) * BK);
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
  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int r = e / BN, c = e % BN;
    const long long row = m0 + r;
    const int col = n0 + c;
    if (row >= m || col >= n) continue;
    const float v = cs[r * CLD + c];
    if (partial) partial[((long long)blockIdx.z * m + row) * n + col] = v;
    else out[row * n + col] = bf16_scale(v, s[col]);
  }
}

// The second pass of a split product: sums the partials in split order,
// then the epilogue.
__global__ void split_reduce(const float* __restrict__ partial, const float* __restrict__ s,
                             __nv_bfloat16* __restrict__ out, long long m, int n, int splits) {
  const long long total = m * n;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    float v = 0.0f;
    for (int z = 0; z < splits; ++z) v += partial[z * total + e];
    out[e] = bf16_scale(v, s[static_cast<int>(e % n)]);
  }
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

template <int BM, bool NT>
cudaError_t launch_bf16(const void* x, const void* q, const float* s, void* out,
                        float* partial, long long m, int n, int k, int splits, bool tail,
                        cudaStream_t stream) {
  constexpr int BK = Cfg<BM>::BK;
  const long long mt = (m + BM - 1) / BM;
  if (mt > 65535 || splits > 65535) return cudaErrorInvalidValue;
  const int nsteps = (k + BK - 1) / BK;
  const int per = (nsteps + splits - 1) / splits;
  dim3 grid((n + BN - 1) / BN, static_cast<unsigned>(mt), splits);
  const auto* xp = static_cast<const uint16_t*>(x);
  const auto* qp = static_cast<const int8_t*>(q);
  auto* op = static_cast<__nv_bfloat16*>(out);
  float* pp = splits > 1 ? partial : nullptr;
  if (tail)
    mm_int8_bf16<BM, NT, true><<<grid, THREADS, 0, stream>>>(xp, qp, s, op, pp, m, n, k, per);
  else
    mm_int8_bf16<BM, NT, false><<<grid, THREADS, 0, stream>>>(xp, qp, s, op, pp, m, n, k, per);
  return cudaGetLastError();
}

}  // namespace

// mode 0: x bf16, out bf16; mode 1: x f32, out f32 (splits must be 1).
// transpose_rhs: q is [N, K]; else [K, N]. partial: [splits, M, N] f32
// scratch when splits > 1. tail: the element-checked loads (K % 16,
// N % 16 for [K, N], or an unaligned operand).
extern "C" int matmul_int8(const void* x, const void* q, const float* s, void* out,
                           float* partial, int mode, int transpose_rhs, long long m, int n,
                           int k, int splits, int tail, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (m <= 0 || n <= 0 || k <= 0 || splits < 1) return cudaErrorInvalidValue;
  cudaError_t err;
  if (mode == 1) {
    if (splits != 1 || (m + 31) / 32 > 65535) return cudaErrorInvalidValue;
    dim3 grid((n + 31) / 32, static_cast<unsigned>((m + 31) / 32));
    const auto* xp = static_cast<const float*>(x);
    const auto* qp = static_cast<const int8_t*>(q);
    auto* op = static_cast<float*>(out);
    if (transpose_rhs) mm_int8_f32<true><<<grid, 256, 0, stream>>>(xp, qp, s, op, m, n, k);
    else mm_int8_f32<false><<<grid, 256, 0, stream>>>(xp, qp, s, op, m, n, k);
    return cudaGetLastError();
  }
  if (mode != 0) return cudaErrorInvalidValue;
  const bool t = tail != 0;
  if (m <= 16)
    err = transpose_rhs ? launch_bf16<16, true>(x, q, s, out, partial, m, n, k, splits, t, stream)
                        : launch_bf16<16, false>(x, q, s, out, partial, m, n, k, splits, t, stream);
  else
    err = transpose_rhs ? launch_bf16<64, true>(x, q, s, out, partial, m, n, k, splits, t, stream)
                        : launch_bf16<64, false>(x, q, s, out, partial, m, n, k, splits, t, stream);
  if (err != cudaSuccess || splits == 1) return err;
  const long long total = m * n;
  const long long want = (total + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  split_reduce<<<blocks, 256, 0, stream>>>(partial, s, static_cast<__nv_bfloat16*>(out), m, n,
                                         splits);
  return cudaGetLastError();
}
