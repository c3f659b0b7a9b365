// Rotary embedding of q and k, with k and v written where attention reads
// them: the layer's slots of the KV cache in its stored type, or new
// contiguous [B, KV, T, hd] tensors when there is no cache.
//
// Replaces no Pallas kernel: the JAX package's rope
// (probing_rag_tpu/models/gemma.py:743-752) and the K/V swap, quantization
// and dynamic_update_slice into the cache (:847-906) are fused by XLA. The
// plain ops take some 14 kernels a rope (pow, cos and sin recomputed each
// layer, f32 copies of q and k) and as many again for the quantizers and
// index_copy_.
//
// Bound on this card: device-memory bytes at a prefill (the kernel reads
// q, k and v once and writes q in place, k and v once, plus a scale a slot
// (int8) or a group (int4)), latency at a decode step's 8 tokens.
//
// Design (the plan is ops/block.py::plan_rope's; the entry checks it): a
// lane holds vectors of `vec_bytes` (16, or 8 at a decode step into an
// int8 / int4 cache), the vector p of a row's first half (x1) and the
// vector p of its second half (x2), so the pairs (i, i + hd/2) it rotates
// are its own and no lane waits on another: `lanes_row` lanes a row (hd/2
// elements over a vector, rounded up to a power of two; at bf16 hd 256 16
// lanes of 16 bytes, so a warp takes two rows a step, or 32 of 8 bytes). A
// token's rows (its query heads, then key heads, then value heads) are cut
// into such steps; a warp takes `steps_warp` steps of one token,
// `warps_token` warps a token, `tokens_block` tokens a block, no
// grid-stride loop. A warp issues the cursor read and every load of its
// steps (up to 6) before anything waits; meanwhile the block's threads
// compute its tokens' cos / sin tables into shared memory, an angle a
// thread (its only barrier), so no angle is computed twice. Each lane then
// reads the cos and sin of its own pairs, rotates, and stores its vectors
// of q in place, or writes its k or v vectors into the cache at the
// device-side cursor in the cache's type with vector stores (at 16-byte
// bf16 vectors: 16 bytes of bf16, 8 of int8, 4 of int4). int8 takes the
// row's absmax by xor shuffles over the row's lanes (one warp-wide max
// where the row is a warp's: non-negative floats order as their bits);
// int4 the max of each group: over the group's lanes where the groups lie
// inside a half (hd a multiple of 64), else each group's over all the
// row's lanes. At a decode step a warp takes one step, so a token's rows
// spread over several warps, and into a quantized cache the 8-byte vectors
// give a key or value row a whole warp, halving each lane's divides.
//
// Numerics, as the plain ops compute them on the card: the exponent -i /
// (hd/2) as a product by the reciprocal (torch divides by a scalar so),
// powf, the position converted to f32 and multiplied, cosf and sinf (no
// fast-math), then x1 c - x2 s and x2 c + x1 s as separate IEEE products
// and a sum (__fmul_rn, __fsub_rn, __fadd_rn: nvcc contracts nothing). The
// quantizers: absmax exact, the scale absmax * (1 / 127) or * (1 / 7) (the
// card's divide by a scalar), 0 replaced by 1, x / scale an IEEE divide,
// rintf (half to even), clamped; int4 values packed as (q + 8) lo / hi
// nibbles. The cursor is read on the device from kv_cache["pos"], so the
// launch can sit inside a captured CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxHeadDim = 256;
constexpr int kMaxSteps = 6;  // row steps a warp holds at once
constexpr int kMaxThreads = 512;  // a block (128 registers a thread)
constexpr int kMaxTokens = kMaxThreads / 32;  // a block's tokens

struct Args {
  void* q;
  const void* k;
  const void* v;
  const long long* positions;
  const long long* cursor;
  void* kbuf;
  void* vbuf;
  float* kscale;
  float* vscale;
  int b, t, h, kvh, hd, s, group;
  long long pos_sb, pos_st, kv_b, kv_h, sc_b, sc_r;
  float theta;
  int lanes_row, steps_warp, warps_token, tokens_block;
};

// N bytes (a power of two, 1 to 32, aligned to min(N, 16)) from and to
// 32-bit words
template <int N>
__device__ __forceinline__ void load_bytes(const void* p, uint32_t* w) {
  if constexpr (N == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
  } else {
    static_assert(N == 8, "8- or 16-byte vectors");
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x, w[1] = u.y;
  }
}
template <int N>
__device__ __forceinline__ void store_bytes(void* p, const uint32_t* w) {
  if constexpr (N == 32) {
    reinterpret_cast<uint4*>(p)[0] = make_uint4(w[0], w[1], w[2], w[3]);
    reinterpret_cast<uint4*>(p)[1] = make_uint4(w[4], w[5], w[6], w[7]);
  } else if constexpr (N == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (N == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else if constexpr (N == 4) {
    *reinterpret_cast<uint32_t*>(p) = w[0];
  } else if constexpr (N == 2) {
    *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(w[0]);
  } else {
    *reinterpret_cast<uint8_t*>(p) = static_cast<uint8_t>(w[0]);
  }
}

// A vector of E elements of T widened to f32, and rounded back.
template <int E>
__device__ __forceinline__ void unpack(const uint32_t* w, float (&x)[E], const __nv_bfloat16*) {
#pragma unroll
  for (int j = 0; j < E / 2; ++j) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
    x[2 * j] = f.x;
    x[2 * j + 1] = f.y;
  }
}
template <int E>
__device__ __forceinline__ void unpack(const uint32_t* w, float (&x)[E], const float*) {
#pragma unroll
  for (int j = 0; j < E; ++j) x[j] = __uint_as_float(w[j]);
}
template <int E>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&x)[E]) {
  uint32_t w[E / 2];
#pragma unroll
  for (int j = 0; j < E / 2; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * j], x[2 * j + 1]);
    w[j] = *reinterpret_cast<const uint32_t*>(&h);
  }
  store_bytes<2 * E>(p, w);
}
template <int E>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[E]) {
  uint32_t w[E];
#pragma unroll
  for (int j = 0; j < E; ++j) w[j] = __float_as_uint(x[j]);
  store_bytes<4 * E>(p, w);
}
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float round_to(float x, const float*) { return x; }

// int8 values of x / sc, rounded half to even and clamped to +-lim.
__device__ __forceinline__ int quant(float x, float sc, float lim) {
  return static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(x, sc)), -lim), lim));
}
template <int E>
__device__ __forceinline__ void store_int8(int8_t* p, const float (&x)[E], float sc) {
  uint32_t w[(E + 3) / 4] = {};
#pragma unroll
  for (int e = 0; e < E; ++e)
    w[e / 4] |= static_cast<uint32_t>(quant(x[e], sc, 127.0f) & 0xff) << (8 * (e % 4));
  store_bytes<E>(p, w);
}
// byte j holds elements 2j (lo nibble) and 2j + 1 (hi), each q + 8
template <int E>
__device__ __forceinline__ void store_int4(uint8_t* p, const float (&x)[E], float sc) {
  uint32_t w[1] = {0};
#pragma unroll
  for (int e = 0; e < E; ++e) w[0] |= static_cast<uint32_t>(quant(x[e], sc, 7.0f) + 8) << (4 * e);
  store_bytes<E / 2>(p, w);
}

// max over the `lanes` neighbouring lanes (a power of two, aligned)
__device__ __forceinline__ float lanes_max(float m, int lanes) {
  for (int off = lanes / 2; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}
template <int E>
__device__ __forceinline__ float abs_max(const float (&x)[E]) {
  float m = 0.0f;
#pragma unroll
  for (int e = 0; e < E; ++e) m = fmaxf(m, fabsf(x[e]));
  return m;
}

// Row `row` of a token: a query head of q, else a key head of k, else a
// value head of v.
template <typename T>
__device__ __forceinline__ const T* row_src(const Args& a, int token, int row) {
  const long long tk = token;
  if (row < a.h) return static_cast<const T*>(a.q) + (tk * a.h + row) * a.hd;
  if (row < a.h + a.kvh) return static_cast<const T*>(a.k) + (tk * a.kvh + row - a.h) * a.hd;
  return static_cast<const T*>(a.v) + (tk * a.kvh + row - a.h - a.kvh) * a.hd;
}

// T: q, k and v's type (the compute type). KIND: the destination of k and
// v: 0 bf16, 1 f32, 2 int8 with a scale a slot, 3 int4 with a scale a
// group of `group` lanes (scale rows kv_head * (hd / group) + g).
// S: the row steps a warp holds (1 at a decode step, else kMaxSteps): the
// code a decode step runs once from a cold instruction cache stays short.
template <typename T, int KIND, int VB, int S>
__global__ void __launch_bounds__(kMaxThreads) rope_kv_kernel(Args a) {
  constexpr int E = VB / sizeof(T);  // elements a vector of VB bytes
  constexpr int W = VB / 4;          // its 32-bit words
  __shared__ __align__(16) float cos_t[kMaxTokens * kMaxHeadDim / 2];
  __shared__ __align__(16) float sin_t[kMaxTokens * kMaxHeadDim / 2];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lr = a.lanes_row, rows_step = 32 / lr;
  const int h = a.h, kvh = a.kvh, hd = a.hd, half = hd / 2;
  const int rows = h + 2 * kvh, steps = (rows + rows_step - 1) / rows_step;
  const int p = lane % lr, vecs = half / E;  // lanes p >= vecs hold nothing
  // token indices in 32 bits (the entry refuses 2^31 tokens): a 64-bit
  // divide would sit in front of every address
  const int token = blockIdx.x * a.tokens_block + warp / a.warps_token;
  const int tokens = a.b * a.t;
  const bool token_ok = token < tokens;
  const int step0 = (warp % a.warps_token) * a.steps_warp;
  const int bi = token_ok ? token / a.t : 0;
  const int ti = token_ok ? token % a.t : 0;
  // the cursor and every row's loads before anything waits
  long long slot0 = 0;
  uint32_t x1[S][W] = {}, x2[S][W] = {};
  if (token_ok) {
    if (a.cursor) slot0 = *a.cursor;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int row = (step0 + s) * rows_step + lane / lr;
      if (s < a.steps_warp && row < rows && p < vecs) {
        const T* src = row_src<T>(a, token, row);
        load_bytes<VB>(src + p * E, x1[s]);
        load_bytes<VB>(src + half + p * E, x2[s]);
      }
    }
  }
  // meanwhile the block's cos / sin tables, an angle a thread: entry j is
  // angle i = j mod half of the block's token j / half
  const float inv_half = 1.0f / static_cast<float>(half);
  const int token0 = blockIdx.x * a.tokens_block;
  int fi = -1;
  float f = 0.0f;
  for (int j = threadIdx.x; j < a.tokens_block * half; j += blockDim.x) {
    const int tk = token0 + j / half;
    if (tk >= tokens) break;
    const int i = j % half;
    if (i != fi) {  // theta^(-i / half)
      f = powf(a.theta, __fmul_rn(-static_cast<float>(i), inv_half));
      fi = i;
    }
    const long long pk = a.positions[tk / a.t * a.pos_sb + tk % a.t * a.pos_st];
    const float ang = __fmul_rn(static_cast<float>(pk), f);
    cos_t[j] = cosf(ang);
    sin_t[j] = sinf(ang);
  }
  __syncthreads();
  if (!token_ok) return;  // a whole warp: its token is past the last
  float cs[E], sn[E];  // the lane's own angles, i = p E + e
  if (p < vecs) {
    const int at = (warp / a.warps_token) * half + p * E;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      cs[e] = cos_t[at + e];
      sn[e] = sin_t[at + e];
    }
  }
  const long long slot = slot0 + ti;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (s >= a.steps_warp || step0 + s >= steps) break;  // the same for the whole warp
    const int row = (step0 + s) * rows_step + lane / lr;
    const bool ok = row < rows && p < vecs;
    const bool is_q = row < h, is_k = !is_q && row < h + kvh;
    float v1[E], v2[E];
    unpack<E>(x1[s], v1, static_cast<const T*>(nullptr));
    unpack<E>(x2[s], v2, static_cast<const T*>(nullptr));
    if (is_q || is_k) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float o1 = __fsub_rn(__fmul_rn(v1[e], cs[e]), __fmul_rn(v2[e], sn[e]));
        const float o2 = __fadd_rn(__fmul_rn(v2[e], cs[e]), __fmul_rn(v1[e], sn[e]));
        v1[e] = is_k ? round_to(o1, static_cast<const T*>(nullptr)) : o1;
        v2[e] = is_k ? round_to(o2, static_cast<const T*>(nullptr)) : o2;
      }
    }
    if (is_q) {
      if (ok) {
        T* dst = static_cast<T*>(a.q) + (static_cast<long long>(token) * h + row) * hd;
        store_vec<E>(dst + p * E, v1);
        store_vec<E>(dst + half + p * E, v2);
      }
      if constexpr (KIND < 2) continue;  // the quantizers' shuffles take every lane
    }
    const bool write = ok && !is_q && slot < a.s;
    const int kv_head = is_k ? row - h : row - h - kvh;
    const long long row_len = KIND == 3 ? hd / 2 : hd;
    const long long at = bi * a.kv_b + kv_head * a.kv_h + slot * row_len;
    void* buf = is_k ? a.kbuf : a.vbuf;
    float* scales = is_k ? a.kscale : a.vscale;
    if constexpr (KIND == 0 || KIND == 1) {
      if (write) {
        using C = typename std::conditional<KIND == 0, __nv_bfloat16, float>::type;
        C* out = static_cast<C*>(buf) + at;
        store_vec<E>(out + p * E, v1);
        store_vec<E>(out + half + p * E, v2);
      }
    } else if constexpr (KIND == 2) {
      float m = ok && !is_q ? fmaxf(abs_max<E>(v1), abs_max<E>(v2)) : 0.0f;
      if (lr == 32)  // a warp's max in one step: non-negative floats order as their bits
        m = __uint_as_float(__reduce_max_sync(0xffffffffu, __float_as_uint(m)));
      else
        m = lanes_max(m, lr);
      float sc = __fmul_rn(m, 1.0f / 127.0f);
      if (sc == 0.0f) sc = 1.0f;
      if (write) {
        int8_t* out = static_cast<int8_t*>(buf) + at;
        store_int8<E>(out + p * E, v1, sc);
        store_int8<E>(out + half + p * E, v2, sc);
        if (p == 0) scales[bi * a.sc_b + kv_head * a.sc_r + slot] = sc;
      }
    } else {
      const int g = a.group, groups = hd / g;
      const int o1 = p * E, o2 = half + p * E;  // the vectors' first elements
      float m1 = ok && !is_q ? abs_max<E>(v1) : 0.0f;
      float m2 = ok && !is_q ? abs_max<E>(v2) : 0.0f;
      if (half % g == 0) {  // a group: g / E neighbouring lanes' vectors of one half
        m1 = lanes_max(m1, g / E);
        m2 = lanes_max(m2, g / E);
      } else {  // groups across the halves' boundary: each over all the row's lanes
        float r1 = 0.0f, r2 = 0.0f;
        for (int gi = 0; gi < groups; ++gi) {
          float mg = fmaxf(o1 / g == gi ? m1 : 0.0f, o2 / g == gi ? m2 : 0.0f);
          mg = lanes_max(mg, lr);
          if (o1 / g == gi) r1 = mg;
          if (o2 / g == gi) r2 = mg;
        }
        m1 = r1;
        m2 = r2;
      }
      float sc1 = __fmul_rn(m1, 1.0f / 7.0f), sc2 = __fmul_rn(m2, 1.0f / 7.0f);
      if (sc1 == 0.0f) sc1 = 1.0f;
      if (sc2 == 0.0f) sc2 = 1.0f;
      if (write) {
        uint8_t* out = static_cast<uint8_t*>(buf) + at;
        store_int4<E>(out + o1 / 2, v1, sc1);
        store_int4<E>(out + o2 / 2, v2, sc2);
        float* sc_row = scales + bi * a.sc_b + slot;  // group gi's scale at row kv_head G + gi
        if (o1 % g == 0) sc_row[static_cast<long long>(kv_head * groups + o1 / g) * a.sc_r] = sc1;
        if (o2 % g == 0) sc_row[static_cast<long long>(kv_head * groups + o2 / g) * a.sc_r] = sc2;
      }
    }
  }
}

template <typename T, int VB, int S>
cudaError_t by_kind(int kind, const Args& a, int blocks, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(blocks)), block(a.tokens_block * a.warps_token * 32);
  switch (kind) {
    case 0: rope_kv_kernel<T, 0, VB, S><<<grid, block, 0, st>>>(a); break;
    case 1: rope_kv_kernel<T, 1, VB, S><<<grid, block, 0, st>>>(a); break;
    case 2: rope_kv_kernel<T, 2, VB, S><<<grid, block, 0, st>>>(a); break;
    default: rope_kv_kernel<T, 3, VB, S><<<grid, block, 0, st>>>(a); break;
  }
  return cudaGetLastError();
}

// 8-byte vectors at a decode step into a quantized cache (a step a warp);
// 16 bytes, a step or up
// to kMaxSteps a warp, otherwise
template <typename T>
cudaError_t by_vector(int kind, const Args& a, int vec_bytes, int blocks, cudaStream_t st) {
  if (vec_bytes == 8) return by_kind<T, 8, 1>(kind, a, blocks, st);
  if (a.steps_warp == 1) return by_kind<T, 16, 1>(kind, a, blocks, st);
  return by_kind<T, 16, kMaxSteps>(kind, a, blocks, st);
}

}  // namespace

// q [B, T, H, hd], k and v [B, T, KV, hd], contiguous, in dt (0 bf16, 1
// f32); q is rotated in place. positions [B, T] int64 at element strides
// (pos_sb, pos_st); cursor a device int64 (null: 0). kbuf / vbuf: one cache
// layer [B, KV, S, row] at element strides kv_b, kv_h (slot rows
// contiguous) of kind 0 bf16, 1 f32, 2 int8, 3 int4 (row hd / 2 bytes);
// kscale / vscale [B, rows, S] f32 at strides sc_b, sc_r (int8: a row a kv
// head; int4: hd / group rows a kv head). Slots past S are not written.
// Every pointer 16-byte aligned. The plan (ops/block.py::plan_rope): a
// lane's vectors of `vec_bytes` (8, with a step a warp, or 16);
// `lanes_row` lanes a row, which must be hd / 2 over a vector rounded up
// to a power of two; `steps_warp` steps a warp (at most 6), `warps_token`
// warps a token covering its rows, `tokens_block` tokens a block,
// `blocks` blocks covering the tokens; fewer than 2^31 tokens.
extern "C" int rope_kv(void* q, const void* k, const void* v, const void* positions,
                       const void* cursor, void* kbuf, void* vbuf, void* kscale, void* vscale,
                       int dt, int kind, int b, int t, int h, int kvh, int hd, int s, int group,
                       long long pos_sb, long long pos_st, long long kv_b, long long kv_h,
                       long long sc_b, long long sc_r, float theta, int vec_bytes,
                       int lanes_row, int steps_warp, int warps_token, int tokens_block,
                       int blocks, void* stream) {
  if (hd % 16 || hd > kMaxHeadDim || dt < 0 || dt > 1 || kind < 0 || kind > 3 ||
      (kind >= 2 && (!kscale || !vscale)) ||
      (kind == 3 && (group % 16 || group > 32 || hd % group)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tokens = static_cast<long long>(b) * t;
  if (tokens == 0) return 0;
  if (tokens >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if ((vec_bytes != 8 && vec_bytes != 16) || (vec_bytes == 8 && steps_warp != 1))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int vecs = hd / 2 * (dt == 0 ? 2 : 4) / vec_bytes;
  int lanes = 1;
  while (lanes < vecs) lanes *= 2;
  const int rows_step = 32 / lanes, steps = (h + 2 * kvh + rows_step - 1) / rows_step;
  if (lanes_row != lanes || steps_warp < 1 || steps_warp > kMaxSteps || warps_token < 1 ||
      static_cast<long long>(warps_token) * steps_warp < steps ||
      static_cast<long long>(warps_token - 1) * steps_warp >= steps || tokens_block < 1 ||
      static_cast<long long>(tokens_block) * warps_token * 32 > kMaxThreads || blocks < 1 ||
      static_cast<long long>(blocks) * tokens_block < tokens ||
      static_cast<long long>(blocks - 1) * tokens_block >= tokens)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const Args a{q, k, v, static_cast<const long long*>(positions),
               static_cast<const long long*>(cursor), kbuf, vbuf, static_cast<float*>(kscale),
               static_cast<float*>(vscale), b, t, h, kvh, hd, s, group, pos_sb, pos_st, kv_b,
               kv_h, sc_b, sc_r, theta, lanes_row, steps_warp, warps_token, tokens_block};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dt == 0 ? by_vector<__nv_bfloat16>(kind, a, vec_bytes, blocks, st)
                                  : by_vector<float>(kind, a, vec_bytes, blocks, st));
}
