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
// Bound on this card: device-memory bytes. The kernel reads q, k and v once
// and writes q (in place), k and v once, plus a scale a slot (int8) or a
// group (int4). Design: one block a token (a grid-stride loop over the
// tokens), a warp a row of the token (a query head, a key head or a value
// head), as many warps as the rows take in the fewest rounds of at most
// 16 (10 warps at Gemma-2B, 16 in three rounds at Mistral-7B). A block
// computes the frequencies theta^(-i / (hd/2)) once, then each token's
// cos / sin table (hd / 2 angles) into shared memory, once for all its
// heads; then each warp takes its rows. A lane rotates two neighbouring pairs (i, i + hd/2) at a
// time, so a warp's loads are whole 128-byte lines at bf16 hd 256. A key or
// value row is staged in shared memory (one row a warp) after its rounding
// to the compute type; the warp then writes it to the cache: a cast, or
// int8 with the row's absmax from a warp-shuffle max, or int4 with the max
// of each 32-lane group over the 16 lanes that hold its bytes.
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

namespace {

constexpr int kMaxWarps = 16;  // warps a block: a token's rows, at most 16
constexpr int kMaxHeadDim = 256;

__device__ __forceinline__ void load2(const __nv_bfloat16* p, float& a, float& b) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  a = f.x;
  b = f.y;
}
__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 f = *reinterpret_cast<const float2*>(p);
  a = f.x;
  b = f.y;
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float round_to(float x, const float*) { return x; }

__device__ __forceinline__ float warp_max(float m, int width) {
  for (int off = width / 2; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

// The pair (x1, x2) rotated by the angle whose cosine and sine are c, s.
__device__ __forceinline__ void rotate(float& x1, float& x2, float c, float s) {
  const float o1 = __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s));
  const float o2 = __fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s));
  x1 = o1;
  x2 = o2;
}

// Steps of 64 pairs a warp takes over a row: hd / 2 <= 128.
constexpr int kPairSteps = kMaxHeadDim / 2 / 64;

// Row `head` of a token: a query head of q, else a key head of k, else a
// value head of v.
template <typename T>
__device__ __forceinline__ const T* row_src(const T* q, const T* k, const T* v, long long token,
                                            int head, int h, int kvh, int hd) {
  if (head < h) return q + (token * h + head) * hd;
  if (head < h + kvh) return k + (token * kvh + head - h) * hd;
  return v + (token * kvh + head - h - kvh) * hd;
}

// A lane's pairs of a row into registers: x1 at i, i + 1 and x2 at i + half,
// i + half + 1, for i = 2 lane + 64 m.
template <typename T>
__device__ __forceinline__ void load_row(const T* src, int lane, int half,
                                         float (&x1)[kPairSteps][2], float (&x2)[kPairSteps][2]) {
#pragma unroll
  for (int m = 0; m < kPairSteps; ++m) {
    const int i = 2 * lane + 64 * m;
    if (i < half) {
      load2(src + i, x1[m][0], x1[m][1]);
      load2(src + i + half, x2[m][0], x2[m][1]);
    }
  }
}

// T: q, k and v's type (the compute type). KIND: the destination of k and
// v: 0 bf16, 1 f32, 2 int8 with a scale a slot, 3 int4 with a scale a
// group of `group` lanes (scale rows kv_head * (hd / group) + g).
template <typename T, int KIND>
__global__ void __launch_bounds__(kMaxWarps * 32) rope_kv_kernel(
    T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const long long* __restrict__ positions, const long long* __restrict__ cursor,
    void* __restrict__ kbuf, void* __restrict__ vbuf, float* __restrict__ kscale,
    float* __restrict__ vscale, int b, int t, int h, int kvh, int hd, int s, int group,
    long long pos_sb, long long pos_st, long long kv_b, long long kv_h, long long sc_b,
    long long sc_r, float theta) {
  __shared__ float staged[kMaxWarps][kMaxHeadDim];
  __shared__ float freq_t[kMaxHeadDim / 2], cos_t[kMaxHeadDim / 2], sin_t[kMaxHeadDim / 2];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  const int per_token = h + 2 * kvh;
  const long long tokens = static_cast<long long>(b) * t;
  const int half = hd / 2;
  const float inv_half = 1.0f / static_cast<float>(half);
  const long long slot0 = cursor ? *cursor : 0;
  float* row = staged[warp];
  for (int i = threadIdx.x; i < half; i += blockDim.x)  // theta^(-i / half), once a block
    freq_t[i] = powf(theta, __fmul_rn(-static_cast<float>(i), inv_half));
  for (long long token = blockIdx.x; token < tokens; token += gridDim.x) {
    const int bi = static_cast<int>(token / t), ti = static_cast<int>(token % t);
    const float pf = static_cast<float>(positions[bi * pos_sb + ti * pos_st]);
    // the warp's first row is loaded before the table, so that its loads
    // are in flight while the block computes the angles
    float x1[kPairSteps][2], x2[kPairSteps][2];
    int head = warp;
    if (head < per_token) load_row(row_src(q, k, v, token, head, h, kvh, hd), lane, half, x1, x2);
    __syncthreads();  // the frequencies are written, the previous token's table read
    for (int i = threadIdx.x; i < half; i += blockDim.x) {
      const float ang = __fmul_rn(pf, freq_t[i]);
      cos_t[i] = cosf(ang);
      sin_t[i] = sinf(ang);
    }
    __syncthreads();
    for (; head < per_token; head += warps) {
      const bool is_q = head < h, is_k = !is_q && head < h + kvh;
      const int kv_head = is_q ? 0 : (head - h) % kvh;
      const T* src = row_src(q, k, v, token, head, h, kvh, hd);
      if (head != warp) load_row(src, lane, half, x1, x2);
#pragma unroll
      for (int m = 0; m < kPairSteps; ++m) {
        const int i = 2 * lane + 64 * m;  // pairs (i, i + half) and (i + 1, i + 1 + half)
        if (i >= half) break;
        float a0 = x1[m][0], a1 = x1[m][1], b0 = x2[m][0], b1 = x2[m][1];
        if (!is_q && !is_k) {
          row[i] = a0;
          row[i + 1] = a1;
          row[i + half] = b0;
          row[i + half + 1] = b1;
          continue;
        }
        rotate(a0, b0, cos_t[i], sin_t[i]);
        rotate(a1, b1, cos_t[i + 1], sin_t[i + 1]);
        if (is_q) {
          T* dst = q + (token * h + head) * hd;
          store2(dst + i, a0, a1);
          store2(dst + i + half, b0, b1);
        } else {
          row[i] = round_to(a0, src);
          row[i + 1] = round_to(a1, src);
          row[i + half] = round_to(b0, src);
          row[i + half + 1] = round_to(b1, src);
        }
      }
      if (is_q) continue;
      __syncwarp();
      const long long slot = slot0 + ti;
      if (slot < s) {
        const long long row_len = KIND == 3 ? hd / 2 : hd;
        const long long at = bi * kv_b + kv_head * kv_h + slot * row_len;
        void* buf = is_k ? kbuf : vbuf;
        float* scales = is_k ? kscale : vscale;
        if constexpr (KIND == 0) {
          __nv_bfloat16* out = static_cast<__nv_bfloat16*>(buf) + at;
          for (int e = lane; e < hd; e += 32) out[e] = __float2bfloat16_rn(row[e]);
        } else if constexpr (KIND == 1) {
          float* out = static_cast<float*>(buf) + at;
          for (int e = lane; e < hd; e += 32) out[e] = row[e];
        } else if constexpr (KIND == 2) {
          float m = 0.0f;
          for (int e = lane; e < hd; e += 32) m = fmaxf(m, fabsf(row[e]));
          m = warp_max(m, 32);
          float sc = __fmul_rn(m, 1.0f / 127.0f);
          if (sc == 0.0f) sc = 1.0f;
          int8_t* out = static_cast<int8_t*>(buf) + at;
          for (int e = lane; e < hd; e += 32) {
            const float r = fminf(fmaxf(rintf(__fdiv_rn(row[e], sc)), -127.0f), 127.0f);
            out[e] = static_cast<int8_t>(r);
          }
          if (lane == 0) scales[bi * sc_b + kv_head * sc_r + slot] = sc;
        } else {
          // byte j holds lanes 2j (lo) and 2j + 1 (hi); a group's bytes are
          // group / 2 neighbouring lanes of the warp
          const int bytes = hd / 2, group_bytes = group / 2, groups = hd / group;
          uint8_t* out = static_cast<uint8_t*>(buf) + at;
          for (int j0 = 0; j0 < bytes; j0 += 32) {
            const int j = j0 + lane;
            const bool in = j < bytes;
            const float lo = in ? row[2 * j] : 0.0f, hi = in ? row[2 * j + 1] : 0.0f;
            const float m = warp_max(fmaxf(fabsf(lo), fabsf(hi)), group_bytes);
            float sc = __fmul_rn(m, 1.0f / 7.0f);
            if (sc == 0.0f) sc = 1.0f;
            if (in) {
              const float ql = fminf(fmaxf(rintf(__fdiv_rn(lo, sc)), -7.0f), 7.0f);
              const float qh = fminf(fmaxf(rintf(__fdiv_rn(hi, sc)), -7.0f), 7.0f);
              out[j] = static_cast<uint8_t>((static_cast<int>(ql) + 8) |
                                            ((static_cast<int>(qh) + 8) << 4));
              if (j % group_bytes == 0) {
                const int g = 2 * j / group;
                scales[bi * sc_b + static_cast<long long>(kv_head * groups + g) * sc_r + slot] = sc;
              }
            }
          }
        }
      }
      __syncwarp();  // the row is read before the warp's next head stages another
    }
  }
}

template <typename T, int KIND>
int launch(void* q, const void* k, const void* v, const void* positions, const void* cursor,
           void* kbuf, void* vbuf, void* kscale, void* vscale, int b, int t, int h, int kvh,
           int hd, int s, int group, long long pos_sb, long long pos_st, long long kv_b,
           long long kv_h, long long sc_b, long long sc_r, float theta, int sms,
           cudaStream_t st) {
  long long blocks = static_cast<long long>(b) * t;  // a block a token
  const long long cap = static_cast<long long>(sms) * 16;  // a grid-stride loop beyond
  if (blocks > cap) blocks = cap;
  // a warp a row of the token, in as few rounds as 16 warps allow
  const int per_token = h + 2 * kvh, rounds = (per_token + kMaxWarps - 1) / kMaxWarps;
  const int warps = (per_token + rounds - 1) / rounds;
  rope_kv_kernel<T, KIND><<<static_cast<unsigned>(blocks), warps * 32, 0, st>>>(
      static_cast<T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const long long*>(positions), static_cast<const long long*>(cursor), kbuf, vbuf,
      static_cast<float*>(kscale), static_cast<float*>(vscale), b, t, h, kvh, hd, s, group,
      pos_sb, pos_st, kv_b, kv_h, sc_b, sc_r, theta);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_kind(int kind, void* q, const void* k, const void* v, const void* positions,
            const void* cursor, void* kbuf, void* vbuf, void* kscale, void* vscale, int b, int t,
            int h, int kvh, int hd, int s, int group, long long pos_sb, long long pos_st,
            long long kv_b, long long kv_h, long long sc_b, long long sc_r, float theta, int sms,
            cudaStream_t st) {
#define ROPE_KV_LAUNCH(K)                                                                        \
  launch<T, K>(q, k, v, positions, cursor, kbuf, vbuf, kscale, vscale, b, t, h, kvh, hd, s,     \
               group, pos_sb, pos_st, kv_b, kv_h, sc_b, sc_r, theta, sms, st)
  switch (kind) {
    case 0: return ROPE_KV_LAUNCH(0);
    case 1: return ROPE_KV_LAUNCH(1);
    case 2: return ROPE_KV_LAUNCH(2);
    default: return ROPE_KV_LAUNCH(3);
  }
#undef ROPE_KV_LAUNCH
}

}  // namespace

// q [B, T, H, hd], k and v [B, T, KV, hd], contiguous, in dt (0 bf16, 1
// f32); q is rotated in place. positions [B, T] int64 at element strides
// (pos_sb, pos_st); cursor a device int64 (null: 0). kbuf / vbuf: one cache
// layer [B, KV, S, row] at element strides kv_b, kv_h (slot rows
// contiguous) of kind 0 bf16, 1 f32, 2 int8, 3 int4 (row hd / 2 bytes);
// kscale / vscale [B, rows, S] f32 at strides sc_b, sc_r (int8: a row a kv
// head; int4: hd / group rows a kv head). Slots past S are not written.
extern "C" int rope_kv(void* q, const void* k, const void* v, const void* positions,
                       const void* cursor, void* kbuf, void* vbuf, void* kscale, void* vscale,
                       int dt, int kind, int b, int t, int h, int kvh, int hd, int s, int group,
                       long long pos_sb, long long pos_st, long long kv_b, long long kv_h,
                       long long sc_b, long long sc_r, float theta, int sms, void* stream) {
  if (hd % 16 || hd > kMaxHeadDim || dt < 0 || dt > 1 || kind < 0 || kind > 3 ||
      (kind >= 2 && (!kscale || !vscale)) ||
      (kind == 3 && (group % 16 || group > 32 || hd % group)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(b) * t == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dt == 0)
    return by_kind<__nv_bfloat16>(kind, q, k, v, positions, cursor, kbuf, vbuf, kscale, vscale,
                                  b, t, h, kvh, hd, s, group, pos_sb, pos_st, kv_b, kv_h, sc_b,
                                  sc_r, theta, sms, st);
  return by_kind<float>(kind, q, k, v, positions, cursor, kbuf, vbuf, kscale, vscale, b, t, h,
                        kvh, hd, s, group, pos_sb, pos_st, kv_b, kv_h, sc_b, sc_r, theta, sms,
                        st);
}
