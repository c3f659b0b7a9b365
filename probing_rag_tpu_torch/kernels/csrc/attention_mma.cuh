// Tensor-core pieces of decode_attention.cu's bf16 passes: _attn_core's
// function (probing_rag_tpu/models/gemma.py::_attn_core :755) with bf16
// operands and f32 sums, as the JAX einsums with preferred_element_type=f32
// compute it. prefill_attention.cu (wgmma, hopper.cuh) takes from here only
// the cache kinds, the masked score, bf16 rounding and CacheRef.
//
// - Products: mma.sync m16n8k16 (bf16 x bf16 -> f32) fed by ldmatrix /
//   ldmatrix.trans from shared memory.
// - Tiles: K and V tiles of ROWS cache slots x HD lanes, staged by cp.async
//   in a ring of two stages. A bf16 cache lands in its bf16 tile as it is;
//   an f32, int8 or int4 cache lands as raw bytes (and its scales) and is
//   widened to bf16 in shared memory exactly as the plain version's
//   dequant_kv does it: f32 rounded to bf16, int8 bf16(q) * bf16(scale)
//   rounded to bf16, int4 its nibble pairs times bf16(group scale) rounded
//   to bf16. Every product then has the plain version's bf16 operands.
// - Layout: a bf16 tile row is HD * 2 bytes, its 16-byte chunks XOR-swizzled
//   by the row (chunk ^ (row & 7)), so that the eight row addresses of an
//   ldmatrix fall on distinct banks.
// - Masking: a masked score is -1e30, never -inf: a row with no attendable
//   slot is the plain softmax over -1e30, p = 1/S on every slot.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace attn {

enum Kind { kBf16 = 0, kF32 = 1, kInt8 = 2, kInt4 = 3 };
constexpr float kMasked = -1e30f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// two floats as bf16x2, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// d += a b: a 16 x 16 (row), b 16 x 8 (col), d 16 x 8 f32. Fragments
// (lane = 4 g + t): a {(g, 2t), (g + 8, 2t), (g, 2t + 8), (g + 8, 2t + 8)}
// pairs; b {(k 2t, n g), (k 2t + 8, n g)} pairs; d {(g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1)}.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from global to shared; src_bytes 0 writes zeros (src is not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Byte offset of 16-byte chunk c of row r in a swizzled bf16 tile of HD lanes.
template <int HD>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  constexpr int kChunks = HD / 8;
  constexpr int kMask = (kChunks < 8 ? kChunks : 8) - 1;
  return static_cast<uint32_t>(r * (HD * 2) + ((c ^ (r & kMask)) << 4));
}

// A (batch row, kv head) of one cache layer: its slot rows and scales.
struct CacheRef {
  const unsigned char* rows;  // slot 0; slot rows back to back
  const float* sc;            // int8: S floats; int4: its first group row of S floats
  long long sc_r;             // int4: floats between group rows
  int grp;                    // int4 group width in lanes
  int s;                      // slots
};

template <int KIND>
__host__ __device__ constexpr int elem_bits() {
  return KIND == kBf16 ? 16 : KIND == kF32 ? 32 : KIND == kInt8 ? 8 : 4;
}

// A ring of two stages of ROWS-slot tiles of one cache layer, filled by
// NT threads. A bf16 cache's stage is the swizzled bf16 tile itself; any
// other kind's stage holds the raw rows and their scales, widened by
// widen() into one bf16 tile that the products read.
template <int KIND, int HD, int ROWS, int NT>
struct Ring {
  static constexpr int kRowBytes = HD * elem_bits<KIND>() / 8;
  static constexpr int kTileBytes = ROWS * HD * 2;  // a bf16 tile
  static constexpr int kGroups = HD >= 32 && HD % 32 == 0 ? HD / 32 : 1;  // int4 group rows
  static constexpr int kScales = KIND == kInt8 ? ROWS : KIND == kInt4 ? kGroups * ROWS : 0;
  static constexpr int kStageBytes =
      KIND == kBf16 ? kTileBytes : ROWS * kRowBytes + kScales * 4;
  static constexpr int kBytes = 2 * kStageBytes + (KIND == kBf16 ? 0 : kTileBytes);
  static_assert(kRowBytes % 16 == 0, "slot rows must be whole 16-byte pieces");

  unsigned char* base;  // kBytes of shared memory, 16-byte aligned

  __device__ __forceinline__ unsigned char* stage(int i) const { return base + i * kStageBytes; }

  // the bf16 tile the products read for stage i
  __device__ __forceinline__ uint32_t tile(int i) const {
    return smem_u32(KIND == kBf16 ? stage(i) : base + 2 * kStageBytes);
  }

  // cp.async the slots [s0, s0 + ROWS) into stage i (zeros past the cache's end)
  __device__ __forceinline__ void issue(int i, const CacheRef& c, int s0) const {
    constexpr int kPieces = kRowBytes / 16;
    const uint32_t dst = smem_u32(stage(i));
    for (int p = threadIdx.x; p < ROWS * kPieces; p += NT) {
      const int r = p / kPieces, off = p - r * kPieces, slot = s0 + r;
      const unsigned char* src = c.rows + (long long)min(slot, c.s - 1) * kRowBytes + off * 16;
      const uint32_t at = KIND == kBf16 ? swz<HD>(r, off) : static_cast<uint32_t>(p * 16);
      cp_async16(dst + at, src, slot < c.s ? 16 : 0);
    }
    if constexpr (kScales > 0) {
      const uint32_t sdst = dst + ROWS * kRowBytes;
      for (int j = threadIdx.x; j < kScales; j += NT) {
        const int grp_row = j / ROWS, r = j - grp_row * ROWS, slot = s0 + r;
        const float* src = c.sc + grp_row * c.sc_r + min(slot, c.s - 1);
        cp_async4(sdst + j * 4, src, slot < c.s ? 4 : 0);
      }
    }
  }

  // widen stage i into the bf16 tile (not for a bf16 cache; the caller
  // syncs before, once the stage has landed, and after)
  __device__ __forceinline__ void widen(int i, int grp) const {
    if constexpr (KIND != kBf16) {
      constexpr int kC = HD / 8;  // chunks of 8 lanes a row
      const unsigned char* raw = stage(i);
      const float* scl = reinterpret_cast<const float*>(raw + ROWS * kRowBytes);
      unsigned char* out = base + 2 * kStageBytes;
      for (int p = threadIdx.x; p < ROWS * kC; p += NT) {
        const int r = p / kC, c = p - r * kC;
        uint32_t w[4];
        if constexpr (KIND == kF32) {
          const float4 x0 = *reinterpret_cast<const float4*>(raw + r * kRowBytes + c * 32);
          const float4 x1 = *reinterpret_cast<const float4*>(raw + r * kRowBytes + c * 32 + 16);
          w[0] = pack_bf16(x0.x, x0.y);
          w[1] = pack_bf16(x0.z, x0.w);
          w[2] = pack_bf16(x1.x, x1.y);
          w[3] = pack_bf16(x1.z, x1.w);
        } else if constexpr (KIND == kInt8) {
          const uint2 u = *reinterpret_cast<const uint2*>(raw + r * kRowBytes + c * 8);
          const float s = round_bf16(scl[r]);
          float x[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const unsigned int word = e < 4 ? u.x : u.y;
            x[e] = static_cast<float>(static_cast<int>(word << (24 - 8 * (e & 3))) >> 24) * s;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) w[e] = pack_bf16(x[2 * e], x[2 * e + 1]);
        } else {  // int4: byte e holds lanes 2e (low nibble) and 2e + 1, biased by 8
          const unsigned int u = *reinterpret_cast<const unsigned int*>(raw + r * kRowBytes + c * 4);
          const float s = round_bf16(scl[((c * 8) / grp) * ROWS + r]);
          float x[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            x[e] = static_cast<float>(static_cast<int>((u >> (4 * e)) & 0xfu) - 8) * s;
#pragma unroll
          for (int e = 0; e < 4; ++e) w[e] = pack_bf16(x[2 * e], x[2 * e + 1]);
        }
        *reinterpret_cast<uint4*>(out + swz<HD>(r, c)) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
};

// The (b, kv head) bk's cache rows and scales.
template <int KIND>
__device__ __forceinline__ CacheRef cache_ref(const unsigned char* cache, const float* scales,
                                              int b, int h, long long kv_b, long long kv_h,
                                              long long sc_b, long long sc_r, int hd, int grp,
                                              int s) {
  CacheRef c;
  c.rows = cache + b * kv_b + h * kv_h;
  c.sc = nullptr;
  c.sc_r = sc_r;
  c.grp = grp;
  c.s = s;
  if constexpr (KIND == kInt8) c.sc = scales + b * sc_b + h * sc_r;
  if constexpr (KIND == kInt4) c.sc = scales + b * sc_b + (long long)h * (hd / grp) * sc_r;
  return c;
}

}  // namespace attn
