// Prefill attention: _attn_core's function for every call that is not a
// decode step or a verify round (prefill over the cache, the no-cache
// forward of prober training's capture and of the baselines' traces),
// with bf16 compute, reading K and V in the cache's stored type (bf16,
// f32, int8 with per-slot scales, nibble-packed int4 with group scales).
//
// Not a Pallas kernel: the JAX package leaves this function to XLA
// (probing_rag_tpu/models/gemma.py::_attn_core :755, called by _attention
// :787): f32 scores q.k * (1 / sqrt(hd)), -1e30 where the mask is False, a
// softmax over all S slots, the probabilities rounded to bf16, f32 sums of
// p * v. The mask comes in structured form, (kpos[b, s] <= qpos[b, t]) &
// valid[b, s], never as the dense [B, 1, T, S] bool.
//
// Bound on this card: tensor-core operations at the main shapes (Gemma-2B
// prefill: 8 x 8 heads x 3,712 causal rows x 256, ~2e11 operations a layer
// against ~300 MB of Q, K, V and f32 output). Design (FlashAttention-3's
// warp specialisation, in two sweeps):
//   - a block of 384 threads takes 128 query rows of one (batch row, kv
//     head): two consumer warpgroups of 64 rows (64 / G positions x the G
//     query heads that share K and V) and one producer warpgroup. Q is
//     loaded once by TMA (4-D tensor map over [B, T, H, hd], 128- or 64-byte
//     swizzle) and stays in shared memory.
//   - S = Q K^T on wgmma m64nNk16 with both operands in shared memory, N =
//     the tile's slots (64 at hd 256, 128 below: the score tile, its bf16
//     fragments and the hd-wide output fit the consumers' 224 registers).
//     O += P V on wgmma with A from registers: the f32 score accumulator,
//     after p = bf16(exp(s - m) / l), is packed in place into the A
//     fragments (the accumulator's rows are the fragments' rows), and V is
//     read MN-major from its natural [slot, hd] tile (transposed B).
//   - K and V tiles come by TMA (4-D tensor maps over the cache's [B, KV, S,
//     row] with its batch and kv-head byte strides, so a kv-head slice is
//     taken as it is; slots past S load as zeros) into one ring of full/empty
//     mbarriers that holds K or V tiles in the order the consumers read them
//     (sweep 1's K tiles, then sweep 2's K and V in turn), so sweep 1 keeps
//     every stage in flight. No block-wide barrier in the tile loop.
//   - f32, int8 and int4 caches: TMA lands the raw rows in a raw ring; their
//     scales (rows of S floats, not 16-byte aligned, so not TMA's) come by
//     cp.async into the same stage, on the same barrier. The producer
//     warpgroup's 128 threads widen each raw stage into the bf16 ring
//     exactly as dequant_kv does (f32 rounded to bf16; bf16(q) x
//     bf16(scale) rounded to bf16), so the consumers never widen and every
//     product has the plain version's bf16 operands.
//   - the plain version rounds the normalised probabilities to bf16, which
//     one-pass flash attention cannot, so two sweeps over the same tiles:
//     sweep 1 forms S and keeps an online row max and sum (V is not
//     loaded); sweep 2 forms S again, then P, then P V. The producer starts
//     sweep 2's K and V tiles while the consumers finish sweep 1. The two
//     consumer warpgroups take turns to issue each product (named
//     barriers), so one's softmax runs while the other's products do
//     (FlashAttention-3's ping-pong, one product a turn: pairing a tile's
//     P V with the next tile's scores in one turn, or a second score tile
//     in flight inside a warpgroup, measured slower on the H100).
//   - the scores stay raw (q.k): the scale is folded into the exponent's
//     factor, and a tile that every row of a warp attends in full is not
//     masked (a warp-uniform test of its largest keff).
//   - a K tile is visited only if some slot of it is attendable by some row
//     of the block: a prep pass writes, per tile, the least kpos of its
//     valid slots; every role walks the tiles whose least kpos is at most
//     the block's largest qpos. Nothing is decided on the host. A tile
//     masked for a row adds exp(-1e30 - m) = 0 to it.
//   - a row with no attendable slot (a left pad at prefill) is the mean of
//     bf16(1/S) v over all S slots: the prep pass sums V over all slots once
//     per (batch row, kv head), and such rows get bf16(1/S) times that sum.
//   - the output is stored in f32, or, where the caller asks, rounded to
//     bf16 (the Contriever encoder casts it at once,
//     probing_rag_tpu/models/encoder.py:123): half the store and no pass
//     of its own for the cast.
//   - two regimes, chosen from the shape (pattn::regime). PR 15's: a block
//     a work item (batch row, kv head, query tile of 2 x 64 rows). The
//     persistent regime (PR 22), for a bf16 cache of at most 4 slot tiles
//     at head dim 64-128 (the Contriever encoder's 12 heads of 64 over at
//     most 512 keys): there a block an item would visit 1-4 tiles a sweep
//     and pay the ring's fill and drain every item, and the warps wait on
//     their own chains of product, softmax and barrier rather than on the
//     tensor cores, MUFU or bytes (measured). So:
//       - one block an SM walks the items in a fixed stride, a (batch row,
//         kv head)'s query tiles side by side (K and V read once from
//         device memory, then from L2);
//       - three consumer warpgroups of 64 rows (192 rows an item, 512
//         threads, setmaxnreg 160 / 32: more independent warps to hide
//         those chains), taking no turns;
//       - Q has two buffers, each with the item's facts beside it (its
//         tile count and qpos, written by the producer while the item's Q
//         is in flight), and the ring's steps and phases run on across
//         items: the producer loads the next item's Q and first tiles
//         while the consumers finish the current one;
//       - a warpgroup whose rows all lie past T only waits for and
//         releases its stages (a query batch's T 40: 0.0152 -> 0.0142 ms;
//         the branch costs 3% at the index build's shape, which never
//         takes it: measured, H100, 700 W);
//       - V is summed only for batch rows that hold a row attending
//         nothing (prefill_prep_rows, prefill_vsum_rows).
//     An item's arithmetic is otherwise PR 15's.
// Launches: prep (V partial sums, valid-slot positions and tile minima),
// finish (the sums in a fixed order), attention; one call counts one
// launch. No allocation and no host sync: the wrapper hands in the scratch
// and the plan (ops/attention.py::plan_prefill_attention), which the C
// entry checks against the layout below. Tensor maps are encoded on the
// host per call and passed as __grid_constant__ parameters.

// nvcc-parts: 4
// The build compiles this file once per part, with NVCC_PART = 0 .. 3 and
// NVCC_PARTS = 4 (kernels/__init__.py reads the line above): part p holds
// the kernels of cache kind p; part 0 also holds the C entry.
#ifndef NVCC_PART
#define NVCC_PART 0
#define NVCC_PARTS 1
#endif
#define IN_PART(p) (NVCC_PARTS == 1 || NVCC_PART == (p))

#include <cuda.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

#include "attention_mma.cuh"
#include "hopper.cuh"

namespace pattn {

// ---- the plan, shared by the kernels and the C entry's check. Its
// Python mirror is ops/attention.py::plan_prefill_attention. Host code
// compiles it too (tests/test_torch_prefill_attention.py holds the planner
// to it).
constexpr int kBudget = 232448;  // shared memory a block may use
constexpr int kSlack = 1024;     // the base aligned up to 1024 bytes
constexpr int kRows = 64;        // query rows a consumer warpgroup
constexpr int kConsumers = 2;    // consumer warpgroups of PR 15's regime
constexpr int kStagesMax = 6;    // ring stages at most
constexpr int kRawMax = 4;       // raw stages at most
constexpr int kRawBytes = 16384;  // raw rows a raw stage at most
// the regimes: PR 15's, a block an item; persistent, a block an SM that
// walks items, for a bf16 cache of at most kPersistentTiles slot tiles at a
// head dim in [kPersistentMinHd, kPersistentMaxHd] (the Contriever
// encoder's 12 x 64 over at most 512 keys)
constexpr int kTiles = 0;
constexpr int kPersistent = 1;
constexpr int kPersistentTiles = 4;
constexpr int kPersistentMinHd = 64;
constexpr int kPersistentMaxHd = 128;
constexpr int kPersistentStagesMax = 8;
constexpr int kPersistentConsumers = 3;  // 192 query rows an item (FA3's at head dim 64)

__host__ __device__ constexpr int consumers(int regime) {
  return regime == kPersistent ? kPersistentConsumers : kConsumers;
}
// a block: the consumer warpgroups and one producer warpgroup
__host__ __device__ constexpr int threads(int regime) { return 128 * (consumers(regime) + 1); }

// registers a thread (setmaxnreg) of the consumers and of the producer: a
// block of 384 holds 384 x 168, so 2 x consumer + producer <= 504; one of
// 512 (persistent) 512 x 128, so 3 x consumer + producer <= 512. A producer
// that widens keeps four 8-lane units in flight in 56.
__host__ __device__ constexpr int consumer_regs(int kind, int regime) {
  return regime == kPersistent ? 160 : kind == attn::kBf16 ? 232 : 224;
}
__host__ __device__ constexpr int producer_regs(int kind, int regime) {
  return regime == kPersistent ? 32 : kind == attn::kBf16 ? 40 : 56;
}
static_assert(2 * consumer_regs(0, kTiles) + producer_regs(0, kTiles) <= 504 &&
                  2 * consumer_regs(1, kTiles) + producer_regs(1, kTiles) <= 504 &&
                  3 * consumer_regs(0, kPersistent) + producer_regs(0, kPersistent) <= 512,
              "setmaxnreg moves registers within the block's file");

__host__ __device__ constexpr int row_bytes(int kind, int hd) {
  return kind == attn::kBf16 ? hd * 2 : kind == attn::kF32 ? hd * 4 : kind == attn::kInt8 ? hd
                                                                                          : hd / 2;
}
__host__ __device__ constexpr int tile_slots(int hd) { return hd >= 256 ? 64 : 128; }
__host__ __device__ constexpr int raw_slots(int kind, int hd) {
  return kind == attn::kBf16 ? 0
         : tile_slots(hd) * row_bytes(kind, hd) <= kRawBytes ? tile_slots(hd)
                                                             : kRawBytes / row_bytes(kind, hd);
}
// scales of a raw stage: int8 one a slot, int4 one a slot and 32 lanes
__host__ __device__ constexpr int raw_scales(int kind, int hd) {
  return kind == attn::kInt8 ? raw_slots(kind, hd)
         : kind == attn::kInt4 ? hd / 32 * raw_slots(kind, hd) : 0;
}
// a raw stage: rows, scales, the slots' keff
__host__ __device__ constexpr int raw_stage_bytes(int kind, int hd) {
  return raw_slots(kind, hd) * (row_bytes(kind, hd) + 4) + raw_scales(kind, hd) * 4;
}
// Q buffers: the persistent regime loads the next item's Q into the second
__host__ __device__ constexpr int q_buffers(int regime) { return regime == kPersistent ? 2 : 1; }
// in the persistent regime each Q buffer has the item's facts beside it:
// its tile count and its positions' qpos, ints (the producer's, so the
// consumers wait on no device-memory load between items)
constexpr int kMetaInts = 4 + kPersistentConsumers * kRows;
__host__ __device__ constexpr int meta_bytes(int regime) {
  return regime == kPersistent ? q_buffers(regime) * kMetaInts * 4 : 0;
}
// Q's buffers, r ring stages (a bf16 tile and its keff), rd raw stages, the
// items' facts, the barriers (Q's full, and with two buffers their empty;
// the ring's and the raw ring's full and empty)
__host__ __device__ constexpr int smem_bytes(int kind, int hd, int r, int rd, int regime) {
  return q_buffers(regime) * consumers(regime) * kRows * hd * 2 +
         r * tile_slots(hd) * (hd * 2 + 4) + rd * raw_stage_bytes(kind, hd) + meta_bytes(regime) +
         8 * ((regime == kPersistent ? 2 * q_buffers(regime) : 1) + 2 * (r + rd)) + kSlack;
}
__host__ __device__ constexpr bool fits(int kind, int hd, int r, int rd, int regime) {
  return smem_bytes(kind, hd, r, rd, regime) <= kBudget;
}
// the regime of a call: from the cache's kind, the head dim and the slots
__host__ __device__ constexpr int regime(int kind, int hd, int s) {
  return kind == attn::kBf16 && hd >= kPersistentMinHd && hd <= kPersistentMaxHd &&
                 (s + tile_slots(hd) - 1) / tile_slots(hd) <= kPersistentTiles
             ? kPersistent
             : kTiles;
}
// bf16: the most stages that fit, up to 6 (persistent: up to 8, beside two
// Q buffers); beside a raw ring: 4 where three raw stages still fit, else 3
__host__ __device__ constexpr int ring_stages(int kind, int hd, int regime) {
  if (kind == attn::kBf16) {
    int r = regime == kPersistent ? kPersistentStagesMax : kStagesMax;
    while (r > 2 && !fits(kind, hd, r, 0, regime)) --r;
    return r;
  }
  return fits(kind, hd, 4, 3, kTiles) ? 4 : fits(kind, hd, 3, 3, kTiles) ? 3 : 2;
}
__host__ __device__ constexpr int raw_stages(int kind, int hd) {
  if (kind == attn::kBf16) return 0;
  int rd = kRawMax;
  while (rd > 1 && !fits(kind, hd, ring_stages(kind, hd, kTiles), rd, kTiles)) --rd;
  return rd;
}
// blocks of a launch over `items` work items on `sms` SMs
__host__ __device__ constexpr int grid(int regime, int items, int sms) {
  return regime == kPersistent && sms < items ? sms : items;
}

}  // namespace pattn

namespace pattn {

struct Args {  // the attention reads Q, K and V by TMA (Maps); the prep pass reads v
  const unsigned char* v;   // cache layer; slots of a (b, kv head) contiguous
  const float* k_scale;
  const float* v_scale;
  const int* qpos;          // [B, T]
  const int* kpos;          // [B, S]
  const unsigned char* valid;  // [B, S]
  int* keff;                // [B, ntiles * tile]: kpos of a valid slot, else INT_MAX
  int* tmin;                // [B, ntiles]: a tile's least keff
  float* vpart;             // [nchunks, B * KV, hd]; persistent: need[B] (ints)
  float* vsum;              // [B * KV, hd]
  void* out;                // [B, T, KV * G * hd] f32, or bf16 with out_bf16
  long long kv_b, kv_h;     // byte strides of the cache's batch and kv-head dims
  long long sc_b, sc_r;     // element strides of the scales' batch and row dims
  int kvh, g, t, s, hd, grp;
  int ntiles, nchunks;      // tiles, prep chunks
  int npos, qtiles, bkv;    // positions a consumer, query tiles of consumers x npos, B * KV
  int out_bf16;             // store the output rounded to bf16 (else f32)
  float scale;              // 1 / sqrt(hd), rounded to f32
};

struct Maps {
  CUtensorMap q, k, v;
};

// the three launches for one cache kind; plan: tile, stages, raw_slots,
// raw_stages, smem (checked against the kernel's own layout), then the
// regime and the grid (checked by the entry)
cudaError_t launch_bf16(const Args& a, const Maps& m, const int* plan, cudaStream_t stream);
cudaError_t launch_f32(const Args& a, const Maps& m, const int* plan, cudaStream_t stream);
cudaError_t launch_int8(const Args& a, const Maps& m, const int* plan, cudaStream_t stream);
cudaError_t launch_int4(const Args& a, const Maps& m, const int* plan, cudaStream_t stream);

}  // namespace pattn (launches)

namespace {

using attn::kMasked;
using pattn::Args;

constexpr int kPrepSlots = 256;  // slots a prep block
constexpr int kPrepThreads = 256;

template <int KIND, int HD, bool P = false>
struct L {  // the layout of one instantiation; P: the persistent regime
  static constexpr int kSw = HD >= 64 ? 128 : 64;  // swizzle span: bytes of a tile row's chunk
  static constexpr int kChunks = HD * 2 / kSw;      // chunks of kSw bytes a bf16 row
  static constexpr int kCw = kSw / 16;              // 16-byte pieces a chunk row
  static constexpr int kN = pattn::tile_slots(HD);
  static constexpr int kRowBytes = pattn::row_bytes(KIND, HD);
  static constexpr int kTile = kN * HD * 2;
  static constexpr int kRegime = P ? pattn::kPersistent : pattn::kTiles;
  static constexpr int kC = pattn::consumers(kRegime);  // consumer warpgroups
  static constexpr int kThreads = pattn::threads(kRegime);
  static constexpr int kQB = pattn::q_buffers(kRegime);
  static constexpr int kQBars = kQB > 1 ? 2 * kQB : 1;  // Q's full (and empty) barriers
  static constexpr int kQBytes = kC * pattn::kRows * HD * 2;  // a Q buffer
  static constexpr int kR = pattn::ring_stages(KIND, HD, kRegime);
  static constexpr int kRD = pattn::raw_stages(KIND, HD);
  static constexpr int kRS = pattn::raw_slots(KIND, HD);
  static constexpr int kPP = KIND == attn::kBf16 ? 1 : kN / kRS;  // raw stages a tile
  static constexpr int kScales = pattn::raw_scales(KIND, HD);
  static constexpr int kBytes = pattn::smem_bytes(KIND, HD, kR, kRD, kRegime);
  // byte offsets from the 1024-aligned base
  static constexpr int Q_OFF = 0;  // [buffer][consumer][chunk][64 rows][kSw]
  static constexpr int RING_OFF = kQB * kQBytes;  // [stage][chunk][kN][kSw]
  static constexpr int RAW_OFF = RING_OFF + kR * kTile;             // [stage][kRS][row]
  static constexpr int RSC_OFF = RAW_OFF + kRD * kRS * kRowBytes;   // [stage][kRS][groups] f32
  static constexpr int RKE_OFF = RSC_OFF + kRD * kScales * 4;       // [stage][kRS] int32
  static constexpr int KEFF_OFF = RKE_OFF + kRD * kRS * 4;          // [stage][kN] int32
  static constexpr int META_OFF = KEFF_OFF + kR * kN * 4;  // [buffer][kMetaInts]: n, -, -, -, qpos
  static constexpr int BAR_OFF = META_OFF + pattn::meta_bytes(kRegime);
  static_assert(kN % 8 == 0 && kN <= 256 && HD <= 256, "wgmma widths");
  static_assert(RAW_OFF % 1024 == 0 && (kRS * kRowBytes) % 128 == 0, "TMA destinations");
  static_assert(BAR_OFF % 8 == 0, "barriers");
  static_assert(KIND == attn::kBf16 || (kRD >= 1 && kN % (kRS > 0 ? kRS : 1) == 0), "raw ring");
  static_assert(!P || (KIND == attn::kBf16 && HD >= pattn::kPersistentMinHd &&
                       HD <= pattn::kPersistentMaxHd),
                "the persistent regime takes a bf16 cache at its head dims");
  static_assert(kBytes <= pattn::kBudget, "shared memory");
};

// keff and tmin of the tiles of slot chunk `chunk` of batch row b, a warp a
// tile: each slot's keff, the tile's least
template <int KIND, int HD>
__device__ __forceinline__ void prep_tiles(const Args& a, int b, int chunk) {
  constexpr int kN = L<KIND, HD>::kN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s0 = chunk * kPrepSlots;
  const int tile0 = s0 / kN, tile1 = min((s0 + kPrepSlots) / kN, a.ntiles);
  for (int tile = tile0 + warp; tile < tile1; tile += kPrepThreads / 32) {
    int least = INT_MAX;
    for (int i = lane; i < kN; i += 32) {
      const int slot = tile * kN + i;
      int ke = INT_MAX;
      if (slot < a.s && __ldg(a.valid + (long long)b * a.s + slot))
        ke = __ldg(a.kpos + (long long)b * a.s + slot);
      a.keff[(long long)b * a.ntiles * kN + slot] = ke;
      least = min(least, ke);
    }
    least = __reduce_min_sync(0xffffffffu, least);
    if (lane == 0) a.tmin[(long long)b * a.ntiles + tile] = least;
  }
}

// Prep. Grid (nchunks, B * KV), kPrepThreads threads. Partial sums of V
// (dequantized to bf16, summed in f32) over the chunk's slots; kv head 0's
// blocks also write keff and tmin of the chunk's tiles.
template <int KIND, int HD>
__global__ void __launch_bounds__(kPrepThreads) prefill_prep(Args a) {
  using namespace attn;
  constexpr int kN = L<KIND, HD>::kN;
  constexpr int kC = HD / 8;                  // 8-lane chunks a row
  constexpr int kLanes = kPrepThreads / kC;   // slots summed side by side
  static_assert(kPrepSlots % kN == 0, "whole tiles a prep chunk");
  __shared__ float red[kPrepThreads * 8];
  const int bk = blockIdx.y, b = bk / a.kvh, h = bk - b * a.kvh;
  const int s0 = blockIdx.x * kPrepSlots, s1 = min(s0 + kPrepSlots, a.s);
  const int c = threadIdx.x % kC, lane_s = threadIdx.x / kC;
  const CacheRef cv = cache_ref<KIND>(a.v, a.v_scale, b, h, a.kv_b, a.kv_h, a.sc_b, a.sc_r,
                                      HD, a.grp, a.s);
  constexpr int kRowBytes = HD * elem_bits<KIND>() / 8;
  constexpr int kChunkBytes = 8 * elem_bits<KIND>() / 8;
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
  for (int slot = s0 + lane_s; slot < s1; slot += kLanes) {
    const unsigned char* p = cv.rows + (long long)slot * kRowBytes + c * kChunkBytes;
    float x[8];
    if constexpr (KIND == kBf16) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
      const unsigned int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[2 * e] = __uint_as_float(w[e] << 16);
        x[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
      }
    } else if constexpr (KIND == kF32) {
      const float4 u0 = __ldg(reinterpret_cast<const float4*>(p));
      const float4 u1 = __ldg(reinterpret_cast<const float4*>(p) + 1);
      const float y[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = round_bf16(y[e]);
    } else if constexpr (KIND == kInt8) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      const float s = round_bf16(__ldg(cv.sc + slot));
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const unsigned int w = e < 4 ? u.x : u.y;
        x[e] = round_bf16(static_cast<float>(static_cast<int>(w << (24 - 8 * (e & 3))) >> 24) * s);
      }
    } else {
      const unsigned int u = __ldg(reinterpret_cast<const unsigned int*>(p));
      const float s = round_bf16(__ldg(cv.sc + (long long)((c * 8) / a.grp) * cv.sc_r + slot));
#pragma unroll
      for (int e = 0; e < 8; ++e)
        x[e] = round_bf16(static_cast<float>(static_cast<int>((u >> (4 * e)) & 0xfu) - 8) * s);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] += x[e];
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) red[threadIdx.x * 8 + e] = acc[e];
  __syncthreads();
  if (threadIdx.x < kC) {  // the slot lanes in order
    float sum[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) sum[e] = 0.0f;
    for (int j = 0; j < kLanes; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e) sum[e] += red[(j * kC + threadIdx.x) * 8 + e];
    float* o = a.vpart + ((long long)blockIdx.x * gridDim.y + bk) * HD + threadIdx.x * 8;
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = sum[e];
  }
  if (h == 0) prep_tiles<KIND, HD>(a, b, blockIdx.x);
}

// Finish: vsum[bk, d] = the chunks' partial sums in order.
__global__ void __launch_bounds__(256) prefill_vsum(Args a, int total) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= total) return;
  float sum = 0.0f;
  for (int j = 0; j < a.nchunks; ++j) sum += a.vpart[(long long)j * total + i];
  a.vsum[i] = sum;
}

// The persistent regime's prep and finish (a bf16 cache). Only a row that
// attends nothing reads the V sums, and at the encoder's shapes such rows
// are rare (all-padding docs), so V is summed only for the batch rows that
// hold one. Prep: grid (nchunks, B): keff and tmin of the chunk's tiles;
// chunk 0's block also writes need[b], whether the least qpos of row b lies
// under the least kpos of its valid slots (then some row attends nothing),
// into the V partials' scratch, which this regime does not use otherwise.
template <int KIND, int HD>
__global__ void __launch_bounds__(kPrepThreads) prefill_prep_rows(Args a) {
  const int b = blockIdx.y;
  prep_tiles<KIND, HD>(a, b, blockIdx.x);
  if (blockIdx.x != 0) return;
  __shared__ int least[2][kPrepThreads / 32];  // a warp's: valid kpos, qpos
  int kmin = INT_MAX, qmin = INT_MAX;
  for (int i = threadIdx.x; i < a.s; i += kPrepThreads)
    if (__ldg(a.valid + (long long)b * a.s + i))
      kmin = min(kmin, __ldg(a.kpos + (long long)b * a.s + i));
  for (int i = threadIdx.x; i < a.t; i += kPrepThreads)
    qmin = min(qmin, __ldg(a.qpos + (long long)b * a.t + i));
  kmin = __reduce_min_sync(0xffffffffu, kmin);
  qmin = __reduce_min_sync(0xffffffffu, qmin);
  if ((threadIdx.x & 31) == 0) {
    least[0][threadIdx.x >> 5] = kmin;
    least[1][threadIdx.x >> 5] = qmin;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 0; w < kPrepThreads / 32; ++w) {
      kmin = min(kmin, least[0][w]);
      qmin = min(qmin, least[1][w]);
    }
    reinterpret_cast<int*>(a.vpart)[b] = qmin < kmin;
  }
}

// Finish: vsum[bk, d] = V[b, kv head, s, d] summed over all S slots in slot
// order (f32), where need[b]; else 0 (read by no row).
template <int HD>
__global__ void __launch_bounds__(256) prefill_vsum_rows(Args a, int total) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= total) return;
  const int bk = i / HD, d = i - bk * HD, b = bk / a.kvh, h = bk - b * a.kvh;
  float sum = 0.0f;
  if (reinterpret_cast<const int*>(a.vpart)[b]) {
    const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(a.v + b * a.kv_b + h * a.kv_h);
    for (int slot = 0; slot < a.s; ++slot) sum += __bfloat162float(v[(long long)slot * HD + d]);
  }
  a.vsum[i] = sum;
}

// The tiles a block visits, in order, walked by one warp (all lanes, the
// same answers): those whose least keff is at most the block's largest
// qpos. next() gives ntiles when none is left.
struct TileScan {
  const int* tmin;
  int ntiles, qmax, lane, base;
  unsigned int mask;
  __device__ __forceinline__ void start() {
    base = -32;
    mask = 0;
  }
  __device__ __forceinline__ int next() {
    while (mask == 0) {
      base += 32;
      if (base >= ntiles) return ntiles;
      const int j = base + lane;
      mask = __ballot_sync(0xffffffffu, j < ntiles && __ldg(tmin + j) <= qmax);
    }
    const int bit = __ffs(mask) - 1;
    mask &= mask - 1;
    return base + bit;
  }
  __device__ __forceinline__ int count() {
    int n = 0;
    for (int j0 = 0; j0 < ntiles; j0 += 32)
      n += __popc(__ballot_sync(0xffffffffu, j0 + lane < ntiles && __ldg(tmin + j0 + lane) <= qmax));
    return n;
  }
};

// Ring step g of a block that visits n tiles: sweep 1's K tiles (g < n),
// then sweep 2's K and V of each tile in turn.
struct Step {
  int sw, i, v;  // sweep, the visited tile's ordinal, V (else K)
};
__device__ __forceinline__ Step step_at(int g, int n) {
  if (g < n) return Step{0, g, 0};
  return Step{1, (g - n) >> 1, (g - n) & 1};
}

// 8 lanes of a raw row widened to bf16 as dequant_kv does: f32 rounded;
// int8 bf16(q) x bf16(scale) rounded; int4 (nibble - 8) x bf16(scale)
// rounded. Integers become bf16 pairs exactly by bits, without conversion
// instructions: 0x4300 | u is the bf16 128 + u for u < 128, so an int8
// byte b gives q = bf16(0x4300 | (b & 0x7f)) - bf16(0x4300 | (b & 0x80))
// (128 + low7 less 128, or less 256 for a negative q), and a nibble n
// gives n - 8 = bf16(0x4300 | n) - 136; both differences are exact. One
// bf16x2 multiply by (scale, scale) then rounds each product q x scale
// to bf16 as the plain version's bf16 product does (the exact product of
// two bf16 values fits an f32).
__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t x, uint32_t s2) {
  uint32_t y;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(y) : "r"(x), "r"(s2));
  return y;
}
__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t x, uint32_t c) {
  uint32_t y;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(y) : "r"(x), "r"(c));
  return y;
}

// the raw bytes of 8 lanes: f32 32, int8 8, int4 4
template <int KIND>
struct Raw8 {
  uint32_t w[KIND == attn::kF32 ? 8 : KIND == attn::kInt8 ? 2 : 1];
};
template <int KIND>
__device__ __forceinline__ Raw8<KIND> load_raw8(const unsigned char* raw) {
  Raw8<KIND> r;
  if constexpr (KIND == attn::kF32) {
    const uint4 a = *reinterpret_cast<const uint4*>(raw), b = *reinterpret_cast<const uint4*>(raw + 16);
    r = {{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
  } else if constexpr (KIND == attn::kInt8) {
    const uint2 a = *reinterpret_cast<const uint2*>(raw);
    r = {{a.x, a.y}};
  } else {
    r = {{*reinterpret_cast<const uint32_t*>(raw)}};
  }
  return r;
}

template <int KIND>
__device__ __forceinline__ uint4 widen8(const Raw8<KIND>& raw, float scale) {
  using attn::pack_bf16;
  if constexpr (KIND == attn::kF32) {
    float x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = __uint_as_float(raw.w[e]);
    return make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]), pack_bf16(x[4], x[5]),
                      pack_bf16(x[6], x[7]));
  } else if constexpr (KIND == attn::kInt8) {
    const uint2 u = make_uint2(raw.w[0], raw.w[1]);
    const uint32_t s2 = pack_bf16(scale, scale);
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // bytes 2e, 2e + 1 -> the low and high halves
      const int lo = 2 * (e & 1);
      const uint32_t t = __byte_perm(e < 2 ? u.x : u.y, 0u, 0x4040 | ((lo + 1) << 8) | lo);
      o[e] = bf16x2_mul(
          bf16x2_sub((t & 0x007f007fu) | 0x43004300u, (t & 0x00800080u) | 0x43004300u), s2);
    }
    return make_uint4(o[0], o[1], o[2], o[3]);
  } else {  // byte e holds lanes 2e (low nibble) and 2e + 1, biased by 8
    const uint32_t u = raw.w[0], u4 = u >> 4;
    const uint32_t s2 = pack_bf16(scale, scale);
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)  // byte e's nibbles -> the low and high halves
      o[e] = bf16x2_mul(
          bf16x2_sub((__byte_perm(u, u4, e | ((4 + e) << 8)) & 0x000f000fu) | 0x43004300u,
                     0x43084308u),
          s2);
    return make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// 2^x (MUFU.EX2, relative error ~2^-22; flushes results under 2^-126 to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
constexpr float kLog2e = 1.4426950408889634f;

// keeps the compiler from moving reads of a wgmma sum above its wait
__device__ __forceinline__ void fence_acc(float& v) { asm volatile("" : "+f"(v)::"memory"); }

// S = Q K^T for a consumer's 64 rows and a tile's N slots, issued (one
// commit group): the chunks of kSw bytes of the depth, 16 deep a product.
template <int KIND, int HD>
__device__ __forceinline__ void issue_scores(float (&s)[L<KIND, HD>::kN / 2], uint32_t q_tile,
                                             uint32_t k_tile) {
  using T = L<KIND, HD>;
  hop::wgmma_fence();
#pragma unroll
  for (int ch = 0; ch < T::kChunks; ++ch)
#pragma unroll
    for (int kk = 0; kk < T::kSw / 32; ++kk)
      hop::wgmma_bf16_ss(hop::Int<T::kN>{}, s,
                         hop::desc_sw<T::kSw>(q_tile + ch * pattn::kRows * T::kSw + kk * 32),
                         hop::desc_sw<T::kSw>(k_tile + ch * T::kN * T::kSw + kk * 32),
                         ch > 0 || kk > 0);
  hop::wgmma_commit();
}

// Once its group has completed: slot col of row r keeps its raw score
// where keff[col] <= qpos[r], else -1e30. A tile whose every slot this
// warp's rows attend (its largest keff at most their least qpos, the usual
// case away from the diagonal and the pads) is left as it is.
template <int N>
__device__ __forceinline__ void mask_scores(float (&s)[N / 2], const int* kf, int t4, int lane,
                                            int qp0, int qp1, int wqmin) {
#pragma unroll
  for (int e = 0; e < N / 2; ++e) fence_acc(s[e]);
  int kmax = INT_MIN;
#pragma unroll
  for (int i = 0; i < N / 32; ++i) kmax = max(kmax, kf[32 * i + lane]);
  if (__reduce_max_sync(0xffffffffu, kmax) <= wqmin) return;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int2 ke = *reinterpret_cast<const int2*>(kf + 8 * j + 2 * t4);
    if (ke.x > qp0) s[4 * j] = kMasked;
    if (ke.y > qp0) s[4 * j + 1] = kMasked;
    if (ke.x > qp1) s[4 * j + 2] = kMasked;
    if (ke.y > qp1) s[4 * j + 3] = kMasked;
  }
}

// The online max and sum of rows r0 and r1 (this lane's columns; the max
// shared by the row's four lanes) after one more masked raw score tile: m
// the raw max, l the sum of 2^(x c2 - m c2), c2 = scale x log2(e).
template <int N>
__device__ __forceinline__ void online_stats(const float (&s)[N / 2], float c2, float& m0,
                                             float& m1, float& l0, float& l1) {
  float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    x0 = fmaxf(x0, fmaxf(s[4 * j], s[4 * j + 1]));
    x1 = fmaxf(x1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, off));
    x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, off));
  }
  const float n0 = fmaxf(m0, x0), n1 = fmaxf(m1, x1);
  const float nc0 = n0 * c2, nc1 = n1 * c2;
  float e0 = 0.0f, e1 = 0.0f;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    e0 += ex2(fmaf(s[4 * j], c2, -nc0)) + ex2(fmaf(s[4 * j + 1], c2, -nc0));
    e1 += ex2(fmaf(s[4 * j + 2], c2, -nc1)) + ex2(fmaf(s[4 * j + 3], c2, -nc1));
  }
  l0 = l0 * ex2((m0 - n0) * c2) + e0;
  l1 = l1 * ex2((m1 - n1) * c2) + e1;
  m0 = n0;
  m1 = n1;
}

// One work item: a query tile of 2 npos positions of one (batch row, kv
// head), the tiles it visits and how many (the same answers in every warp).
struct Item {
  int bk, b, h, t0;
  int n;  // K tiles visited, each sweep
  TileScan scan;
};

// The attention. Work items (batch row, kv head, query tile). PR 15's
// regime (P false) launches a block an item, the query tiles with the most
// positions first; the persistent regime (P true) launches min(SMs, items)
// blocks that walk the items blockIdx.x, + gridDim.x, ..., a (batch row, kv
// head)'s query tiles side by side, so that blocks in flight share its K
// and V in L2. T::kThreads threads: the consumer warpgroups (two of 64
// query rows taking turns, three in the persistent regime, without turns),
// then the producer warpgroup. The ring's steps run on across items, and
// with two Q buffers the producer loads the next item's Q and first tiles
// while the consumers finish the current one.
template <int KIND, int HD, bool P>
__global__ void __launch_bounds__(L<KIND, HD, P>::kThreads, 1)
prefill_attn(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap, Args a) {
  using T = L<KIND, HD, P>;
  constexpr int kN = T::kN, kSw = T::kSw, kR = T::kR, kQB = T::kQB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = hop::smem_u32(smem);
  const uint32_t qfull = base + T::BAR_OFF, qempty = qfull + 8 * kQB;  // qempty: kQB > 1
  const uint32_t full = qfull + 8 * T::kQBars, empty = full + 8 * kR;
  const uint32_t rfull = empty + 8 * kR, rempty = rfull + 8 * T::kRD;
  const int* keff_st = reinterpret_cast<const int*>(smem + T::KEFF_OFF);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int items = a.qtiles * a.bkv;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kQB; ++i) {
      // the TMA's arrival; with two buffers also the producer's once it has
      // written the item's facts
      hop::mbar_init(qfull + 8 * i, kQB > 1 ? 2 : 1);
      if (kQB > 1) hop::mbar_init(qempty + 8 * i, 4 * T::kC);  // the consumers' warps
    }
    // bf16: the TMA's arrival; else the producer's 128 threads after widening
    const uint32_t fill = KIND == attn::kBf16 ? 1 : 128;
    for (int i = 0; i < kR; ++i) {
      hop::mbar_init(full + 8 * i, fill);
      hop::mbar_init(empty + 8 * i, 4 * T::kC);  // the consumers' warps
    }
    for (int i = 0; i < T::kRD; ++i) {
      hop::mbar_init(rfull + 8 * i, T::kScales > 0 ? 129 : 1);  // TMA + each thread's cp.async
      hop::mbar_init(rempty + 8 * i, 4);                        // the producer's 4 warps
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  // item it's coordinates
  auto coords = [&](int it) {
    Item I;
    int qt;
    if constexpr (P) {
      I.bk = it / a.qtiles;
      qt = it - I.bk * a.qtiles;
    } else {
      qt = a.qtiles - 1 - it / a.bkv;
      I.bk = it % a.bkv;
    }
    I.b = I.bk / a.kvh;
    I.h = I.bk - I.b * a.kvh;
    I.t0 = qt * T::kC * a.npos;
    return I;
  };
  // its positions and the tiles it visits, worked out by every lane of a
  // warp; with kQB > 1 written beside Q buffer qb for the consumers
  auto item_at = [&](int it, int* meta) {
    Item I = coords(it);
    const int np = min(T::kC * a.npos, a.t - I.t0);  // positions of the item
    const int* qp_row = a.qpos + (long long)I.b * a.t + I.t0;
    int qmax = INT_MIN;
    for (int i = lane; i < np; i += 32) {
      const int qp = __ldg(qp_row + i);
      if (meta) meta[4 + i] = qp;
      qmax = max(qmax, qp);
    }
    qmax = __reduce_max_sync(0xffffffffu, qmax);
    I.scan = TileScan{a.tmin + (long long)I.b * a.ntiles, a.ntiles, qmax, lane, -32, 0u};
    I.n = I.scan.count();
    if (meta && lane == 0) meta[0] = I.n;
    return I;
  };
  int* const meta_base = reinterpret_cast<int*>(smem + T::META_OFF);
  auto keff_row = [&](const Item& I) { return a.keff + (long long)I.b * a.ntiles * kN; };

  if (warp >= 4 * T::kC) {  // ---- producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;"
                 ::"n"(pattn::producer_regs(KIND, T::kRegime)));
    const int ptid = threadIdx.x - 128 * T::kC;
    // Q of the block's u-th item into buffer u % kQB, by one thread: each
    // consumer's 64 / G positions x G heads, zeros past T
    auto load_q = [&](const Item& I, int u) {
      const int qb = u % kQB;
      hop::mbar_expect_tx(qfull + 8 * qb, T::kC * T::kChunks * kSw * a.g * a.npos);
      for (int c = 0; c < T::kC; ++c)
        for (int ch = 0; ch < T::kChunks; ++ch)
          hop::tma_load_4d(base + T::Q_OFF + qb * T::kQBytes +
                               (c * T::kChunks + ch) * pattn::kRows * kSw,
                           &qmap, qfull + 8 * qb, ch * (kSw / 2), I.h * a.g, I.t0 + c * a.npos,
                           I.b);
    };
    if constexpr (KIND == attn::kBf16) {  // one warp: its first lane issues the loads
      if (ptid < 32) {
        int g = 0, u = 0;
        for (int it = blockIdx.x; it < items; it += gridDim.x, ++u) {
          int* meta = nullptr;
          if (kQB > 1) {  // the buffer's previous item is done: Q in flight while
            // the item's facts are worked out and written, then their arrival
            hop::mbar_wait(qempty + 8 * (u % kQB), ((u / kQB) & 1) ^ 1);
            meta = meta_base + (u % kQB) * pattn::kMetaInts;
            if (lane == 0) load_q(coords(it), u);
          }
          Item I = item_at(it, meta);
          const int* kr = keff_row(I);
          __syncwarp();  // the facts written before the arrival that publishes them
          if (lane == 0) {
            if (kQB > 1)
              hop::mbar_arrive(qfull + 8 * (u % kQB));
            else
              load_q(I, u);
          }
          // ring step g: tile j of K (with its keff) or V
          auto load = [&](const CUtensorMap* map, int g, int j, bool with_keff) {
            const int st = g % kR;
            hop::mbar_wait(empty + 8 * st, ((g / kR) & 1) ^ 1);
            if (lane == 0) {
              hop::mbar_expect_tx(full + 8 * st, T::kTile + (with_keff ? kN * 4 : 0));
              for (int ch = 0; ch < T::kChunks; ++ch)
                hop::tma_load_4d(base + T::RING_OFF + st * T::kTile + ch * kN * kSw, map,
                                 full + 8 * st, ch * (kSw / 2), j * kN, I.h, I.b);
              if (with_keff)
                hop::bulk_load(base + T::KEFF_OFF + st * kN * 4, kr + j * kN, kN * 4,
                               full + 8 * st);
            }
          };
          for (int sw = 0; sw < 2; ++sw) {
            I.scan.start();
            for (int j = I.scan.next(); j < a.ntiles; j = I.scan.next()) {
              load(&kmap, g++, j, true);
              if (sw) load(&vmap, g++, j, false);
            }
          }
        }
      }
    } else {  // all 128 threads, one item: raw stages in by TMA and cp.async, widened to bf16
      Item I = item_at(blockIdx.x, nullptr);
      const int n = I.n, b = I.b, h = I.h;
      const int* kr = keff_row(I);
      if (ptid == 0) load_q(I, 0);
      constexpr int kRD = T::kRD, kRS = T::kRS, kPP = T::kPP;
      const int total = 3 * n * kPP;
      const float* ksc = nullptr;  // the (b, kv head)'s first scale row
      const float* vsc = nullptr;
      if constexpr (KIND == attn::kInt8) {
        ksc = a.k_scale + b * a.sc_b + h * a.sc_r;
        vsc = a.v_scale + b * a.sc_b + h * a.sc_r;
      } else if constexpr (KIND == attn::kInt4) {
        ksc = a.k_scale + b * a.sc_b + (long long)h * (HD / 32) * a.sc_r;
        vsc = a.v_scale + b * a.sc_b + (long long)h * (HD / 32) * a.sc_r;
      }
      int iss_sw = -1, iss_i = -1, iss_j = 0;
      auto issue = [&](int p) {  // raw stage p into slot p % kRD
        const Step id = step_at(p / kPP, n);
        const int sub = p % kPP;
        if (id.sw != iss_sw) {
          I.scan.start();
          iss_sw = id.sw;
          iss_i = -1;
        }
        if (id.i != iss_i) {
          iss_j = I.scan.next();
          iss_i = id.i;
        }
        const int slot = p % kRD, s0 = iss_j * kN + sub * kRS;
        const uint32_t full = rfull + 8 * slot;
        hop::mbar_wait(rempty + 8 * slot, ((p / kRD) & 1) ^ 1);
        if (ptid == 0) {
          hop::mbar_expect_tx(full, kRS * T::kRowBytes + (id.v ? 0 : kRS * 4));
          hop::tma_load_4d(base + T::RAW_OFF + slot * kRS * T::kRowBytes, id.v ? &vmap : &kmap,
                           full, 0, s0, h, b);
          if (!id.v)
            hop::bulk_load(base + T::RKE_OFF + slot * kRS * 4, kr + s0, kRS * 4, full);
        }
        if constexpr (T::kScales > 0) {  // [slot][group] in shared memory
          constexpr int kG = T::kScales / kRS;
          const float* sc = id.v ? vsc : ksc;
          for (int e = ptid; e < T::kScales; e += 128) {
            const int gr = e / kRS, r = e - gr * kRS, at = s0 + r;
            attn::cp_async4(base + T::RSC_OFF + (slot * T::kScales + r * kG + gr) * 4,
                            sc + gr * a.sc_r + min(at, a.s - 1), at < a.s ? 4 : 0);
          }
          hop::cp_async_mbar_arrive(full);
        }
      };
      auto widen = [&](int p) {  // raw stage p into its ring step's bf16 tile
        const int g = p / kPP, sub = p % kPP, st = g % kR;
        const bool v = step_at(g, n).v;
        if (sub == 0) hop::mbar_wait(empty + 8 * st, ((g / kR) & 1) ^ 1);
        const int slot = p % kRD;
        hop::mbar_wait(rfull + 8 * slot, (p / kRD) & 1);
        uint8_t* tile = smem + T::RING_OFF + st * T::kTile;
        const uint8_t* raw = smem + T::RAW_OFF + slot * kRS * T::kRowBytes;
        const float* scl = reinterpret_cast<const float*>(smem + T::RSC_OFF) + slot * T::kScales;
        // units of 8 lanes: a row holds kU, a thread takes kPer, a batch of
        // kB loaded before any is widened and stored (the compiler cannot
        // move a load above a store to shared memory it cannot tell apart)
        constexpr int kU = HD / 8, kPer = kRS * kU / 128;
        constexpr int kB = KIND == attn::kF32 ? 2 : 4;  // 8 measured 2% slower, 16 spilled
        static_assert(kRS * kU % 128 == 0 && kPer % kB == 0, "whole batches a thread");
#pragma unroll 1
        for (int i0 = 0; i0 < kPer; i0 += kB) {
          Raw8<KIND> x[kB];
          float sc[kB];
#pragma unroll
          for (int k = 0; k < kB; ++k) {
            const int u = ptid + 128 * (i0 + k), r = u / kU, c = u - r * kU;
            x[k] = load_raw8<KIND>(raw + r * T::kRowBytes + c * (T::kRowBytes / kU));
            sc[k] = KIND == attn::kInt8 ? scl[r] : KIND == attn::kInt4 ? scl[r * (HD / 32) + c / 4]
                                                                       : 0.0f;
          }
#pragma unroll
          for (int k = 0; k < kB; ++k) {
            const int u = ptid + 128 * (i0 + k), r = u / kU, c = u - r * kU;
            *reinterpret_cast<uint4*>(tile + (c / T::kCw) * kN * kSw +
                                      hop::swz_row<kSw>(sub * kRS + r, c % T::kCw)) =
                widen8<KIND>(x[k], sc[k]);
          }
        }
        if (!v) {
          int* kf = reinterpret_cast<int*>(smem + T::KEFF_OFF) + st * kN + sub * kRS;
          const int* rk = reinterpret_cast<const int*>(smem + T::RKE_OFF) + slot * kRS;
          for (int r = ptid; r < kRS; r += 128) kf[r] = rk[r];
        }
        hop::fence_proxy_async();  // the tile's generic writes, visible to wgmma
        __syncwarp();
        if (lane == 0) hop::mbar_arrive(rempty + 8 * slot);
        if (sub == kPP - 1) hop::mbar_arrive(full + 8 * st);
      };
      for (int p = 0; p < kRD - 1 && p < total; ++p) issue(p);
      for (int p = 0; p < total; ++p) {
        if (p + kRD - 1 < total) issue(p + kRD - 1);
        widen(p);
      }
    }
  } else {  // ---- consumer warpgroups: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;"
                 ::"n"(pattn::consumer_regs(KIND, T::kRegime)));
    const int c = warp >> 2, wq = warp & 3, ctid = threadIdx.x & 127, t4 = lane & 3;
    const int nrows = a.g * a.npos;  // rows of this consumer's tile (64 when G divides 64)
    const int r0 = 16 * wq + (lane >> 2), r1 = r0 + 8;
    auto q_tile_at = [&](int qb) {
      return base + T::Q_OFF + qb * T::kQBytes + c * T::kChunks * pattn::kRows * kSw;
    };
    if (nrows < pattn::kRows) {  // rows past the tile's: zeros (the TMA box writes nrows)
      for (int qb = 0; qb < kQB; ++qb)
        for (int e = ctid; e < (pattn::kRows - nrows) * (HD / 8); e += 128) {
          const int r = nrows + e / (HD / 8), cc = e % (HD / 8);
          *reinterpret_cast<uint4*>(smem + (q_tile_at(qb) - base) +
                                    (cc / T::kCw) * pattn::kRows * kSw +
                                    hop::swz_row<kSw>(r, cc % T::kCw)) = make_uint4(0, 0, 0, 0);
        }
      hop::fence_proxy_async();
      hop::bar_sync(1 + c, 128);
    }
    auto release = [&](uint32_t empty) {  // this warp has read the stage
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(empty);
    };
    // scores are kept raw (q.k); the scale goes into c2 = scale x log2(e),
    // and the row max of the raw scores times scale is the max of the
    // scaled ones (a positive factor, rounding monotone)
    const float c2 = a.scale * kLog2e;
    // turns: a warpgroup issues each of its products between turn_begin and
    // turn_end, the two warpgroups in alternation (named barriers 3 and 4),
    // so one's softmax runs while the other's products do
    // (the persistent regime's three warpgroups take no turns)
    auto turn_begin = [&]() {
      if constexpr (!P) hop::bar_sync(3 + c, 256);
    };
    auto turn_end = [&]() {
      if constexpr (!P) hop::bar_arrive(4 - c, 256);
    };
    if (!P && c == 1) hop::bar_arrive(3, 256);  // warpgroup 0 goes first
    auto wait_full = [&](int g) { hop::mbar_wait(full + 8 * (g % kR), (g / kR) & 1); };
    auto tile_at = [&](int g) { return base + T::RING_OFF + (g % kR) * T::kTile; };

    int g0 = 0, u = 0;  // the item's first ring step, its ordinal in the block
    for (int it = blockIdx.x; it < items; it += gridDim.x, ++u) {
      const int qb = u % kQB;
      const uint32_t q_tile = q_tile_at(qb);
      // the item: from the producer's facts beside Q (two buffers), else
      // worked out here
      Item I;
      if constexpr (kQB > 1) {
        I = coords(it);
        hop::mbar_wait(qfull + 8 * qb, (u / kQB) & 1);
        I.n = meta_base[qb * pattn::kMetaInts];
      } else {
        I = item_at(it, nullptr);
      }
      const int n = I.n, tc = I.t0 + c * a.npos;
      if (P && tc >= a.t) {  // the item ends before this warpgroup's rows: its
        // stages are only waited for and released (the last item of a row
        // at T past 2 x 64 positions, every item at a query batch's T 40)
        for (int g = g0; g < g0 + 3 * n; ++g) {
          wait_full(g);
          release(empty + 8 * (g % kR));
        }
        release(qempty + 8 * qb);
        g0 += 3 * n;
        continue;
      }
      const bool ok0 = r0 < nrows && tc + r0 / a.g < a.t;
      const bool ok1 = r1 < nrows && tc + r1 / a.g < a.t;
      auto qpos_of = [&](int r) {
        if constexpr (kQB > 1) return meta_base[qb * pattn::kMetaInts + 4 + c * a.npos + r / a.g];
        return __ldg(a.qpos + (long long)I.b * a.t + tc + r / a.g);
      };
      const int qp0 = ok0 ? qpos_of(r0) : INT_MIN;
      const int qp1 = ok1 ? qpos_of(r1) : INT_MIN;
      // the least qpos of this warp's rows (a row past the tile's masks
      // nothing: its output is not stored)
      int wqmin = min(ok0 ? qp0 : INT_MAX, ok1 ? qp1 : INT_MAX);
      wqmin = __reduce_min_sync(0xffffffffu, wqmin);
      if constexpr (kQB == 1) hop::mbar_wait(qfull + 8 * qb, (u / kQB) & 1);
      // ring step g's raw scores into s, masked; the stage released
      auto scores = [&](float (&s)[kN / 2], int g) {
        wait_full(g);
        turn_begin();
        issue_scores<KIND, HD>(s, q_tile, tile_at(g));
        turn_end();
        hop::wgmma_wait<0>();
        mask_scores<kN>(s, keff_st + (g % kR) * kN, t4, lane, qp0, qp1, wqmin);
        release(empty + 8 * (g % kR));
      };

      // sweep 1: the online max and sum of each row
      float sc[kN / 2];
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
      for (int i = 0; i < n; ++i) {
        scores(sc, g0 + i);
        online_stats<kN>(sc, c2, m0, m1, l0, l1);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      // sweep 2's p = 2^(x c2 - m c2) x (1 / l), x the raw score: within
      // ~1e-6 of itself of exp(x scale - m scale) / l, inside
      // rounding_tolerance's 1e-5
      const float mc0 = m0 * c2, mc1 = m1 * c2, rl0 = 1.0f / l0, rl1 = 1.0f / l1;

      // sweep 2: p = bf16(exp(s - m) / l), O += P V; tile i's K at ring step
      // g0 + n + 2 i, its V at g0 + n + 2 i + 1
      float o[HD / 2];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
      for (int i = 0; i < n; ++i) {
        const int gv = g0 + n + 2 * i + 1;
        scores(sc, gv - 1);
        // the A fragments of P, slots [16 ks, 16 ks + 16): pa[ks][e] holds the
        // pair of accumulator entries 8 ks + 2 e, + 1 (row r0 for even e, r1 odd)
        uint32_t pa[kN / 16][4];
#pragma unroll
        for (int ks = 0; ks < kN / 16; ++ks)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float mc = e & 1 ? mc1 : mc0, rl = e & 1 ? rl1 : rl0;
            pa[ks][e] = attn::pack_bf16(ex2(fmaf(sc[8 * ks + 2 * e], c2, -mc)) * rl,
                                        ex2(fmaf(sc[8 * ks + 2 * e + 1], c2, -mc)) * rl);
          }
        wait_full(gv);
        turn_begin();
        hop::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kN / 16; ++ks)  // V MN-major: 16 slot rows a k-step
          hop::wgmma_bf16_rs_tb(hop::Int<HD>{}, o, pa[ks],
                                hop::desc_sw<kSw>(tile_at(gv) + ks * 16 * kSw, kN * kSw), 1);
        hop::wgmma_commit();
        turn_end();
        hop::wgmma_wait<0>();
        release(empty + 8 * (gv % kR));
      }
      if (kQB > 1) release(qempty + 8 * qb);  // the item's Q is read
      g0 += 3 * n;
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) fence_acc(o[i]);

      // rows with no attendable slot: bf16(1/S) times V summed over all slots
      const float w = attn::round_bf16(1.0f / static_cast<float>(a.s));
      const float* vs = a.vsum + (long long)I.bk * HD;
      const int heads = a.kvh * a.g;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = half ? r1 : r0;
        if (!(half ? ok1 : ok0)) continue;
        const bool dead = (half ? m1 : m0) <= kMasked;
        const long long at =
            (((long long)I.b * a.t + tc + r / a.g) * heads + I.h * a.g + r % a.g) * HD;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          const int col = 8 * j + 2 * t4;
          float2 y = make_float2(o[4 * j + 2 * half], o[4 * j + 2 * half + 1]);
          if (dead) y = make_float2(w * vs[col], w * vs[col + 1]);
          if (a.out_bf16)  // the caller's cast of the f32 output, done here
            *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(a.out) + at + col) =
                attn::pack_bf16(y.x, y.y);
          else
            *reinterpret_cast<float2*>(static_cast<float*>(a.out) + at + col) = y;
        }
      }
    }
    if (!P && c == 0) hop::bar_sync(3, 256);  // warpgroup 1's last arrival
  }
}

template <int KIND, int HD, bool P>
cudaError_t launch(const Args& a, const pattn::Maps& m, const int* plan, cudaStream_t stream) {
  using T = L<KIND, HD, P>;
  if (plan[0] != T::kN || plan[1] != T::kR || plan[2] != T::kRS || plan[3] != T::kRD ||
      plan[4] != T::kBytes || plan[5] != T::kRegime)
    return cudaErrorInvalidValue;  // the Python plan disagrees with this layout
  const int total = a.bkv * HD;
  if constexpr (P) {
    prefill_prep_rows<KIND, HD><<<dim3(a.nchunks, a.bkv / a.kvh), kPrepThreads, 0, stream>>>(a);
  } else {
    prefill_prep<KIND, HD><<<dim3(a.nchunks, a.bkv), kPrepThreads, 0, stream>>>(a);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (P) {
    prefill_vsum_rows<HD><<<(total + 255) / 256, 256, 0, stream>>>(a, total);
  } else {
    prefill_vsum<<<(total + 255) / 256, 256, 0, stream>>>(a, total);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = cudaFuncSetAttribute(prefill_attn<KIND, HD, P>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, T::kBytes)) !=
      cudaSuccess)
    return err;
  prefill_attn<KIND, HD, P><<<plan[6], T::kThreads, T::kBytes, stream>>>(m.q, m.k, m.v, a);
  return cudaGetLastError();
}

// the regime's instantiation: persistent only for a bf16 cache at its head dims
template <int KIND, int HD>
cudaError_t launch_regime(const Args& a, const pattn::Maps& m, const int* plan,
                          cudaStream_t stream) {
  if constexpr (KIND == attn::kBf16 && HD >= pattn::kPersistentMinHd &&
                HD <= pattn::kPersistentMaxHd)
    if (plan[5] == pattn::kPersistent) return launch<KIND, HD, true>(a, m, plan, stream);
  return launch<KIND, HD, false>(a, m, plan, stream);
}

template <int KIND>
cudaError_t dispatch(const Args& a, const pattn::Maps& m, const int* plan, cudaStream_t stream) {
  switch (a.hd) {
    case 32: return launch_regime<KIND, 32>(a, m, plan, stream);
    case 64: return launch_regime<KIND, 64>(a, m, plan, stream);
    case 128: return launch_regime<KIND, 128>(a, m, plan, stream);
    case 256: return launch_regime<KIND, 256>(a, m, plan, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

namespace pattn {

#if IN_PART(0)
cudaError_t launch_bf16(const Args& a, const Maps& m, const int* plan, cudaStream_t stream) {
  return dispatch<attn::kBf16>(a, m, plan, stream);
}
#endif
#if IN_PART(1)
cudaError_t launch_f32(const Args& a, const Maps& m, const int* plan, cudaStream_t stream) {
  return dispatch<attn::kF32>(a, m, plan, stream);
}
#endif
#if IN_PART(2)
cudaError_t launch_int8(const Args& a, const Maps& m, const int* plan, cudaStream_t stream) {
  return dispatch<attn::kInt8>(a, m, plan, stream);
}
#endif
#if IN_PART(3)
cudaError_t launch_int4(const Args& a, const Maps& m, const int* plan, cudaStream_t stream) {
  return dispatch<attn::kInt4>(a, m, plan, stream);
}
#endif

}  // namespace pattn

#if IN_PART(0)
namespace {

// The cache layer [B, KV, S, row] for TMA: bf16 in swizzled boxes of
// [kSw / 2 lanes, tile slots]; any other kind raw, boxes of [row, raw slots]
bool cache_map(CUtensorMap* map, const void* ptr, int kind, int b, int kvh, int s, int hd,
               long long kv_b, long long kv_h, int sw, int tile, int raw) {
  const int rb = pattn::row_bytes(kind, hd);
  const bool f32 = kind == attn::kF32, bf16 = kind == attn::kBf16;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(bf16 || f32 ? hd : rb),
                              static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(kvh),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(rb), static_cast<cuuint64_t>(kv_h),
                                 static_cast<cuuint64_t>(kv_b)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(bf16 ? sw / 2 : f32 ? hd : rb),
                             static_cast<cuuint32_t>(bf16 ? tile : raw), 1, 1};
  const CUtensorMapDataType type = bf16  ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                   : f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                         : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const CUtensorMapSwizzle swz = !bf16       ? CU_TENSOR_MAP_SWIZZLE_NONE
                                 : sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                             : CU_TENSOR_MAP_SWIZZLE_64B;
  return hop::tensor_map_nd(map, type, 4, ptr, dims, strides, box, swz);
}

}  // namespace

// q: [B, T, KV*G, hd] bf16. k, v: one layer's K and V over S slots (kind 0
// bf16, 1 f32, 2 int8 with k_scale / v_scale a row of S floats per (b, kv
// head), 3 nibble-packed int4 with a row per (b, kv head, group of grp = 32
// lanes)); kv_b / kv_h byte strides (multiples of 16), slot rows
// contiguous; sc_b / sc_r scale strides in floats. qpos [B, T], kpos [B,
// S] int32, valid [B, S] bool, all contiguous. Scratch: keff int32 [B,
// ntiles * tile], tmin int32 [B, ntiles], vpart f32 [nchunks, B*KV, hd],
// vsum f32 [B*KV, hd], with ntiles = ceil(S / tile), nchunks = ceil(S /
// 256). out: [B, T, KV*G*hd] f32, or bf16 with out_bf16 1 (rounded to
// nearest even). tile .. grid: the plan
// (ops/attention.py::plan_prefill_attention), checked against the kernel's
// layout, pattn::regime and pattn::grid on the current device's SM count.
extern "C" int prefill_attention(const void* q, const void* k, const void* v,
                                 const void* k_scale, const void* v_scale, const void* qpos,
                                 const void* kpos, const void* valid, void* keff, void* tmin,
                                 void* vpart, void* vsum, void* out, int kind, int b, int kvh,
                                 int g, int t, int s, int hd, int grp, long long kv_b,
                                 long long kv_h, long long sc_b, long long sc_r, int tile,
                                 int stages, int raw_slots, int raw_stages, int smem, int regime,
                                 int grid, int out_bf16, float scale, void* stream) {
  if (g < 1 || g > pattn::kRows || t < 1 || s < 1 || b < 1 || kvh < 1 || tile < 8 ||
      (kind == attn::kInt4 && grp != 32) || kv_b % 16 || kv_h % 16 || out_bf16 < 0 ||
      out_bf16 > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  pattn::Args a;
  a.v = static_cast<const unsigned char*>(v);
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.qpos = static_cast<const int*>(qpos);
  a.kpos = static_cast<const int*>(kpos);
  a.valid = static_cast<const unsigned char*>(valid);
  a.keff = static_cast<int*>(keff);
  a.tmin = static_cast<int*>(tmin);
  a.vpart = static_cast<float*>(vpart);
  a.vsum = static_cast<float*>(vsum);
  a.out = out;
  a.out_bf16 = out_bf16;
  a.kv_b = kv_b;
  a.kv_h = kv_h;
  a.sc_b = sc_b;
  a.sc_r = sc_r;
  a.kvh = kvh;
  a.g = g;
  a.t = t;
  a.s = s;
  a.hd = hd;
  a.grp = grp;
  a.ntiles = (s + tile - 1) / tile;
  a.nchunks = (s + kPrepSlots - 1) / kPrepSlots;
  a.npos = pattn::kRows / g;
  const int kc = pattn::consumers(regime);  // checked against pattn::regime below
  a.qtiles = (t + kc * a.npos - 1) / (kc * a.npos);
  a.bkv = b * kvh;
  a.scale = scale;
  if (static_cast<long long>(a.qtiles) * a.bkv > INT_MAX || a.bkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      regime != pattn::regime(kind, hd, s) || grid != pattn::grid(regime, a.qtiles * a.bkv, sms))
    return static_cast<int>(cudaErrorInvalidValue);
  const int sw = hd >= 64 ? 128 : 64;
  pattn::Maps m;
  const int h = kvh * g;
  const cuuint64_t qdims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(h),
                               static_cast<cuuint64_t>(t), static_cast<cuuint64_t>(b)};
  const cuuint64_t qstrides[3] = {static_cast<cuuint64_t>(hd) * 2,
                                  static_cast<cuuint64_t>(h) * hd * 2,
                                  static_cast<cuuint64_t>(t) * h * hd * 2};
  const cuuint32_t qbox[4] = {static_cast<cuuint32_t>(sw / 2), static_cast<cuuint32_t>(g),
                              static_cast<cuuint32_t>(a.npos), 1};
  if (!hop::tensor_map_nd(&m.q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, q, qdims, qstrides, qbox,
                          sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B) ||
      !cache_map(&m.k, k, kind, b, kvh, s, hd, kv_b, kv_h, sw, tile, raw_slots) ||
      !cache_map(&m.v, v, kind, b, kvh, s, hd, kv_b, kv_h, sw, tile, raw_slots))
    return static_cast<int>(cudaErrorInvalidValue);
  const int plan[7] = {tile, stages, raw_slots, raw_stages, smem, regime, grid};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (kind) {
    case attn::kBf16: err = pattn::launch_bf16(a, m, plan, st); break;
    case attn::kF32: err = pattn::launch_f32(a, m, plan, st); break;
    case attn::kInt8: err = pattn::launch_int8(a, m, plan, st); break;
    case attn::kInt4: err = pattn::launch_int4(a, m, plan, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
#endif  // IN_PART(0)
