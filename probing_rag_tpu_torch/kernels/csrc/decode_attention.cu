// Decode attention over the whole static KV cache, reading the cache in its
// stored type (bf16, f32, int8 with per-slot scales, or nibble-packed int4
// with group scales).
//
// Not a Pallas kernel: the JAX package leaves this function to XLA
// (probing_rag_tpu/models/gemma.py::_attn_core :755, called by _attention
// :787), which fuses the convert of the cache into the score and value
// dots and never writes a widened copy of K or V. This kernel computes
// _attn_core's function for the few query positions of a decode step
// (T = 1) or a speculative verify round (T = k + 1) against all S slots of
// one layer's cache: f32 scores q.k * (1 / sqrt(hd)), -1e30 where the mask
// is False, a softmax over all S slots, the probabilities rounded to the
// compute type, f32 sums of p * v. The cache is dequantized as the plain
// version dequantizes it (dt(q) * dt(scale), rounded to dt). A row whose
// every slot is masked gives the mean of v over all S slots, as the plain
// softmax over -1e30 does.
//
// Bound on this card: device-memory bandwidth (each cache byte meets G x T
// query rows: 8 at a Gemma-2B step, 40 at its verify round, so 16 to 80
// bf16 operations a cache byte, far under the tensor cores' ~295 a byte).
// The CUDA-core passes of the first design (PR 13) were bound by their
// f32 work per slot instead (an int8 cache, half the bytes, ran barely
// faster than bf16), so with bf16 compute the passes' products run on the
// tensor cores (attention_mma.cuh: mma.sync m16n8k16 on bf16 operands, f32
// sums), and the cache streams through a two-stage cp.async ring in shared
// memory, widened there to bf16 when it is f32, int8 or int4.
// Design (split-S, flash-decoding): the slots are cut into tiles of 128,
// and the tiles of each (batch row, kv head) into splits, so that about
// two blocks an SM run over all SMs. Three launches:
//   1. scores: cache slots on M, query rows on N (the decode step's 8 rows
//      are one n8 tile, the verify round's 40 five): A is a 16-slot x 16-lane
//      tile of K by ldmatrix, B the query rows (bf16 in shared memory), each
//      warp 16 slots of a 64-slot step. It writes the masked, scaled scores
//      (B*KV x R x S f32, small beside the cache) and the split's max and
//      sum of exponentials per row.
//   2. values: each block first merges every split's (max, sum) of its rows
//      into the softmax's max and denominator, so the probabilities it forms
//      from the stored scores are the normalised ones the plain version
//      rounds to bf16 (a 64-slot step of them in shared memory). Then
//      out^T [hd, R] += V^T [hd, 64] P^T [64, R]: A is V^T by ldmatrix.trans
//      from the staged V tile, B the bf16 probabilities; each warp a quarter
//      of the head dim. One partial output a split.
//   3. combine: the partial outputs summed over the splits in order (no
//      atomics: graph and eager runs give the same bits).
// With f32 compute (a checking mode) and head dims under 64 the passes are
// the CUDA-core ones: the cache read straight into registers and widened
// there, f32 products, the same three launches.
// No allocation and no host sync: the wrapper hands in the scratch, so the
// decode step's CUDA graph captures the three launches.

// nvcc-parts: 4
// The build compiles this file once per part, with NVCC_PART = 0 .. 3 and
// NVCC_PARTS = 4 (kernels/__init__.py reads the line above): part p holds
// the tensor-core passes of cache kind p; part 0 also holds the CUDA-core
// passes, the combine pass and the C entry.
#ifndef NVCC_PART
#define NVCC_PART 0
#define NVCC_PARTS 1
#endif
#define IN_PART(p) (NVCC_PARTS == 1 || NVCC_PART == (p))

#include <cuda_bf16.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace dattn {

struct Args {
  const void* q;              // [B, T, KV, G, hd] in the compute type (bf16 or f32)
  const unsigned char* k;     // one layer's cache; slots of a (b, kv head) contiguous
  const unsigned char* v;
  const float* k_scale;       // int8: a row of S per (b, kv head); int4: per (b, kv head, group)
  const float* v_scale;
  const unsigned char* mask;  // bool, slots contiguous
  float* scores;              // [B*KV, R, S]
  float* part_m;              // [B*KV, R, nsplit]
  float* part_l;
  float* part_o;              // [nsplit, B*KV, R, hd]
  float* out;                 // [B, T, KV*G*hd]
  long long kv_b, kv_h;       // byte strides of the cache's batch and kv-head dims
  long long sc_b, sc_r;       // element strides of the scales' batch and row dims
  long long m_b, m_t;         // byte strides of the mask's batch and query dims
  int kvh, g, t, s, hd, grp;  // kv heads, query heads a kv head, T, S, head dim, int4 group
  int tiles_per_split, nsplit;
  float scale;                // 1 / sqrt(hd), rounded to f32
  int round_bf16;             // compute type bf16: values and probabilities rounded to it
};

// the tensor-core passes of one cache kind (bf16 compute, hd 64, 128 or 256)
cudaError_t mma_passes_bf16(const Args& a, int bkv, cudaStream_t stream);
cudaError_t mma_passes_f32(const Args& a, int bkv, cudaStream_t stream);
cudaError_t mma_passes_int8(const Args& a, int bkv, cudaStream_t stream);
cudaError_t mma_passes_int4(const Args& a, int bkv, cudaStream_t stream);

}  // namespace dattn

namespace {

using namespace attn;
using dattn::Args;

constexpr int kThreads = 256;       // the value and combine passes
constexpr int kTile = 128;          // cache slots per tile; a thread a slot in the score pass
constexpr int kMaxRows = 64;        // G x T
constexpr int kMaxHeadDim = 256;
constexpr int kGroupRows = 8;       // query rows a warp holds in the value pass

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

#if IN_PART(0)

// Bytes of 8 head-dim lanes of a cache row.
template <int KIND>
__host__ __device__ constexpr int chunk_bytes() {
  return KIND == kBf16 ? 16 : KIND == kF32 ? 32 : KIND == kInt8 ? 8 : 4;
}

// 8 lanes of a cache row as stored.
template <int KIND>
struct Chunk {
  uint4 w[KIND == kF32 ? 2 : 1];
};

template <int KIND>
__device__ __forceinline__ void load_chunk(Chunk<KIND>& c, const unsigned char* p) {
  if constexpr (KIND == kBf16) {
    c.w[0] = __ldg(reinterpret_cast<const uint4*>(p));
  } else if constexpr (KIND == kF32) {
    c.w[0] = __ldg(reinterpret_cast<const uint4*>(p));
    c.w[1] = __ldg(reinterpret_cast<const uint4*>(p) + 1);
  } else if constexpr (KIND == kInt8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    c.w[0] = make_uint4(u.x, u.y, 0u, 0u);
  } else {
    c.w[0] = make_uint4(__ldg(reinterpret_cast<const unsigned int*>(p)), 0u, 0u, 0u);
  }
}

// The chunk dequantized as the plain version dequantizes (dt(q) * dt(s),
// rounded to dt when dt is bf16); s is the chunk's scale (int8: its slot's,
// int4: its group's), already in dt.
template <int KIND>
__device__ __forceinline__ void widen(const Chunk<KIND>& c, float s, int rb, float (&x)[8]) {
  if constexpr (KIND == kBf16) {
    const unsigned int w[4] = {c.w[0].x, c.w[0].y, c.w[0].z, c.w[0].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[2 * e] = __uint_as_float(w[e] << 16);
      x[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    }
  } else if constexpr (KIND == kF32) {
    const unsigned int w[8] = {c.w[0].x, c.w[0].y, c.w[0].z, c.w[0].w,
                               c.w[1].x, c.w[1].y, c.w[1].z, c.w[1].w};
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = rb ? round_bf16(__uint_as_float(w[e])) : __uint_as_float(w[e]);
  } else if constexpr (KIND == kInt8) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const unsigned int w = e < 4 ? c.w[0].x : c.w[0].y;
      const float y = static_cast<float>(static_cast<int>(w << (24 - 8 * (e & 3))) >> 24) * s;
      x[e] = rb ? round_bf16(y) : y;
    }
  } else {  // int4: byte e holds lanes 2e (low nibble) and 2e + 1, biased by 8
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float y = static_cast<float>(static_cast<int>((c.w[0].x >> (4 * e)) & 0xfu) - 8) * s;
      x[e] = rb ? round_bf16(y) : y;
    }
  }
}

// The (b, kv head) of block row bk: its cache rows and its first scale row.
template <int KIND>
__device__ __forceinline__ void cache_rows(const Args& a, const unsigned char* cache,
                                           const float* scales, int bk,
                                           const unsigned char*& rows, const float*& sc) {
  const int b = bk / a.kvh, h = bk - b * a.kvh;
  rows = cache + b * a.kv_b + h * a.kv_h;
  sc = nullptr;
  if constexpr (KIND == kInt8) sc = scales + b * a.sc_b + h * a.sc_r;
  if constexpr (KIND == kInt4) sc = scales + b * a.sc_b + (long long)h * (a.hd / a.grp) * a.sc_r;
}

// The scale of lanes [c, c + 8) of slot `slot` (1 for bf16 and f32), in dt.
template <int KIND>
__device__ __forceinline__ float chunk_scale(const Args& a, const float* sc, int slot, int c) {
  float s = 1.0f;
  if constexpr (KIND == kInt8) s = __ldg(sc + slot);
  if constexpr (KIND == kInt4) s = __ldg(sc + (long long)(c / a.grp) * a.sc_r + slot);
  return a.round_bf16 ? round_bf16(s) : s;
}

// Pass 1. Grid (nsplit, B*KV), kTile threads. RMAX >= R. PARTS
// neighbouring lanes share PARTS slots, each lane taking every PARTS-th
// 8-lane chunk of the head dim, so that each q value a lane reads from
// shared memory serves PARTS slots; their partial sums are added by
// shuffles and lane p keeps slot p of its group.
template <int KIND, int RMAX, int PARTS>
__global__ void __launch_bounds__(kTile) attn_scores(Args a) {
  constexpr int kFlight = 2;  // chunks in flight a slot
  extern __shared__ float4 smem4[];
  const int R = a.g * a.t, hd = a.hd;
  const int bk = blockIdx.y, b = bk / a.kvh, h = bk - b * a.kvh;
  float* qs = reinterpret_cast<float*>(smem4);  // [R][hd]
  float* sc = qs + R * hd;                      // [R][kTile] the tile's scores
  float* st_m = sc + R * kTile;                 // [R] the split's running max
  float* st_l = st_m + R;                       // [R] and sum of exponentials
  // q [B, T, KV, G, hd]: row r = t * G + g of this (b, h), eight loads in flight
  for (int base = threadIdx.x; base < R * hd; base += 8 * kTile) {
    float x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = base + j * kTile, r = i / hd, t = r / a.g;
      const long long at = ((((long long)b * a.t + t) * a.kvh + h) * a.g + (r - t * a.g)) * hd +
                           (i - r * hd);
      x[j] = i >= R * hd ? 0.0f
             : a.round_bf16 ? __bfloat162float(__ldg(static_cast<const __nv_bfloat16*>(a.q) + at))
                            : __ldg(static_cast<const float*>(a.q) + at);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (base + j * kTile < R * hd) qs[base + j * kTile] = x[j];
  }
  for (int r = threadIdx.x; r < R; r += kTile) {
    st_m[r] = -INFINITY;
    st_l[r] = 0.0f;
  }
  const unsigned char* rows;
  const float* scl;
  cache_rows<KIND>(a, a.k, a.k_scale, bk, rows, scl);
  const long long row_bytes = (long long)hd / 8 * chunk_bytes<KIND>();
  const int nchunks = hd / 8 / PARTS;  // a lane's chunks of a row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int part = threadIdx.x % PARTS, g0 = threadIdx.x - part;  // the group's first slot
  const int ntiles = (a.s + kTile - 1) / kTile;
  const int tile0 = blockIdx.x * a.tiles_per_split;
  const int tile1 = min(tile0 + a.tiles_per_split, ntiles);
  for (int tile = tile0; tile < tile1; ++tile) {
    const int s0 = tile * kTile, ns = min(kTile, a.s - s0);
    __syncthreads();  // q and the stats are written; the last tile's reads are done
    float acc[PARTS][RMAX];
#pragma unroll
    for (int j = 0; j < PARTS; ++j)
#pragma unroll
      for (int i = 0; i < RMAX; ++i) acc[j][i] = 0.0f;
    for (int c0 = 0; c0 < nchunks; c0 += kFlight) {
      Chunk<KIND> raw[kFlight][PARTS];
#pragma unroll
      for (int u = 0; u < kFlight; ++u)
#pragma unroll
        for (int j = 0; j < PARTS; ++j)
          if (c0 + u < nchunks && g0 + j < ns)
            load_chunk<KIND>(raw[u][j], rows + (s0 + g0 + j) * row_bytes +
                                            ((c0 + u) * PARTS + part) * chunk_bytes<KIND>());
#pragma unroll
      for (int u = 0; u < kFlight; ++u) {
        if (c0 + u < nchunks) {
          const int c = ((c0 + u) * PARTS + part) * 8;
          float x[PARTS][8];  // a slot past the tile's end widens garbage into its own sums
#pragma unroll
          for (int j = 0; j < PARTS; ++j)
            widen<KIND>(raw[u][j], chunk_scale<KIND>(a, scl, min(s0 + g0 + j, a.s - 1), c),
                        a.round_bf16, x[j]);
#pragma unroll
          for (int i = 0; i < RMAX; ++i) {
            if (i < R) {
              const float4 q0 = *reinterpret_cast<const float4*>(qs + i * hd + c);
              const float4 q1 = *reinterpret_cast<const float4*>(qs + i * hd + c + 4);
#pragma unroll
              for (int j = 0; j < PARTS; ++j) {
                float y = acc[j][i];
                y = fmaf(q0.x, x[j][0], y);
                y = fmaf(q0.y, x[j][1], y);
                y = fmaf(q0.z, x[j][2], y);
                y = fmaf(q0.w, x[j][3], y);
                y = fmaf(q1.x, x[j][4], y);
                y = fmaf(q1.y, x[j][5], y);
                y = fmaf(q1.z, x[j][6], y);
                acc[j][i] = fmaf(q1.w, x[j][7], y);
              }
            }
          }
        }
      }
    }
    // the group's lanes add their parts of the head dim; lane p keeps slot p
    float mine[RMAX];
#pragma unroll
    for (int i = 0; i < RMAX; ++i) {
#pragma unroll
      for (int j = 0; j < PARTS; ++j)
#pragma unroll
        for (int off = 1; off < PARTS; off <<= 1)
          acc[j][i] += __shfl_xor_sync(0xffffffffu, acc[j][i], off);
      mine[i] = acc[0][i];
#pragma unroll
      for (int j = 1; j < PARTS; ++j)
        if (part == j) mine[i] = acc[j][i];
    }
    const int sl = g0 + part, slot = s0 + sl;
#pragma unroll
    for (int i = 0; i < RMAX; ++i) {
      if (i < R) {
        float x = -INFINITY;  // no slot: no weight in the stats
        if (sl < ns) {
          const bool keep = __ldg(a.mask + b * a.m_b + (i / a.g) * a.m_t + slot) != 0;
          x = keep ? mine[i] * a.scale : kMasked;
          a.scores[((long long)bk * R + i) * a.s + slot] = x;
        }
        sc[i * kTile + sl] = x;
      }
    }
    __syncthreads();
    // each row's tile max and sum of exponentials, folded into the split's
    for (int r = warp; r < R; r += kTile / 32) {
      float m = -INFINITY;
      for (int j = lane; j < kTile; j += 32) m = fmaxf(m, sc[r * kTile + j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      float l = 0.0f;
      for (int j = lane; j < kTile; j += 32) l += expf(sc[r * kTile + j] - m);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
      if (lane == 0) {
        const float mm = fmaxf(st_m[r], m);
        st_l[r] = st_l[r] * expf(st_m[r] - mm) + l * expf(m - mm);
        st_m[r] = mm;
      }
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += kTile) {
    a.part_m[((long long)bk * R + r) * a.nsplit + blockIdx.x] = st_m[r];
    a.part_l[((long long)bk * R + r) * a.nsplit + blockIdx.x] = st_l[r];
  }
}

// Pass 2. Grid (nsplit, B*KV), kThreads threads. Warp w holds rows
// [8 rg, 8 rg + 8), rg = w % NRG, and takes every SG-th group of SPW slots
// from sg = w / NRG (NRG = ceil(R / 8), SG = 8 / NRG); lane l the head-dim
// lanes [8 (l % LPR), + 8) of slot l / LPR of the group (LPR = hd / 8, SPW
// = 32 / LPR).
template <int KIND>
__global__ void __launch_bounds__(kThreads) attn_values(Args a) {
  constexpr int kFlight = 4;  // slots in flight a lane
  extern __shared__ float4 smem4[];
  const int R = a.g * a.t, hd = a.hd;
  const int nrg = (R + kGroupRows - 1) / kGroupRows, rp = nrg * kGroupRows;
  const int bk = blockIdx.y;
  float* ms = reinterpret_cast<float*>(smem4);  // [kMaxRows] the softmax's max
  float* ls = ms + kMaxRows;                    // [kMaxRows] and denominator
  float* buf = ls + kMaxRows;  // the probabilities [kTile][rp], then the warps' sums
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // a warp a row: the lanes read the splits' partials together and reduce
  // them in a fixed order (every block of the row gets the same bits)
  for (int r = warp; r < R; r += kThreads / 32) {
    const long long row = (long long)bk * R + r;
    const float* pm = a.part_m + row * a.nsplit;
    const float* pl = a.part_l + row * a.nsplit;
    float m = -INFINITY;
    for (int j = lane; j < a.nsplit; j += 32) m = fmaxf(m, pm[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.0f;
    for (int j = lane; j < a.nsplit; j += 32) l += pl[j] * expf(pm[j] - m);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      ms[r] = m;
      ls[r] = l;
    }
  }
  const unsigned char* rows;
  const float* scl;
  cache_rows<KIND>(a, a.v, a.v_scale, bk, rows, scl);
  const long long row_bytes = (long long)hd / 8 * chunk_bytes<KIND>();
  const int lpr = hd / 8, spw = 32 / lpr, sgs = (kThreads / 32) / nrg;
  const int rg = warp % nrg, sg = warp / nrg;
  const int sub = lane / lpr, c = (lane % lpr) * 8;
  const bool active = sg < sgs;
  const int step = sgs * spw;  // slots between a lane's consecutive slots
  float acc[kGroupRows][8];
#pragma unroll
  for (int i = 0; i < kGroupRows; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.0f;
  const int ntiles = (a.s + kTile - 1) / kTile;
  const int tile0 = blockIdx.x * a.tiles_per_split;
  const int tile1 = min(tile0 + a.tiles_per_split, ntiles);
  for (int tile = tile0; tile < tile1; ++tile) {
    const int s0 = tile * kTile, ns = min(kTile, a.s - s0);
    __syncthreads();  // ms / ls are written; the last tile's probabilities are read
    const float* srow = a.scores + (long long)bk * R * a.s + s0;
    for (int base = threadIdx.x; base < rp * kTile; base += 8 * kThreads) {
      float x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // eight scores in flight
        const int i = base + j * kThreads, r = i / kTile, sl = i - r * kTile;
        x[j] = i < rp * kTile && r < R && sl < ns ? srow[(long long)r * a.s + sl] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = base + j * kThreads, r = i / kTile, sl = i - r * kTile;
        if (i < rp * kTile) {
          float p = 0.0f;
          if (r < R && sl < ns) {
            p = expf(x[j] - ms[r]) / ls[r];
            if (a.round_bf16) p = round_bf16(p);
          }
          buf[sl * rp + r] = p;
        }
      }
    }
    __syncthreads();
    if (active) {
      for (int k0 = sg * spw + sub; k0 < ns; k0 += kFlight * step) {
        Chunk<KIND> raw[kFlight];
#pragma unroll
        for (int u = 0; u < kFlight; ++u) {
          const int sl = k0 + u * step;
          if (sl < ns) load_chunk<KIND>(raw[u], rows + (s0 + sl) * row_bytes + c / 8 * chunk_bytes<KIND>());
        }
#pragma unroll
        for (int u = 0; u < kFlight; ++u) {
          const int sl = k0 + u * step;
          if (sl < ns) {
            float x[8];
            widen<KIND>(raw[u], chunk_scale<KIND>(a, scl, s0 + sl, c), a.round_bf16, x);
            const float4 p0 = *reinterpret_cast<const float4*>(buf + sl * rp + rg * kGroupRows);
            const float4 p1 = *reinterpret_cast<const float4*>(buf + sl * rp + rg * kGroupRows + 4);
            const float p[kGroupRows] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
            for (int i = 0; i < kGroupRows; ++i)
#pragma unroll
              for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(p[i], x[e], acc[i][e]);
          }
        }
      }
    }
  }
  // the lanes of a warp that hold other slots of the same head-dim lanes
  for (int off = lpr; off < 32; off <<= 1)
#pragma unroll
    for (int i = 0; i < kGroupRows; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] += __shfl_xor_sync(0xffffffffu, acc[i][e], off);
  __syncthreads();  // the probabilities are read: buf holds the warps' sums now
  if (active && sub == 0)
#pragma unroll
    for (int i = 0; i < kGroupRows; ++i) {
      float* o = buf + ((sg * nrg + rg) * kGroupRows + i) * hd + c;
      *reinterpret_cast<float4*>(o) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(o + 4) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  __syncthreads();
  float* out = a.part_o + ((long long)blockIdx.x * gridDim.y + bk) * R * hd;
  for (int i = threadIdx.x; i < R * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    float sum = 0.0f;
    for (int j = 0; j < sgs; ++j)  // the slot groups in order
      sum += buf[((j * nrg + r / kGroupRows) * kGroupRows + r % kGroupRows) * hd + d];
    out[i] = sum;
  }
}

// Pass 3: out[b, t, (h * G + g) * hd + c] = sum over splits, in order.
__global__ void __launch_bounds__(kThreads) attn_combine(Args a, long long total) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int R = a.g * a.t;
  float sum = 0.0f;
#pragma unroll 8
  for (int j = 0; j < a.nsplit; ++j) sum += a.part_o[j * total + i];
  const int c = static_cast<int>(i % a.hd);
  const long long rest = i / a.hd;
  const int r = static_cast<int>(rest % R);
  const long long bk = rest / R;
  const long long b = bk / a.kvh;
  const int h = static_cast<int>(bk - b * a.kvh), t = r / a.g, g = r - t * a.g;
  a.out[((b * a.t + t) * a.kvh * a.g + h * a.g + g) * a.hd + c] = sum;
}

template <int KIND, int RMAX, int PARTS>
cudaError_t launch(const Args& a, int bkv, cudaStream_t stream) {
  const int R = a.g * a.t, hd = a.hd;
  const int rp = (R + kGroupRows - 1) / kGroupRows * kGroupRows;
  const dim3 grid(a.nsplit, bkv);
  const size_t score_smem = sizeof(float) * ((size_t)R * hd + (size_t)R * kTile + 2 * R);
  const size_t sums = (size_t)(kThreads / 32) / (rp / kGroupRows) * rp * hd;
  const size_t value_smem =
      sizeof(float) * (2 * kMaxRows + ((size_t)kTile * rp > sums ? (size_t)kTile * rp : sums));
  cudaError_t err = set_smem(attn_scores<KIND, RMAX, PARTS>, score_smem);
  if (err != cudaSuccess) return err;
  attn_scores<KIND, RMAX, PARTS><<<grid, kTile, score_smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = set_smem(attn_values<KIND>, value_smem)) != cudaSuccess) return err;
  attn_values<KIND><<<grid, kThreads, value_smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t combine(const Args& a, int bkv, cudaStream_t stream) {
  const long long total = (long long)bkv * a.g * a.t * a.hd;
  attn_combine<<<static_cast<unsigned>((total + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      a, total);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t dispatch(const Args& a, int bkv, cudaStream_t stream) {
  // a decode step (up to 8 rows: four lanes share four slots, a lane's
  // quarter of the head dim whole chunks), a verify round of Gemma-2B (40),
  // else 64
  const int R = a.g * a.t;
  if (R <= 8) return launch<KIND, 8, 4>(a, bkv, stream);
  if (R <= 40) return launch<KIND, 40, 1>(a, bkv, stream);
  return launch<KIND, kMaxRows, 1>(a, bkv, stream);
}

#endif  // IN_PART(0)

// ================================================================ tensor cores

constexpr int kSub = 64;            // cache slots a step (half a tile)
constexpr int kMmaThreads = 128;    // four warps
constexpr int kPStride = kSub + 8;  // bf16 probabilities a row in shared memory (no bank conflicts)

// the block's split: slots [s_begin, s_end), at least one
__device__ __forceinline__ void split_slots(const Args& a, int& s_begin, int& s_end) {
  s_begin = blockIdx.x * a.tiles_per_split * kTile;
  s_end = min(s_begin + a.tiles_per_split * kTile, a.s);
}

// Pass 1 on the tensor cores. Grid (nsplit, B*KV), kMmaThreads threads;
// NR n8 tiles of query rows (R <= 8 NR). Warp w takes slots [16 w, 16 w +
// 16) of each 64-slot step: A = its K rows (ldmatrix), B = q^T (the query
// rows in shared memory), sums over HD / 16 steps of 16 lanes.
template <int KIND, int HD, int NR>
__global__ void __launch_bounds__(kMmaThreads) attn_scores_mma(Args a) {
  using RG = Ring<KIND, HD, kSub, kMmaThreads>;
  constexpr int kC = HD / 8, kRp = NR * 8;
  extern __shared__ float4 smem4[];
  unsigned char* qs = reinterpret_cast<unsigned char*>(smem4);  // [kRp][HD] bf16, swizzled
  const RG kr{qs + kRp * HD * 2};
  float* sc = reinterpret_cast<float*>(kr.base + RG::kBytes);  // [kRp][kSub] a step's scores
  float* st_m = sc + kRp * kSub;                               // [kRp] the split's running max
  float* st_l = st_m + kRp;                                    // and sum of exponentials
  const int R = a.g * a.t;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g4 = lane >> 2, t4 = lane & 3;
  const int bk = blockIdx.y, b = bk / a.kvh, h = bk - b * a.kvh;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  // q [B, T, KV, G, hd]: row r = t * G + g of this (b, h); zeros past R
  for (int p = threadIdx.x; p < kRp * kC; p += kMmaThreads) {
    const int r = p / kC, c = p - r * kC, t = r / a.g;
    const __nv_bfloat16* src = q;
    if (r < R)
      src = q + ((((long long)b * a.t + t) * a.kvh + h) * a.g + (r - t * a.g)) * HD + c * 8;
    cp_async16(smem_u32(qs) + swz<HD>(r, c), src, r < R ? 16 : 0);
  }
  cp_async_commit();
  for (int r = threadIdx.x; r < kRp; r += kMmaThreads) {
    st_m[r] = -INFINITY;
    st_l[r] = 0.0f;
  }
  const CacheRef ck = cache_ref<KIND>(a.k, a.k_scale, b, h, a.kv_b, a.kv_h, a.sc_b, a.sc_r, HD,
                                      a.grp, a.s);
  int s_begin, s_end;
  split_slots(a, s_begin, s_end);
  const int nsub = (s_end - s_begin + kSub - 1) / kSub;
  const uint32_t q_smem = smem_u32(qs);
  const unsigned char* mrow = a.mask + b * a.m_b;
  kr.issue(0, ck, s_begin);
  cp_async_commit();
  for (int j = 0; j < nsub; ++j) {
    // the stage written here was last read in step j - 1, before its sync
    if (j + 1 < nsub) kr.issue((j + 1) & 1, ck, s_begin + (j + 1) * kSub);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // the stage has landed; the last step's stats are read
    if constexpr (KIND != kBf16) {
      kr.widen(j & 1, a.grp);
      __syncthreads();
    }
    float acc[NR + 1][4];
#pragma unroll
    for (int nt = 0; nt <= NR; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
    const uint32_t kt = kr.tile(j & 1);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t ka[4];
      ldsm_x4(ka, kt + swz<HD>(warp * 16 + (lane & 15), kk * 2 + (lane >> 4)));
#pragma unroll
      for (int nt = 0; nt < NR; nt += 2) {
        if (nt + 1 < NR) {
          uint32_t qb[4];
          ldsm_x4(qb, q_smem + swz<HD>(nt * 8 + ((lane >> 4) << 3) + (lane & 7),
                                       kk * 2 + ((lane >> 3) & 1)));
          mma16816(acc[nt], ka, qb[0], qb[1]);
          mma16816(acc[nt + 1], ka, qb[2], qb[3]);
        } else {
          uint32_t qb[2];
          ldsm_x2(qb, q_smem + swz<HD>(nt * 8 + (lane & 7), kk * 2 + ((lane >> 3) & 1)));
          mma16816(acc[nt], ka, qb[0], qb[1]);
        }
      }
    }
    // acc[nt]: (slot 16 w + g, rows 8 nt + 2t, + 1), (slot + 8, the same rows)
    const int s0 = s_begin + j * kSub;
#pragma unroll
    for (int nt = 0; nt < NR; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int sl = warp * 16 + g4 + (e >> 1) * 8, r = nt * 8 + 2 * t4 + (e & 1);
        const int slot = s0 + sl;
        if (r < R) {
          float x = -INFINITY;  // no slot: no weight in the stats
          if (slot < s_end) {
            const bool keep = __ldg(mrow + (r / a.g) * a.m_t + slot) != 0;
            x = keep ? acc[nt][e] * a.scale : kMasked;
            a.scores[((long long)bk * R + r) * a.s + slot] = x;
          }
          sc[r * kSub + sl] = x;
        }
      }
    __syncthreads();  // the step's scores are written; every warp has read the stage
    // each row's step max and sum of exponentials, folded into the split's
    for (int r = warp; r < R; r += kMmaThreads / 32) {
      const float x0 = sc[r * kSub + lane], x1 = sc[r * kSub + lane + 32];
      float m = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      float l = expf(x0 - m) + expf(x1 - m);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
      if (lane == 0) {
        const float mm = fmaxf(st_m[r], m);
        st_l[r] = st_l[r] * expf(st_m[r] - mm) + l * expf(m - mm);
        st_m[r] = mm;
      }
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += kMmaThreads) {
    a.part_m[((long long)bk * R + r) * a.nsplit + blockIdx.x] = st_m[r];
    a.part_l[((long long)bk * R + r) * a.nsplit + blockIdx.x] = st_l[r];
  }
}

// Pass 2 on the tensor cores. Grid (nsplit, B*KV), kMmaThreads threads.
// out^T [HD, R] = V^T [HD, S] P^T [S, R] over the split's slots: warp w
// holds lanes [HD/4 w, HD/4 (w + 1)) (HD / 64 m16 tiles) of all rows;
// A = V^T by ldmatrix.trans from the staged V tile, B = the step's bf16
// probabilities.
template <int KIND, int HD, int NR>
__global__ void __launch_bounds__(kMmaThreads) attn_values_mma(Args a) {
  using RG = Ring<KIND, HD, kSub, kMmaThreads>;
  constexpr int kRp = NR * 8, kMT = HD / 64;
  extern __shared__ float4 smem4[];
  float* ms = reinterpret_cast<float*>(smem4);  // [kMaxRows] the softmax's max
  float* ls = ms + kMaxRows;                    // [kMaxRows] and denominator
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(ls + kMaxRows);  // [kRp][kPStride]
  const RG vr{reinterpret_cast<unsigned char*>(ps + kRp * kPStride)};
  const int R = a.g * a.t;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g4 = lane >> 2, t4 = lane & 3;
  const int bk = blockIdx.y, b = bk / a.kvh, h = bk - b * a.kvh;
  const CacheRef cv = cache_ref<KIND>(a.v, a.v_scale, b, h, a.kv_b, a.kv_h, a.sc_b, a.sc_r, HD,
                                      a.grp, a.s);
  int s_begin, s_end;
  split_slots(a, s_begin, s_end);
  const int nsub = (s_end - s_begin + kSub - 1) / kSub;
  vr.issue(0, cv, s_begin);
  cp_async_commit();
  // a warp a row: the splits' partials merged in a fixed order (every
  // block of the row gets the same bits)
  for (int r = warp; r < R; r += kMmaThreads / 32) {
    const long long row = (long long)bk * R + r;
    const float* pm = a.part_m + row * a.nsplit;
    const float* pl = a.part_l + row * a.nsplit;
    float m = -INFINITY;
    for (int j = lane; j < a.nsplit; j += 32) m = fmaxf(m, pm[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.0f;
    for (int j = lane; j < a.nsplit; j += 32) l += pl[j] * expf(pm[j] - m);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      ms[r] = m;
      ls[r] = l;
    }
  }
  for (int i = threadIdx.x; i < kRp * kPStride; i += kMmaThreads) ps[i] = __float2bfloat16_rn(0.0f);
  float acc[kMT][NR][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NR; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
  const float* srow = a.scores + (long long)bk * R * a.s;
  __syncthreads();  // ms / ls are written, the probabilities zeroed
  for (int j = 0; j < nsub; ++j) {
    // its stage was last read in step j - 1, before the trailing sync
    if (j + 1 < nsub) vr.issue((j + 1) & 1, cv, s_begin + (j + 1) * kSub);
    cp_async_commit();
    const int s0 = s_begin + j * kSub, ns = min(kSub, s_end - s0);
    for (int base = threadIdx.x; base < R * kSub; base += 8 * kMmaThreads) {
      float x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {  // eight scores in flight
        const int p = base + u * kMmaThreads, r = p / kSub, sl = p - r * kSub;
        x[u] = p < R * kSub && sl < ns ? srow[(long long)r * a.s + s0 + sl] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int p = base + u * kMmaThreads, r = p / kSub, sl = p - r * kSub;
        if (p < R * kSub)
          ps[r * kPStride + sl] = __float2bfloat16_rn(sl < ns ? expf(x[u] - ms[r]) / ls[r] : 0.0f);
      }
    }
    cp_async_wait<1>();
    __syncthreads();
    if constexpr (KIND != kBf16) {
      vr.widen(j & 1, a.grp);
      __syncthreads();
    }
    const uint32_t vt = vr.tile(j & 1);
#pragma unroll
    for (int ks = 0; ks < kSub / 16; ++ks) {
      uint32_t pb[NR][2];  // (slot 16 ks + 2t, + 1; row 8 nt + g) and slot + 8
#pragma unroll
      for (int nt = 0; nt < NR; ++nt) {
        const __nv_bfloat16* pr = ps + (nt * 8 + g4) * kPStride + ks * 16 + 2 * t4;
        pb[nt][0] = *reinterpret_cast<const uint32_t*>(pr);
        pb[nt][1] = *reinterpret_cast<const uint32_t*>(pr + 8);
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        uint32_t va[4];
        ldsm_x4_t(va, vt + swz<HD>(ks * 16 + ((lane >> 4) << 3) + (lane & 7),
                                   (warp * (HD / 4) + mt * 16) / 8 + ((lane >> 3) & 1)));
#pragma unroll
        for (int nt = 0; nt < NR; ++nt) mma16816(acc[mt][nt], va, pb[nt][0], pb[nt][1]);
      }
    }
    __syncthreads();  // the stage and the probabilities are read
  }
  // acc[mt][nt]: (lane HD/4 w + 16 mt + g, rows 8 nt + 2t, + 1), (lane + 8, the same rows)
  float* out = a.part_o + ((long long)blockIdx.x * gridDim.y + bk) * R * HD;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NR; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = warp * (HD / 4) + mt * 16 + g4 + (e >> 1) * 8, r = nt * 8 + 2 * t4 + (e & 1);
        if (r < R) out[r * HD + d] = acc[mt][nt][e];
      }
}

template <int KIND, int HD, int NR>
cudaError_t launch_mma(const Args& a, int bkv, cudaStream_t stream) {
  using RG = Ring<KIND, HD, kSub, kMmaThreads>;
  constexpr int kRp = NR * 8;
  const dim3 grid(a.nsplit, bkv);
  const size_t score_smem =
      (size_t)kRp * HD * 2 + RG::kBytes + sizeof(float) * ((size_t)kRp * kSub + 2 * kRp);
  const size_t value_smem =
      sizeof(float) * 2 * kMaxRows + (size_t)kRp * kPStride * 2 + RG::kBytes;
  cudaError_t err = set_smem(attn_scores_mma<KIND, HD, NR>, score_smem);
  if (err != cudaSuccess) return err;
  attn_scores_mma<KIND, HD, NR><<<grid, kMmaThreads, score_smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = set_smem(attn_values_mma<KIND, HD, NR>, value_smem)) != cudaSuccess) return err;
  attn_values_mma<KIND, HD, NR><<<grid, kMmaThreads, value_smem, stream>>>(a);
  return cudaGetLastError();
}

template <int KIND, int HD>
cudaError_t launch_rows(const Args& a, int bkv, cudaStream_t stream) {
  // a decode step (up to 8 rows: one n8 tile), a verify round of Gemma-2B
  // (40: five), else 64
  const int R = a.g * a.t;
  if (R <= 8) return launch_mma<KIND, HD, 1>(a, bkv, stream);
  if (R <= 40) return launch_mma<KIND, HD, 5>(a, bkv, stream);
  return launch_mma<KIND, HD, 8>(a, bkv, stream);
}

template <int KIND>
cudaError_t dispatch_mma(const Args& a, int bkv, cudaStream_t stream) {
  switch (a.hd) {
    case 64: return launch_rows<KIND, 64>(a, bkv, stream);
    case 128: return launch_rows<KIND, 128>(a, bkv, stream);
    case 256: return launch_rows<KIND, 256>(a, bkv, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

namespace dattn {

#if IN_PART(0)
cudaError_t mma_passes_bf16(const Args& a, int bkv, cudaStream_t stream) {
  return dispatch_mma<kBf16>(a, bkv, stream);
}
#endif
#if IN_PART(1)
cudaError_t mma_passes_f32(const Args& a, int bkv, cudaStream_t stream) {
  return dispatch_mma<kF32>(a, bkv, stream);
}
#endif
#if IN_PART(2)
cudaError_t mma_passes_int8(const Args& a, int bkv, cudaStream_t stream) {
  return dispatch_mma<kInt8>(a, bkv, stream);
}
#endif
#if IN_PART(3)
cudaError_t mma_passes_int4(const Args& a, int bkv, cudaStream_t stream) {
  return dispatch_mma<kInt4>(a, bkv, stream);
}
#endif

}  // namespace dattn

#if IN_PART(0)

// q: [B, T, KV*G, hd] in the compute type (bf16 when round_bf16, else
// f32). k, v: one layer's cache (kind 0 bf16, 1 f32, 2 int8 with k_scale /
// v_scale a row of S floats per (b, kv head), 3 nibble-packed int4 with a
// row per (b, kv head, group of grp lanes));
// kv_b / kv_h byte strides, sc_b / sc_r scale strides in floats; mask
// bool with byte strides m_b / m_t and contiguous slots. Scratch: scores
// [B*KV, G*T, S], part_m / part_l [B*KV, G*T, nsplit], part_o [nsplit,
// B*KV, G*T, hd] f32. out: [B, T, KV*G*hd] f32.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale, const void* mask,
                                void* scores, void* part_m, void* part_l, void* part_o, void* out,
                                int kind, int round_bf16, int b, int kvh, int g, int t, int s,
                                int hd, int grp, long long kv_b, long long kv_h, long long sc_b,
                                long long sc_r, long long m_b, long long m_t, int tiles_per_split,
                                int nsplit, float scale, void* stream) {
  const int ntiles = (s + kTile - 1) / kTile;
  // a lane holds 8 head-dim lanes, four lanes a row in the score pass; a
  // warp holds whole rows of them in the value pass
  if (g * t > kMaxRows || hd > kMaxHeadDim || hd < 32 || kMaxHeadDim % hd != 0 || b * kvh > 65535 ||
      tiles_per_split < 1 || (nsplit - 1) * tiles_per_split >= ntiles ||
      nsplit * tiles_per_split < ntiles)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = static_cast<const unsigned char*>(k);
  a.v = static_cast<const unsigned char*>(v);
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.mask = static_cast<const unsigned char*>(mask);
  a.scores = static_cast<float*>(scores);
  a.part_m = static_cast<float*>(part_m);
  a.part_l = static_cast<float*>(part_l);
  a.part_o = static_cast<float*>(part_o);
  a.out = static_cast<float*>(out);
  a.kv_b = kv_b;
  a.kv_h = kv_h;
  a.sc_b = sc_b;
  a.sc_r = sc_r;
  a.m_b = m_b;
  a.m_t = m_t;
  a.kvh = kvh;
  a.g = g;
  a.t = t;
  a.s = s;
  a.hd = hd;
  a.grp = grp;
  a.tiles_per_split = tiles_per_split;
  a.nsplit = nsplit;
  a.scale = scale;
  a.round_bf16 = round_bf16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bkv = b * kvh;
  cudaError_t err;
  if (round_bf16 && (hd == 64 || hd == 128 || hd == 256)) {  // the tensor-core passes
    switch (kind) {
      case kBf16: err = dattn::mma_passes_bf16(a, bkv, st); break;
      case kF32: err = dattn::mma_passes_f32(a, bkv, st); break;
      case kInt8: err = dattn::mma_passes_int8(a, bkv, st); break;
      case kInt4: err = dattn::mma_passes_int4(a, bkv, st); break;
      default: err = cudaErrorInvalidValue;
    }
  } else {
    switch (kind) {
      case kBf16: err = dispatch<kBf16>(a, bkv, st); break;
      case kF32: err = dispatch<kF32>(a, bkv, st); break;
      case kInt8: err = dispatch<kInt8>(a, bkv, st); break;
      case kInt4: err = dispatch<kInt4>(a, bkv, st); break;
      default: err = cudaErrorInvalidValue;
    }
  }
  if (err == cudaSuccess) err = combine(a, bkv, st);
  return static_cast<int>(err);
}

#endif  // IN_PART(0)
