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
// prefill: 8 x 8 heads x 3,712 causal rows x 256, ~4.5e11 operations a
// layer against ~60 MB of Q, K, V and output). Design (FlashAttention-2's
// split of the work on mma.sync):
//   - a block takes 64 query rows of one (batch row, kv head): 64 / G
//     positions x the G query heads that share K and V (Gemma-2B: 8 x 8),
//     16 rows a warp, four warps; Q stays in shared memory (bf16, swizzled).
//   - K and V tiles of 32 slots go through a two-stage cp.async ring,
//     widened to bf16 in shared memory when the cache is not bf16.
//   - the plain version rounds the normalised probabilities to bf16, which
//     one-pass flash attention cannot, so two sweeps over the same tiles:
//     sweep 1 forms S = QK^T on the tensor cores, masks it, and keeps an
//     online row max and sum; sweep 2 forms S again, p = bf16(exp(s - m) /
//     l), and accumulates P V in f32 registers (the score fragments are the
//     value product's A operand, V by ldmatrix.trans).
//   - a K tile is visited only if some slot of it is attendable by some row
//     of the block: a prep pass writes, per 32-slot tile, the least kpos of
//     its valid slots; the block compares it with its largest qpos. Nothing
//     is decided on the host. A skipped tile is masked for every row of the
//     block, so it would add exp(-1e30 - m) = 0.
//   - a row with no attendable slot (a left pad at prefill) is the mean of
//     bf16(1/S) v over all S slots: the prep pass sums V over all slots once
//     per (batch row, kv head), and such rows get bf16(1/S) times that sum,
//     so they cost no sweep over all S.
// Launches: prep (V partial sums, valid-slot positions and tile minima),
// finish (the sums in a fixed order), attention; one call counts one
// launch. No allocation and no host sync: the wrapper hands in the scratch.

// nvcc-parts: 4
// The build compiles this file once per part, with NVCC_PART = 0 .. 3 and
// NVCC_PARTS = 4 (kernels/__init__.py reads the line above): part p holds
// the kernels of cache kind p; part 0 also holds the C entry.
#ifndef NVCC_PART
#define NVCC_PART 0
#define NVCC_PARTS 1
#endif
#define IN_PART(p) (NVCC_PARTS == 1 || NVCC_PART == (p))

#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace pattn {

struct Args {
  const __nv_bfloat16* q;   // [B, T, KV * G, hd]
  const unsigned char* k;   // cache layer; slots of a (b, kv head) contiguous
  const unsigned char* v;
  const float* k_scale;
  const float* v_scale;
  const int* qpos;          // [B, T]
  const int* kpos;          // [B, S]
  const unsigned char* valid;  // [B, S]
  int* keff;                // [B, ntiles * 32]: kpos of a valid slot, else INT_MAX
  int* tmin;                // [B, ntiles]: a tile's least keff
  float* vpart;             // [nchunks, B * KV, hd]
  float* vsum;              // [B * KV, hd]
  float* out;               // [B, T, KV * G * hd] f32
  long long kv_b, kv_h;     // byte strides of the cache's batch and kv-head dims
  long long sc_b, sc_r;     // element strides of the scales' batch and row dims
  int kvh, g, t, s, hd, grp;
  int ntiles, nchunks, npos;  // 32-slot tiles, prep chunks, positions a query tile
  float scale;              // 1 / sqrt(hd), rounded to f32
};

// the three launches for one cache kind
cudaError_t launch_bf16(const Args& a, int bkv, cudaStream_t stream);
cudaError_t launch_f32(const Args& a, int bkv, cudaStream_t stream);
cudaError_t launch_int8(const Args& a, int bkv, cudaStream_t stream);
cudaError_t launch_int4(const Args& a, int bkv, cudaStream_t stream);

}  // namespace pattn

namespace {

using namespace attn;
using pattn::Args;

constexpr int kThreads = 128;    // four warps
constexpr int kRows = 64;        // query rows a block, 16 a warp
constexpr int kSlots = 32;       // slots a K / V tile
constexpr int kPrepSlots = 256;  // slots a prep block
constexpr int kPrepThreads = 256;

// Prep. Grid (nchunks, B * KV), kPrepThreads threads. Partial sums of V
// (dequantized to bf16, summed in f32) over the chunk's slots; kv head 0's
// blocks also write keff and tmin of the chunk's tiles.
template <int KIND, int HD>
__global__ void __launch_bounds__(kPrepThreads) prefill_prep(Args a) {
  constexpr int kC = HD / 8;                  // 8-lane chunks a row
  constexpr int kLanes = kPrepThreads / kC;   // slots summed side by side
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
  if (h == 0) {  // a warp a tile: each slot's keff, the tile's least
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int tile0 = s0 / kSlots, tile1 = min((s0 + kPrepSlots) / kSlots, a.ntiles);
    for (int tile = tile0 + warp; tile < tile1; tile += kPrepThreads / 32) {
      const int slot = tile * kSlots + lane;
      int ke = INT_MAX;
      if (slot < a.s && __ldg(a.valid + (long long)b * a.s + slot))
        ke = __ldg(a.kpos + (long long)b * a.s + slot);
      a.keff[(long long)b * a.ntiles * kSlots + slot] = ke;
      ke = __reduce_min_sync(0xffffffffu, ke);
      if (lane == 0) a.tmin[(long long)b * a.ntiles + tile] = ke;
    }
  }
}

// Finish: vsum[bk, d] = the chunks' partial sums in order.
__global__ void __launch_bounds__(256) prefill_vsum(Args a, int total) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= total) return;
  float sum = 0.0f;
  for (int j = 0; j < a.nchunks; ++j) sum += a.vpart[(long long)j * total + i];
  a.vsum[i] = sum;
}

// The attention. Grid (query tiles, B * KV), kThreads threads; the tiles
// with the most positions first.
template <int KIND, int HD>
__global__ void __launch_bounds__(kThreads, 2) prefill_attn(Args a) {
  using R = Ring<KIND, HD, kSlots, kThreads>;
  constexpr int kC = HD / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* qs = smem;                    // [kRows][HD] bf16, swizzled
  const R kr{qs + kRows * HD * 2};
  const R vr{kr.base + R::kBytes};
  int* kp = reinterpret_cast<int*>(vr.base + R::kBytes);  // [2][kSlots] keff of a stage
  int* list = kp + 2 * kSlots;                             // the visited tiles, in order
  int* n_list = list + a.ntiles;                           // and their count

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bk = blockIdx.y, b = bk / a.kvh, h = bk - b * a.kvh;
  const int t0 = qt * a.npos;
  const int np = min(a.npos, a.t - t0);  // positions of this tile
  const int nrows = np * a.g;
  const int heads = a.kvh * a.g;

  // Q rows (row r = position r / G, head h * G + r % G), zeros past nrows
  for (int p = threadIdx.x; p < kRows * kC; p += kThreads) {
    const int r = p / kC, c = p - r * kC;
    const __nv_bfloat16* src = a.q;
    if (r < nrows)
      src = a.q + (((long long)b * a.t + t0 + r / a.g) * heads + h * a.g + r % a.g) * HD + c * 8;
    cp_async16(smem_u32(qs) + swz<HD>(r, c), src, r < nrows ? 16 : 0);
  }
  cp_async_commit();

  const int g4 = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16 + g4, r1 = r0 + 8;  // this thread's two rows
  const int* qp_row = a.qpos + (long long)b * a.t + t0;
  const int qp0 = r0 < nrows ? __ldg(qp_row + r0 / a.g) : INT_MIN;
  const int qp1 = r1 < nrows ? __ldg(qp_row + r1 / a.g) : INT_MIN;
  int qmax = INT_MIN;
  for (int i = lane; i < np; i += 32) qmax = max(qmax, __ldg(qp_row + i));
  qmax = __reduce_max_sync(0xffffffffu, qmax);
  if (warp == 0) {  // the tiles some row of the block may attend, in order
    int n = 0;
    for (int j0 = 0; j0 < a.ntiles; j0 += 32) {
      const int j = j0 + lane;
      const bool visit = j < a.ntiles && __ldg(a.tmin + (long long)b * a.ntiles + j) <= qmax;
      const unsigned int m = __ballot_sync(0xffffffffu, visit);
      if (visit) list[n + __popc(m & ((1u << lane) - 1u))] = j;
      n += __popc(m);
    }
    if (lane == 0) *n_list = n;
  }
  __syncthreads();
  const int n = *n_list;

  const CacheRef ck = cache_ref<KIND>(a.k, a.k_scale, b, h, a.kv_b, a.kv_h, a.sc_b, a.sc_r, HD,
                                      a.grp, a.s);
  const CacheRef cv = cache_ref<KIND>(a.v, a.v_scale, b, h, a.kv_b, a.kv_h, a.sc_b, a.sc_r, HD,
                                      a.grp, a.s);
  const int* keff = a.keff + (long long)b * a.ntiles * kSlots;
  const uint32_t q_smem = smem_u32(qs);

  // stage i <- tile list[j]: K (and V in sweep 2) and its slots' keff
  auto issue = [&](int j, bool with_v) {
    const int i = j & 1, s0 = list[j] * kSlots;
    kr.issue(i, ck, s0);
    if (with_v) vr.issue(i, cv, s0);
    if (threadIdx.x < kSlots / 4)
      cp_async16(smem_u32(kp + i * kSlots) + threadIdx.x * 16, keff + s0 + threadIdx.x * 4, 16);
  };
  // S = Q K^T for this warp's 16 rows and the tile's 32 slots, scaled and
  // masked: sc[n-tile][(g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)]
  auto scores = [&](int i, float (&sc)[4][4]) {
    const uint32_t kt = kr.tile(i);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qa[4];
      ldsm_x4(qa, q_smem + swz<HD>(warp * 16 + (lane & 15), kk * 2 + (lane >> 4)));
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t kb[4];
        ldsm_x4(kb, kt + swz<HD>(p * 16 + ((lane >> 4) << 3) + (lane & 7),
                                 kk * 2 + ((lane >> 3) & 1)));
        mma16816(sc[2 * p], qa, kb[0], kb[1]);
        mma16816(sc[2 * p + 1], qa, kb[2], kb[3]);
      }
    }
    const int* kpt = kp + i * kSlots;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ke = kpt[nt * 8 + 2 * t4 + e];
        sc[nt][e] = ke <= qp0 ? sc[nt][e] * a.scale : kMasked;
        sc[nt][2 + e] = ke <= qp1 ? sc[nt][2 + e] * a.scale : kMasked;
      }
  };

  // sweep 1: the online max and sum of each row
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  if (n > 0) issue(0, false);
  cp_async_commit();
  for (int j = 0; j < n; ++j) {
    if (j + 1 < n) issue(j + 1, false);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if constexpr (KIND != kBf16) {
      kr.widen(j & 1, a.grp);
      __syncthreads();
    }
    float sc[4][4];
    scores(j & 1, sc);
    float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      x0 = fmaxf(x0, fmaxf(sc[nt][0], sc[nt][1]));
      x1 = fmaxf(x1, fmaxf(sc[nt][2], sc[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, off));
      x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, off));
    }
    const float n0 = fmaxf(m0, x0), n1 = fmaxf(m1, x1);
    float e0 = 0.0f, e1 = 0.0f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      e0 += expf(sc[nt][0] - n0) + expf(sc[nt][1] - n0);
      e1 += expf(sc[nt][2] - n1) + expf(sc[nt][3] - n1);
    }
    l0 = l0 * expf(m0 - n0) + e0;
    l1 = l1 * expf(m1 - n1) + e1;
    m0 = n0;
    m1 = n1;
    __syncthreads();  // the stage is read: the next issue may overwrite it
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }

  // sweep 2: p = bf16(exp(s - m) / l), O += P V
  float o[HD / 8][4];
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.0f;
  if (n > 0) issue(0, true);
  cp_async_commit();
  for (int j = 0; j < n; ++j) {
    if (j + 1 < n) issue(j + 1, true);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if constexpr (KIND != kBf16) {
      kr.widen(j & 1, a.grp);
      vr.widen(j & 1, a.grp);
      __syncthreads();
    }
    float sc[4][4];
    scores(j & 1, sc);
    uint32_t pa[2][4];  // the A fragments of P, slots [16 ks, 16 ks + 16)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      float p[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          p[u][e] = expf(sc[2 * ks + u][e] - m0) / l0;
          p[u][2 + e] = expf(sc[2 * ks + u][2 + e] - m1) / l1;
        }
      pa[ks][0] = pack_bf16(p[0][0], p[0][1]);
      pa[ks][1] = pack_bf16(p[0][2], p[0][3]);
      pa[ks][2] = pack_bf16(p[1][0], p[1][1]);
      pa[ks][3] = pack_bf16(p[1][2], p[1][3]);
    }
    const uint32_t vt = vr.tile(j & 1);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t vb[4];
        ldsm_x4_t(vb, vt + swz<HD>(ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7),
                                   dp * 2 + (lane >> 4)));
        mma16816(o[2 * dp], pa[ks], vb[0], vb[1]);
        mma16816(o[2 * dp + 1], pa[ks], vb[2], vb[3]);
      }
    __syncthreads();
  }
  cp_async_wait<0>();

  // rows with no attendable slot: bf16(1/S) times V summed over all slots
  const float w = round_bf16(1.0f / static_cast<float>(a.s));
  const float* vs = a.vsum + (long long)bk * HD;
  const bool all0 = m0 <= kMasked, all1 = m1 <= kMasked;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    if (r >= nrows) continue;
    const bool all = half ? all1 : all0;
    float* dst = a.out + (((long long)b * a.t + t0 + r / a.g) * heads + h * a.g + r % a.g) * HD;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      const int col = nt * 8 + 2 * t4;
      float2 y = make_float2(o[nt][2 * half], o[nt][2 * half + 1]);
      if (all) y = make_float2(w * vs[col], w * vs[col + 1]);
      *reinterpret_cast<float2*>(dst + col) = y;
    }
  }
}

template <int KIND, int HD>
size_t attn_smem(int ntiles) {
  using R = Ring<KIND, HD, kSlots, kThreads>;
  return (size_t)kRows * HD * 2 + 2 * (size_t)R::kBytes + 2 * kSlots * sizeof(int) +
         ((size_t)ntiles + 1) * sizeof(int);
}

template <int KIND, int HD>
cudaError_t launch(const Args& a, int bkv, cudaStream_t stream) {
  prefill_prep<KIND, HD><<<dim3(a.nchunks, bkv), kPrepThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int total = bkv * HD;
  prefill_vsum<<<(total + 255) / 256, 256, 0, stream>>>(a, total);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t smem = attn_smem<KIND, HD>(a.ntiles);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if ((err = cudaFuncSetAttribute(prefill_attn<KIND, HD>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))) != cudaSuccess)
    return err;
  const int qtiles = (a.t + a.npos - 1) / a.npos;
  prefill_attn<KIND, HD><<<dim3(qtiles, bkv), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t dispatch(const Args& a, int bkv, cudaStream_t stream) {
  switch (a.hd) {
    case 32: return launch<KIND, 32>(a, bkv, stream);
    case 64: return launch<KIND, 64>(a, bkv, stream);
    case 128: return launch<KIND, 128>(a, bkv, stream);
    case 256: return launch<KIND, 256>(a, bkv, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

namespace pattn {

#if IN_PART(0)
cudaError_t launch_bf16(const Args& a, int bkv, cudaStream_t stream) {
  return dispatch<kBf16>(a, bkv, stream);
}
#endif
#if IN_PART(1)
cudaError_t launch_f32(const Args& a, int bkv, cudaStream_t stream) {
  return dispatch<kF32>(a, bkv, stream);
}
#endif
#if IN_PART(2)
cudaError_t launch_int8(const Args& a, int bkv, cudaStream_t stream) {
  return dispatch<kInt8>(a, bkv, stream);
}
#endif
#if IN_PART(3)
cudaError_t launch_int4(const Args& a, int bkv, cudaStream_t stream) {
  return dispatch<kInt4>(a, bkv, stream);
}
#endif

}  // namespace pattn

#if IN_PART(0)
// q: [B, T, KV*G, hd] bf16. k, v: one layer's K and V over S slots (kind 0
// bf16, 1 f32, 2 int8 with k_scale / v_scale a row of S floats per (b, kv
// head), 3 nibble-packed int4 with a row per (b, kv head, group of grp
// lanes)); kv_b / kv_h byte strides, slot rows contiguous; sc_b / sc_r
// scale strides in floats. qpos [B, T], kpos [B, S] int32, valid [B, S]
// bool, all contiguous. Scratch: keff int32 [B, ntiles * 32], tmin int32
// [B, ntiles], vpart f32 [nchunks, B*KV, hd], vsum f32 [B*KV, hd], with
// ntiles = ceil(S / 32), nchunks = ceil(S / 256). out: [B, T, KV*G*hd] f32.
extern "C" int prefill_attention(const void* q, const void* k, const void* v,
                                 const void* k_scale, const void* v_scale, const void* qpos,
                                 const void* kpos, const void* valid, void* keff, void* tmin,
                                 void* vpart, void* vsum, void* out, int kind, int b, int kvh,
                                 int g, int t, int s, int hd, int grp, long long kv_b,
                                 long long kv_h, long long sc_b, long long sc_r, float scale,
                                 void* stream) {
  if (g < 1 || g > kRows || t < 1 || s < 1 || b * kvh > 65535 || b < 1 || kvh < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const unsigned char*>(k);
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
  a.out = static_cast<float*>(out);
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
  a.ntiles = (s + kSlots - 1) / kSlots;
  a.nchunks = (s + kPrepSlots - 1) / kPrepSlots;
  a.npos = kRows / g;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (kind) {
    case kBf16: err = pattn::launch_bf16(a, b * kvh, st); break;
    case kF32: err = pattn::launch_f32(a, b * kvh, st); break;
    case kInt8: err = pattn::launch_int8(a, b * kvh, st); break;
    case kInt4: err = pattn::launch_int4(a, b * kvh, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
#endif  // IN_PART(0)
