// Shared helpers for the search kernels.
#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <math.h>
#include <stdint.h>

// Widest top-k the segment kernel keeps per row (the JAX package's K_PAD).
#define TOPK_MAX 16

// Largest grid y extent; row loops launch in chunks of this many rows.
#define MAX_GRID_Y 65535

// Ranking order of BM25 candidates: score descending, then doc id
// ascending. An empty slot is (-inf, INT_MAX), which every real candidate
// beats.
__device__ __forceinline__ bool topk_better(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia < ib);
}

// Insert (v, id) into the descending list vals/ids of capacity k that holds
// n entries, the rest empty; n grows until the list is full. The walk
// starts at the last filled slot, which matters for long lists.
__device__ __forceinline__ void topk_insert(float* vals, int* ids, int k, int& n, float v,
                                            int id) {
  int p;
  if (n < k) {
    p = n++;
  } else {
    if (!topk_better(v, id, vals[k - 1], ids[k - 1])) return;
    p = k - 1;
  }
  while (p > 0 && topk_better(v, id, vals[p - 1], ids[p - 1])) {
    vals[p] = vals[p - 1];
    ids[p] = ids[p - 1];
    --p;
  }
  vals[p] = v;
  ids[p] = id;
}

// The (v, id) pairs of a list entry 32 s + lane, s < m, held by one lane of
// a warp: the widest list (256) in 8 slots.
constexpr int WARP_LIST_SLOTS = 8;
// Lists of one slot take candidates 32 at a time from this many on.
constexpr int WARP_BATCH_MIN = 8;

// Entry 32 sl + ll of a list held in a warp's registers, in every lane.
__device__ __forceinline__ void warp_list_entry(const float (&v)[WARP_LIST_SLOTS],
                                                const int (&id)[WARP_LIST_SLOTS], int sl, int ll,
                                                float& ev, int& ei) {
  float x = 0.0f;
  int xi = 0;
#pragma unroll
  for (int s = 0; s < WARP_LIST_SLOTS; ++s)
    if (s == sl) {
      x = v[s];
      xi = id[s];
    }
  ev = __shfl_sync(0xffffffffu, x, ll);
  ei = __shfl_sync(0xffffffffu, xi, ll);
}

// Warp-wide batch insertion: the n candidates cand[0], cand[stride], ..
// (key bits, id; shared memory, read by every lane) into the descending
// list vals/ids of kp <= 32 * WARP_LIST_SLOTS entries (empty slots (-inf,
// INT_MAX)), the same list topk_insert would leave. The list stays in
// registers during the batch, lane l holding entries l, l + 32, ...; a
// candidate that does not beat the kp-th entry costs one comparison, one
// that does costs a count of the entries above it (one reduction) and a
// one-place shift of those below (shuffles). Returns the kp-th entry in
// (last_v, last_i).
__device__ __forceinline__ void warp_insert(float* vals, int* ids, int kp, const int2* cand,
                                            int stride, int n, int lane, float& last_v,
                                            int& last_i) {
  const int m = (kp + 31) / 32, sl = (kp - 1) / 32, ll = (kp - 1) % 32;
  float v[WARP_LIST_SLOTS];
  int id[WARP_LIST_SLOTS];
#pragma unroll
  for (int s = 0; s < WARP_LIST_SLOTS; ++s) {
    const int j = 32 * s + lane;
    v[s] = j < kp ? vals[j] : -INFINITY;
    id[s] = j < kp ? ids[j] : INT_MAX;
  }
  warp_list_entry(v, id, sl, ll, last_v, last_i);
  // a list of one slot takes candidates 32 at a time while they are many:
  // the 32 sorted across the lanes, then merged with the list (each lane
  // keeps the better of its entry and the batch's 31 - lane-th, a bitonic
  // sequence holding the best 32, which a bitonic merge puts in order)
  int c = 0;
  if (m == 1) {
    for (; n - c >= WARP_BATCH_MIN; c += 32) {
      float bv = -INFINITY;
      int bi = INT_MAX;
      if (c + lane < n) {
        const int2 e = cand[(c + lane) * stride];
        bv = __int_as_float(e.x);
        bi = e.y;
      }
      if (!__any_sync(0xffffffffu, topk_better(bv, bi, last_v, last_i))) continue;
#pragma unroll
      for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
        for (int j = k >> 1; j > 0; j >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv, j);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, j);
          // descending where lane & k is 0: there the lower lane keeps the better
          const bool keep_better = ((lane & j) == 0) == ((lane & k) == 0);
          if (keep_better ? topk_better(ov, oi, bv, bi) : topk_better(bv, bi, ov, oi)) {
            bv = ov;
            bi = oi;
          }
        }
      }
      const float rv_ = __shfl_sync(0xffffffffu, bv, 31 - lane);
      const int ri_ = __shfl_sync(0xffffffffu, bi, 31 - lane);
      if (topk_better(rv_, ri_, v[0], id[0])) {
        v[0] = rv_;
        id[0] = ri_;
      }
#pragma unroll
      for (int j = 16; j > 0; j >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v[0], j);
        const int oi = __shfl_xor_sync(0xffffffffu, id[0], j);
        if ((lane & j) == 0 ? topk_better(ov, oi, v[0], id[0]) : topk_better(v[0], id[0], ov, oi)) {
          v[0] = ov;
          id[0] = oi;
        }
      }
      if (lane >= kp) {  // past the list: empty again
        v[0] = -INFINITY;
        id[0] = INT_MAX;
      }
      warp_list_entry(v, id, sl, ll, last_v, last_i);
    }
  }
  for (; c < n; ++c) {
    const int2 e = cand[c * stride];
    const float cv = __int_as_float(e.x);
    if (!topk_better(cv, e.y, last_v, last_i)) continue;  // the same in every lane
    int above = 0;
#pragma unroll
    for (int s = 0; s < WARP_LIST_SLOTS; ++s)
      if (s < m && 32 * s + lane < kp && topk_better(v[s], id[s], cv, e.y)) ++above;
    const int pos = __reduce_add_sync(0xffffffffu, above);
    // entry j > pos takes entry j - 1, from the lane before (lane 0: lane 31
    // of the slot before); slots from the last, so each reads old entries
#pragma unroll
    for (int s = WARP_LIST_SLOTS - 1; s >= 0; --s) {
      if (s >= m) continue;
      float uv = __shfl_up_sync(0xffffffffu, v[s], 1);
      int ui = __shfl_up_sync(0xffffffffu, id[s], 1);
      const int sp = s > 0 ? s - 1 : 0;  // slot s - 1 (s = 0: lane 0 is never shifted)
      const float wv = __shfl_sync(0xffffffffu, v[sp], 31);
      const int wi = __shfl_sync(0xffffffffu, id[sp], 31);
      if (lane == 0) {
        uv = wv;
        ui = wi;
      }
      const int j = 32 * s + lane;
      if (j > pos) {
        v[s] = uv;
        id[s] = ui;
      } else if (j == pos) {
        v[s] = cv;
        id[s] = e.y;
      }
    }
    warp_list_entry(v, id, sl, ll, last_v, last_i);
  }
#pragma unroll
  for (int s = 0; s < WARP_LIST_SLOTS; ++s) {
    const int j = 32 * s + lane;
    if (j < kp) {
      vals[j] = v[s];
      ids[j] = id[s];
    }
  }
}

// Each lane of a warp inserts up to m of its candidates cand[j * stride]
// (j < m; key bits, id) into its own descending list of k <= K entries at
// vals[p * stride]: the list is walked in registers, K compare-and-swap
// steps a candidate, the lanes in step (a candidate that beats no lane's
// k-th entry is skipped by all). Returns the k-th entry's score. A lane
// with owner false walks in step with m = 0 and writes nothing back, so a
// lane past the last column may alias that column's list.
template <int K>
__device__ __forceinline__ float lane_insert(float* vals, int* ids, int k, int stride,
                                             const int2* cand, int m, bool owner) {
  float lv[K];
  int li[K];
#pragma unroll
  for (int p = 0; p < K; ++p) {
    lv[p] = p < k ? vals[p * stride] : -INFINITY;
    li[p] = p < k ? ids[p * stride] : INT_MAX;
  }
  float last = -INFINITY;
  int last_i = INT_MAX;
#pragma unroll
  for (int p = 0; p < K; ++p)
    if (p == k - 1) {
      last = lv[p];
      last_i = li[p];
    }
  const int mw = __reduce_max_sync(0xffffffffu, m);
  for (int j = 0; j < mw; ++j) {
    float cv = -INFINITY;
    int ci = INT_MAX;
    if (j < m) {
      const int2 e = cand[j * stride];
      cv = __int_as_float(e.x);
      ci = e.y;
    }
    const bool in = topk_better(cv, ci, last, last_i);
    if (!__any_sync(0xffffffffu, in)) continue;
    if (!in) {
      cv = -INFINITY;
      ci = INT_MAX;
    }
#pragma unroll
    for (int p = 0; p < K; ++p) {
      const bool b = topk_better(cv, ci, lv[p], li[p]);
      const float tv = b ? lv[p] : cv;
      const int ti = b ? li[p] : ci;
      lv[p] = b ? cv : lv[p];
      li[p] = b ? ci : li[p];
      cv = tv;
      ci = ti;
    }
#pragma unroll
    for (int p = 0; p < K; ++p)
      if (p == k - 1) {
        last = lv[p];
        last_i = li[p];
      }
  }
#pragma unroll
  for (int p = 0; p < K; ++p)
    if (owner && p < k) {
      vals[p * stride] = lv[p];
      ids[p * stride] = li[p];
    }
  return last;
}

// Port of probing_rag_tpu/ops/pallas_dense.py::topk_merge_tile for one
// candidate: insert (v, id) into the full descending list vals/ids of
// length k if it ranks above the current k-th entry.
__device__ __forceinline__ void topk_merge_tile(float* vals, int* ids, int k,
                                                float v, int id) {
  int n = k;
  topk_insert(vals, ids, k, n, v, id);
}

// 16 (or 8) bytes of a row from byte offset off; bytes at or past row_bytes
// read as zero, so a row length that is not a whole number of vectors
// contributes nothing past its end to a dot product. One vector load when
// the bytes lie inside the row and the address is aligned.
__device__ __forceinline__ uint4 load16_zfill(const void* row, int off, int row_bytes) {
  const unsigned char* p = static_cast<const unsigned char*>(row) + off;
  if (off + 16 <= row_bytes && (reinterpret_cast<uintptr_t>(p) & 15) == 0)
    return *reinterpret_cast<const uint4*>(p);
  __align__(16) unsigned char b[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) b[i] = off + i < row_bytes ? p[i] : 0;
  return *reinterpret_cast<const uint4*>(b);
}

__device__ __forceinline__ uint2 load8_zfill(const void* row, int off, int row_bytes) {
  const unsigned char* p = static_cast<const unsigned char*>(row) + off;
  if (off + 8 <= row_bytes && (reinterpret_cast<uintptr_t>(p) & 7) == 0)
    return *reinterpret_cast<const uint2*>(p);
  __align__(8) unsigned char b[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) b[i] = off + i < row_bytes ? p[i] : 0;
  return *reinterpret_cast<const uint2*>(b);
}

// The loads above when TAIL; plain vector loads when the caller knows the
// bytes lie inside the row and are aligned (whole 64-deep steps).
template <bool TAIL>
__device__ __forceinline__ uint4 vload16(const void* row, int off, int row_bytes) {
  if constexpr (TAIL) return load16_zfill(row, off, row_bytes);
  return *reinterpret_cast<const uint4*>(static_cast<const unsigned char*>(row) + off);
}

template <bool TAIL>
__device__ __forceinline__ uint2 vload8(const void* row, int off, int row_bytes) {
  if constexpr (TAIL) return load8_zfill(row, off, row_bytes);
  return *reinterpret_cast<const uint2*>(static_cast<const unsigned char*>(row) + off);
}

