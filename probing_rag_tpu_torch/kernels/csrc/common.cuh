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

