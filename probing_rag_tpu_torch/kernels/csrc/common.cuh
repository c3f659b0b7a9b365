// Shared helpers for the BM25 search kernels.
#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <math.h>

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

// Port of probing_rag_tpu/ops/pallas_dense.py::topk_merge_tile for one
// candidate: insert (v, id) into the descending list vals/ids of length k if
// it ranks above the current k-th entry.
__device__ __forceinline__ void topk_merge_tile(float* vals, int* ids, int k,
                                                float v, int id) {
  if (!topk_better(v, id, vals[k - 1], ids[k - 1])) return;
  int p = k - 1;
  while (p > 0 && topk_better(v, id, vals[p - 1], ids[p - 1])) {
    vals[p] = vals[p - 1];
    ids[p] = ids[p - 1];
    --p;
  }
  vals[p] = v;
  ids[p] = id;
}
