// Second pass of the dense searches and of the segment top-k: merge the
// per-block partial top-k lists of each query into its final list.
#pragma once

#include "common.cuh"

// Widest running list the dense kernels keep per query (the coarse
// quantizer's nprobe; the rerank pool is 32).
#define MAX_KP 256

// Partial lists a lane of the merge walks: nparts <= 32 * MERGE_LISTS.
#define MERGE_LISTS 32

// One warp per query: a k-way merge. part_v/part_i hold nparts lists of kp
// entries per query ([nparts, nq, kp]), each sorted best first by
// topk_better, with empty slots (-inf, INT_MAX) at its tail. Lane l owns
// lists l, l + 32, ...; its candidate is the best head among them. k_out
// times, a butterfly over the total order (score desc, id asc, lane asc)
// gives every lane the same winner, lane 0 writes it, and the winning lane
// steps past it in its list and rescans its heads. Only the entries that
// reach the output (plus one head per list) are read, whatever kp is.
// Empty slots come out as (empty_v, -1).
static __global__ void merge_partial_topk_kernel(
    const float* __restrict__ part_v, const int* __restrict__ part_i,
    int nparts, int nq, int kp, int k_out, float* __restrict__ out_v,
    int* __restrict__ out_i, float empty_v) {
  const int q = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (q >= nq) return;  // the whole warp
  const int nl = lane < nparts ? (nparts - lane + 31) / 32 : 0;  // this lane's lists
  int pos[MERGE_LISTS];
  for (int j = 0; j < nl; ++j) pos[j] = 0;
  float bv;
  int bid, bj;
  auto rescan = [&]() {  // the best head over this lane's lists
    bv = -INFINITY;
    bid = INT_MAX;
    bj = -1;
    for (int j = 0; j < nl; ++j) {
      if (pos[j] >= kp) continue;
      const size_t o = ((size_t)(lane + 32 * j) * nq + q) * kp + pos[j];
      const float v = part_v[o];
      const int id = part_i[o];
      if (topk_better(v, id, bv, bid)) {
        bv = v;
        bid = id;
        bj = j;
      }
    }
  };
  rescan();
  for (int i = 0; i < k_out; ++i) {
    float wv = bv;
    int wid = bid, wl = lane;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, wv, off);
      const int oid = __shfl_xor_sync(0xffffffffu, wid, off);
      const int ol = __shfl_xor_sync(0xffffffffu, wl, off);
      if (topk_better(ov, oid, wv, wid) || (ov == wv && oid == wid && ol < wl)) {
        wv = ov;
        wid = oid;
        wl = ol;
      }
    }
    if (!(wv > -INFINITY)) {  // every list is spent: the rest is empty
      if (lane == 0)
        for (int r = i; r < k_out; ++r) {
          out_v[(size_t)q * k_out + r] = empty_v;
          out_i[(size_t)q * k_out + r] = -1;
        }
      return;  // wv is the same in every lane
    }
    if (lane == 0) {
      out_v[(size_t)q * k_out + i] = wv;
      out_i[(size_t)q * k_out + i] = wid;
    }
    if (lane == wl) {
      ++pos[bj];
      rescan();
    }
  }
}

static inline cudaError_t launch_merge_partial_topk(const float* part_v, const int* part_i,
                                                    int nparts, int nq, int kp, int k_out,
                                                    float* out_v, int* out_i,
                                                    cudaStream_t stream,
                                                    float empty_v = -INFINITY) {
  if (nparts < 1 || nparts > 32 * MERGE_LISTS || k_out > kp) return cudaErrorInvalidValue;
  const int threads = 128;  // four queries a block
  const unsigned blocks = (unsigned)(((long long)nq * 32 + threads - 1) / threads);
  merge_partial_topk_kernel<<<blocks, threads, 0, stream>>>(part_v, part_i, nparts, nq, kp,
                                                            k_out, out_v, out_i, empty_v);
  return cudaGetLastError();
}
