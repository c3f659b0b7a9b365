// Row-wise bitonic sort of (int32 key, f32 value) pairs, keys ascending.
//
// Replaces both probing_rag_tpu/ops/pallas_sort.py::_bitonic_kernel (rows up
// to 32K, with k_start and k_stop) and ::_bitonic_wide_kernel (32K to 512K,
// viewed as [B, w]). One network serves every power-of-two width from 2 to
// 8M; the BM25 engine's over-cap rows use the widths above 512K.
//
// Bound on this card: device-memory bandwidth for the stages with a long
// compare distance, shared-memory bandwidth and latency for the rest. The
// network has log2(P) * (log2(P) + 1) / 2 compare-exchange stages. A 32K row
// of pairs is 256 KB, more than one thread block's shared memory (227 KB),
// so no block can hold a whole wide row the way a TPU core's VMEM did.
// Design: rows are cut into tiles of kTile pairs (64 KB of dynamic shared
// memory). Every stage whose distance j is below the tile runs inside one
// launch per tile, all such stages back to back in shared memory; the
// stages with j >= kTile run as one global-memory compare-exchange launch
// each, one thread per pair. For stage k the data goes through device
// memory (log2(k) - log2(kTile)) + 1 times instead of log2(k) times.
//
// k_start skips the passes below k_start: the caller guarantees every
// aligned (k_start / 2)-wide block is already sorted, ascending at even
// block index and descending at odd. k_stop ends the network after stage
// k_stop: every aligned k_stop-wide block then comes out sorted, ascending
// at even block index and descending at odd, which is the k_start =
// 2 * k_stop precondition of a later, wider sort (the BM25 over-cap short
// tail takes k_stop = 1024, inside the in-tile stages). Equal keys never
// swap, as in the Pallas network, so every stage makes the Pallas kernel's
// swaps.
//
// Rows are read and written with their own row strides (ld_in, ld_out), so
// a sort can run on a column range of a wider buffer, and in place.

#include "common.cuh"

namespace {

constexpr int kTile = 8192;
constexpr int kTileThreads = 1024;
constexpr int kGlobalThreads = 256;

__device__ __forceinline__ long long pair_lo(long long q, long long j) {
  return ((q & ~(j - 1)) << 1) | (q & (j - 1));
}

// Stages k = k_lo .. k_hi (doubling), each with j from min(k / 2, tile / 2)
// down to 1, on one tile of one row in shared memory.
// In place when in and out are the same rows: a block reads its whole tile
// before it writes any of it.
__global__ void bitonic_tile_kernel(const int* in_k, const float* in_v,
                                    int* out_k, float* out_v, int row0,
                                    long long ld_in, long long ld_out,
                                    int tile, long long k_lo, long long k_hi) {
  extern __shared__ unsigned char smem[];
  int* sk = reinterpret_cast<int*>(smem);
  float* sv = reinterpret_cast<float*>(sk + tile);
  const long long row = row0 + blockIdx.y;
  const long long base = static_cast<long long>(blockIdx.x) * tile;
  const long long off_in = row * ld_in + base;
  const long long off = row * ld_out + base;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    sk[i] = in_k[off_in + i];
    sv[i] = in_v[off_in + i];
  }
  __syncthreads();
  for (long long k = k_lo; k <= k_hi; k <<= 1) {
    long long j = k / 2 < tile / 2 ? k / 2 : tile / 2;
    for (; j >= 1; j >>= 1) {
      for (int q = threadIdx.x; q < tile / 2; q += blockDim.x) {
        const int lo = static_cast<int>(pair_lo(q, j));
        const int hi = lo + static_cast<int>(j);
        const bool asc = ((base + lo) & k) == 0;
        const int a = sk[lo];
        const int b = sk[hi];
        if (asc ? a > b : a < b) {
          sk[lo] = b;
          sk[hi] = a;
          const float t = sv[lo];
          sv[lo] = sv[hi];
          sv[hi] = t;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    out_k[off + i] = sk[i];
    out_v[off + i] = sv[i];
  }
}

// One stage (k, j) over whole rows in device memory, one thread per pair;
// in place when in and out are the same rows (a thread writes only the pair
// it read).
__global__ void bitonic_global_kernel(const int* in_k, const float* in_v,
                                      int* out_k, float* out_v, int row0,
                                      long long p, long long ld_in,
                                      long long ld_out, long long k,
                                      long long j) {
  const long long q =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (q >= p / 2) return;
  const long long row = row0 + blockIdx.y;
  const long long lo = pair_lo(q, j);
  const long long hi = lo + j;
  const bool asc = (lo & k) == 0;
  const long long oi = row * ld_in;
  const long long o = row * ld_out;
  const int a = in_k[oi + lo];
  const int b = in_k[oi + hi];
  const float va = in_v[oi + lo];
  const float vb = in_v[oi + hi];
  const bool swap = asc ? a > b : a < b;
  out_k[o + lo] = swap ? b : a;
  out_k[o + hi] = swap ? a : b;
  out_v[o + lo] = swap ? vb : va;
  out_v[o + hi] = swap ? va : vb;
}

}  // namespace

// in_* and out_* are [q, p] device arrays with row strides ld_in and ld_out
// (elements); p a power of two, k_start and k_stop powers of two with
// k_start <= min(k_stop, p). The result lands in out_*, which may be in_*
// itself. The first launch reads in_*, every later one works in place on
// out_*.
extern "C" int bitonic_sort_pairs(const void* in_k, const void* in_v,
                                  void* out_k, void* out_v, int q,
                                  long long p, long long ld_in,
                                  long long ld_out, long long k_start,
                                  long long k_stop, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // above 48 KB, dynamic shared memory must be opted into (per device)
  const cudaError_t attr = cudaFuncSetAttribute(
      bitonic_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kTile * 8);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int tile = static_cast<int>(p < kTile ? p : kTile);
  const int tile_threads = tile / 2 < kTileThreads ? tile / 2 : kTileThreads;
  const size_t smem = static_cast<size_t>(tile) * 8;
  const long long k_last = k_stop < p ? k_stop : p;
  int* ok = static_cast<int*>(out_k);
  float* ov = static_cast<float*>(out_v);
  for (int row0 = 0; row0 < q; row0 += MAX_GRID_Y) {
    const int rows = q - row0 < MAX_GRID_Y ? q - row0 : MAX_GRID_Y;
    const int* rk = static_cast<const int*>(in_k);
    const float* rv = static_cast<const float*>(in_v);
    long long ld = ld_in;
    if (k_start <= tile) {
      dim3 grid(static_cast<unsigned>(p / tile), rows);
      bitonic_tile_kernel<<<grid, tile_threads, smem, st>>>(
          rk, rv, ok, ov, row0, ld, ld_out, tile, k_start,
          k_last < tile ? k_last : tile);
      rk = ok;
      rv = ov;
      ld = ld_out;
    }
    const long long k0 = k_start > 2LL * tile ? k_start : 2LL * tile;
    for (long long k = k0; k <= k_last; k <<= 1) {
      for (long long j = k / 2; j >= tile; j >>= 1) {
        dim3 grid(static_cast<unsigned>((p / 2 + kGlobalThreads - 1) /
                                        kGlobalThreads),
                  rows);
        bitonic_global_kernel<<<grid, kGlobalThreads, 0, st>>>(
            rk, rv, ok, ov, row0, p, ld, ld_out, k, j);
        rk = ok;
        rv = ov;
        ld = ld_out;
      }
      dim3 grid(static_cast<unsigned>(p / tile), rows);
      bitonic_tile_kernel<<<grid, tile_threads, smem, st>>>(
          rk, rv, ok, ov, row0, ld, ld_out, tile, k, k);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
