// Row-wise sort of (int32 key, f32 value) pairs, keys ascending: sorted
// tiles in shared memory, then merge passes.
//
// Replaces probing_rag_tpu/ops/pallas_sort.py::_bitonic_kernel (rows up to
// 32K, with k_start and k_stop) and ::_bitonic_wide_kernel (wider rows,
// which the TPU sorts whole in VMEM as a [B, w] view with sublane rolls).
// Every power-of-two width from 2 to 8M; the BM25 engine's over-cap rows use
// the widths above 512K.
//
// Bound on this card: device-memory bandwidth. A row of P pairs is 8P
// bytes and the least traffic is one read and one write of it (16P bytes:
// 0.080 ms for [8, 2M] at 3.35 TB/s); the compare work is a few operations
// a pair a level. A 32K row of pairs is 256 KB, more than a block's shared
// memory (227 KB), so no block holds a wide row the way a TPU core's VMEM
// did, and every level above the tile is a round trip through device
// memory. The number of round trips is what sets the time: the global
// compare-exchange stages of the first port made one per level (45 at
// [8, 2M] from k_start 2048).
//
// Design (the passes are planned by ops/sort.py::sort_schedule):
//  * Tile pass (bitonic_tile_kernel): stages k_start .. T on tiles of T
//    pairs (T = tile, at most kMaxTile) in dynamic shared memory, one read
//    and one write. Each thread takes kItems consecutive pairs and runs
//    the network's stages up to kItems in registers; the stages above
//    merge the sorted runs in shared memory (a diagonal search, then
//    kItems outputs a thread, the next key of each run held in a
//    register), leaving what the network's stage would. (Merging measured
//    2.4-3x faster than the network's compare-exchange steps in shared
//    memory; only tiles under kItems pairs, one thread, run those.) Shared memory has
//    one word of padding every 32 (pad()), so threads 8 or 16 pairs apart
//    hit different banks. Widths up to T end here, as do k_stop <= T
//    (blocks alternate by their index in the row). Below a wider sort every
//    tile comes out ascending (tile_asc).
//  * Merge passes (merge_pass_kernel), one for each doubling of the run
//    length above T: sorted runs of length L merge into runs of 2L with one
//    read and one write of the row. Each block owns 256 x 16 output
//    pairs; one warp finds the block's split of its two input runs (merge
//    path: a search along the diagonal, 32 probes a step), the block loads
//    both windows with 16-byte loads into padded shared memory, each thread
//    finds its own split there and merges 16 pairs into registers, and
//    the block writes its span back through shared memory with 16-byte
//    stores. Ties go to the left run, so the output does not depend on the
//    launch. A first merge above a k_start > T reads each odd input run
//    from its end (the k_start precondition leaves those runs descending);
//    with k_stop < P the last merge writes odd blocks reversed. The passes
//    ping-pong between the output and a scratch pair that the wrapper
//    allocates; the kernel allocates nothing.
//
// Round trips through device memory (tile pass + merge passes, T = 16K;
// at most log2(P / T) + 1): [8, 2M] from k_start 2048: 1 + 7 = 8 (was
// 45); [2, 2M] the same; [1, 8M] from k_start 2: 1 + 9 = 10 (was 66);
// [64, 32K] from k_start 2048: 1 + 1 = 2; [256, 16K]: 1. On the card a
// merge pass takes within 10% of a device copy of the row, so the merge
// passes are at their floor and the tile pass's shared-memory merges are
// the rest (ops/sort.py, chip_smoke.py phase 3 "sort passes").
//
// Rows are read and written with their own row strides (ld_in, ld_out), so
// a sort can run on a column range of a wider buffer, and in place: the
// tile pass reads its whole tile before it writes any of it; a merge pass
// never writes the rows it reads.

#include "common.cuh"

namespace {

constexpr int kMaxTile = 16384;  // 128 KB of pairs
constexpr int kTileThreads = 1024;
constexpr int kItems = 16;       // pairs a thread of the tile pass holds
constexpr int kMergeThreads = 256;
constexpr int kMergeItems = 16;  // pairs a thread of a merge pass writes
constexpr int kMergeSpan = kMergeThreads * kMergeItems;

// Shared-memory slot of element i: one word of padding after every 32, so
// that threads whose elements lie 8 or 16 apart (a merge's reads and
// writes) hit different banks.
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

__host__ __device__ constexpr int padded(int n) { return n + (n >> 5); }

__device__ __forceinline__ void cmp_swap(int& ka, float& va, int& kb, float& vb, bool asc) {
  const bool sw = asc ? ka > kb : ka < kb;
  const int tk = sw ? kb : ka;
  const float tv = sw ? vb : va;
  kb = sw ? ka : kb;
  vb = sw ? va : vb;
  ka = tk;
  va = tv;
}

// The network's stages k_lo .. min(k_hi, kItems) on one thread's kItems
// consecutive pairs in registers, the first at row position g0 (a multiple
// of kItems): below stage kItems every compare stays inside the thread.
__device__ __forceinline__ void register_stages(int (&rk)[kItems], float (&rv)[kItems],
                                                long long g0, int k_lo, int k_hi) {
  const bool up = (g0 & kItems) == 0;  // the direction of stage kItems
#pragma unroll
  for (int k = 2; k <= kItems; k <<= 1) {
    if (k < k_lo || k > k_hi) continue;
#pragma unroll
    for (int j = k >> 1; j >= 1; j >>= 1) {
#pragma unroll
      for (int r = 0; r < kItems; ++r) {
        if (r & j) continue;
        cmp_swap(rk[r], rv[r], rk[r + j], rv[r + j], k < kItems ? (r & k) == 0 : up);
      }
    }
  }
}

// Stage k of the tile pass by merging: the sorted runs of k / 2 in shared
// memory (ascending at even index, descending at odd: the state the
// network leaves after stage k / 2) merge pairwise into runs of k, each
// ascending when ((pos0 + its start) & k) == 0 and descending otherwise,
// as the network's stage k would leave them. Each thread merges kItems
// (<= k) outputs into registers after a diagonal search, holding the next
// key of each run in a register, then writes them back in place.
__device__ __forceinline__ void tile_merge_stage(int* sk, float* sv, int k, long long pos0) {
  const int run = k >> 1;
  const int d0 = threadIdx.x * kItems;
  const int ps = d0 & ~(k - 1);  // the pair of runs this thread's outputs lie in
  const int dd = d0 - ps;        // the thread's first diagonal in the pair
  const int bt = ps + k - 1;     // run b is descending: its x-th smallest is at bt - x
  int lo = dd > run ? dd - run : 0;
  int hi = dd < run ? dd : run;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sk[pad(ps + mid)] > sk[pad(bt - (dd - 1 - mid))]) hi = mid;
    else lo = mid + 1;
  }
  // i, j <= run, so ps + i and bt - j stay inside the pair
  int i = lo, j = dd - lo;
  int ka = sk[pad(ps + i)], kb = sk[pad(bt - j)];
  int rk[kItems];
  float rv[kItems];
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const bool take_a = j >= run || (i < run && ka <= kb);
    rk[r] = take_a ? ka : kb;
    rv[r] = sv[pad(take_a ? ps + i : bt - j)];
    i += take_a;
    j += !take_a;
    if (r + 1 < kItems) {
      const int nk = sk[pad(take_a ? ps + i : bt - j)];
      ka = take_a ? nk : ka;
      kb = take_a ? kb : nk;
    }
  }
  __syncthreads();  // every read of the stage is done
  const bool asc = ((pos0 + ps) & k) == 0;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int at = asc ? d0 + r : bt - dd - r;
    sk[pad(at)] = rk[r];
    sv[pad(at)] = rv[r];
  }
  __syncthreads();
}

// Stages k = k_lo .. k_hi (doubling) on one tile of one row in shared
// memory (padded, see pad()): with kItems pairs a thread, the stages up to
// kItems in registers and those above by merging (tile_merge_stage); a
// tile under kItems pairs (one thread) runs the bitonic network's
// compare-exchange steps. Each leaves every aligned k-block sorted
// in the direction the network gives it. The direction follows the block's
// index in the row, or in the tile when tile_asc (then the last stage, k =
// tile, leaves every tile ascending). The block has tile / items threads.
// In place when in and out are the same rows: a block reads its whole tile
// before it writes any of it.
__global__ void __launch_bounds__(kTileThreads) bitonic_tile_kernel(
    const int* in_k, const float* in_v, int* out_k, float* out_v, int row0,
    long long ld_in, long long ld_out, int tile, int k_lo, int k_hi, int tile_asc) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* sk = reinterpret_cast<int*>(smem);
  float* sv = reinterpret_cast<float*>(sk + padded(tile));
  const long long row = row0 + blockIdx.y;
  const long long base = static_cast<long long>(blockIdx.x) * tile;
  const long long pos0 = tile_asc ? 0 : base;
  const long long off_in = row * ld_in + base;
  const long long off = row * ld_out + base;
  const int items = tile / blockDim.x;  // kItems, or the whole tile below kItems
  {  // every load of the thread in flight at once, coalesced across the block
    int tk[kItems];
    float tv[kItems];
#pragma unroll
    for (int m = 0; m < kItems; ++m) {
      if (m < items) {
        tk[m] = in_k[off_in + threadIdx.x + m * blockDim.x];
        tv[m] = in_v[off_in + threadIdx.x + m * blockDim.x];
      }
    }
#pragma unroll
    for (int m = 0; m < kItems; ++m) {
      if (m < items) {
        sk[pad(threadIdx.x + m * blockDim.x)] = tk[m];
        sv[pad(threadIdx.x + m * blockDim.x)] = tv[m];
      }
    }
  }
  __syncthreads();
  int k = k_lo;
  if (items == kItems && k_lo <= kItems) {
    const int d0 = threadIdx.x * kItems;
    int rk[kItems];
    float rv[kItems];
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      rk[r] = sk[pad(d0 + r)];
      rv[r] = sv[pad(d0 + r)];
    }
    register_stages(rk, rv, pos0 + d0, k_lo, k_hi);
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      sk[pad(d0 + r)] = rk[r];
      sv[pad(d0 + r)] = rv[r];
    }
    __syncthreads();
    k = 2 * kItems;
  }
  for (; k <= k_hi; k <<= 1) {
    if (k > kItems) {  // then items == kItems
      tile_merge_stage(sk, sv, k, pos0);
      continue;
    }
    for (int j = k >> 1; j >= 1; j >>= 1) {
      for (int q = threadIdx.x; q < tile / 2; q += blockDim.x) {
        const int lo = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        const int hi = lo + j;
        const bool asc = ((pos0 + lo) & k) == 0;
        const int a = sk[pad(lo)];
        const int b = sk[pad(hi)];
        if (asc ? a > b : a < b) {
          sk[pad(lo)] = b;
          sk[pad(hi)] = a;
          const float t = sv[pad(lo)];
          sv[pad(lo)] = sv[pad(hi)];
          sv[pad(hi)] = t;
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    if (m < items) {
      out_k[off + threadIdx.x + m * blockDim.x] = sk[pad(threadIdx.x + m * blockDim.x)];
      out_v[off + threadIdx.x + m * blockDim.x] = sv[pad(threadIdx.x + m * blockDim.x)];
    }
  }
}

// The merge-path split of one diagonal: how many of the first `diag`
// outputs of merging sorted runs a and b (each `run` long; b read from its
// end when b_desc) come from a, ties taken from a first. That is the
// smallest i in [max(0, diag - run), min(diag, run)] with
// a[i] > b[diag - 1 - i]. The whole warp searches: 32 probes a step shrink
// the range 33-fold. Every lane returns the same split.
__device__ long long merge_split_warp(const int* a, const int* b, long long run,
                                      bool b_desc, long long diag) {
  const int lane = threadIdx.x & 31;
  long long lo = diag > run ? diag - run : 0;
  long long hi = diag < run ? diag : run;  // the split is in [lo, hi]
  while (lo < hi) {
    const long long n = hi - lo;
    const long long pos = lo + n * (lane + 1) / 33;  // in [lo, hi)
    const long long j = diag - 1 - pos;
    const int bj = b_desc ? b[run - 1 - j] : b[j];
    const unsigned m = __ballot_sync(0xffffffffu, a[pos] > bj);
    if (m) {  // the first probe that holds bounds the split from above
      const int f = __ffs(m) - 1;
      const long long new_hi = lo + n * (f + 1) / 33;
      if (f > 0) lo = lo + n * f / 33 + 1;
      hi = new_hi;
    } else {
      lo = lo + n * 32 / 33 + 1;
    }
  }
  return lo;
}

// One merge level: the sorted runs of length `run` at index 2m and 2m + 1
// of each row merge into output run m (ascending; descending at odd m when
// rev_odd). With desc_odd, each odd input run is stored descending. Block
// x covers the outputs [x * kMergeSpan, (x + 1) * kMergeSpan) of its row
// (2 * run is a multiple of kMergeSpan). Shared memory is padded as the
// tile pass's (pad()). With VEC, rows and strides are whole
// 16-byte vectors and device memory moves 16 bytes a thread; else 4.
template <bool VEC>
__global__ void __launch_bounds__(kMergeThreads) merge_pass_kernel(
    const int* __restrict__ in_k, const float* __restrict__ in_v,
    int* __restrict__ out_k, float* __restrict__ out_v, int row0,
    long long ld_in, long long ld_out, long long run, int desc_odd,
    int rev_odd) {
  // both windows, each rounded out to whole 16-byte vectors
  __shared__ int sk[padded(kMergeSpan + 16)];
  __shared__ float sv[padded(kMergeSpan + 16)];
  __shared__ long long split[2];
  const long long row = row0 + blockIdx.y;
  const long long d0 = static_cast<long long>(blockIdx.x) * kMergeSpan;
  const long long pair = d0 / (2 * run);
  const long long base = pair * 2 * run;  // run a starts here, run b at + run
  const long long dd = d0 - base;         // the block's first diagonal
  const int* ak = in_k + row * ld_in + base;
  const float* av = in_v + row * ld_in + base;
  const int* bk = ak + run;
  const float* bv = av + run;
  const bool bdesc = desc_odd != 0;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const long long s = merge_split_warp(ak, bk, run, bdesc, dd + warp * kMergeSpan);
    if ((threadIdx.x & 31) == 0) split[warp] = s;
  }
  __syncthreads();
  const long long a0 = split[0], a1 = split[1];
  const long long b0 = dd - a0, b1 = dd + kMergeSpan - a1;
  const int na = static_cast<int>(a1 - a0);
  const int nb = static_cast<int>(b1 - b0);
  // the windows in storage order: a[a0, a1) and b[b0, b1), or b's stored
  // [run - b1, run - b0) when it is read from its end; with VEC, rounded
  // out to whole vectors (they stay inside their runs: run % 4 == 0)
  const long long sb0 = bdesc ? run - b1 : b0;
  const long long wa = VEC ? (a0 & ~3LL) : a0;
  const long long wb = VEC ? (sb0 & ~3LL) : sb0;
  const int la = static_cast<int>((VEC ? ((a1 + 3) & ~3LL) : a1) - wa);
  const int lb = static_cast<int>((VEC ? ((sb0 + nb + 3) & ~3LL) : sb0 + nb) - wb);
  if (VEC) {
#pragma unroll 4
    for (int e = 4 * threadIdx.x; e < la + lb; e += 4 * kMergeThreads) {
      const bool in_a = e < la;
      const long long g = in_a ? wa + e : wb + (e - la);
      const int4 kk = *reinterpret_cast<const int4*>((in_a ? ak : bk) + g);
      const float4 vv = *reinterpret_cast<const float4*>((in_a ? av : bv) + g);
      const int kw[4] = {kk.x, kk.y, kk.z, kk.w};
      const float vw[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sk[pad(e + c)] = kw[c];
        sv[pad(e + c)] = vw[c];
      }
    }
  } else {
    for (int e = threadIdx.x; e < la + lb; e += kMergeThreads) {
      const bool in_a = e < la;
      const long long g = in_a ? wa + e : wb + (e - la);
      sk[pad(e)] = (in_a ? ak : bk)[g];
      sv[pad(e)] = (in_a ? av : bv)[g];
    }
  }
  __syncthreads();

  // a's i-th pair of the window at oa + i; b's j-th (ascending) at cb + sg * j
  const int oa = static_cast<int>(a0 - wa);
  const int cb = la + static_cast<int>((bdesc ? run - 1 - b0 : b0) - wb);
  const int sg = bdesc ? -1 : 1;
  const int d = threadIdx.x * kMergeItems;
  int lo = d > nb ? d - nb : 0;
  int hi = d < na ? d : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sk[pad(oa + mid)] > sk[pad(cb + sg * (d - 1 - mid))]) hi = mid;
    else lo = mid + 1;
  }
  // the next key of each window in a register; a spent window's slot is
  // read (it lies inside the staged windows) but never taken
  int i = lo, j = d - lo;
  int ka = sk[pad(i < na ? oa + i : oa)];
  int kb = sk[pad(j < nb ? cb + sg * j : cb)];
  int rk[kMergeItems];
  float rv[kMergeItems];
#pragma unroll
  for (int r = 0; r < kMergeItems; ++r) {
    const bool take_a = j >= nb || (i < na && ka <= kb);
    rk[r] = take_a ? ka : kb;
    rv[r] = sv[pad(take_a ? oa + i : cb + sg * j)];
    i += take_a;
    j += !take_a;
    if (r + 1 < kMergeItems) {
      const int at = take_a ? (i < na ? oa + i : oa) : (j < nb ? cb + sg * j : cb);
      const int nk = sk[pad(at)];
      ka = take_a ? nk : ka;
      kb = take_a ? kb : nk;
    }
  }
  __syncthreads();  // every window read is done: reuse the buffers for the output
#pragma unroll
  for (int r = 0; r < kMergeItems; ++r) {
    sk[pad(d + r)] = rk[r];
    sv[pad(d + r)] = rv[r];
  }
  __syncthreads();

  // a reversed block lands at [2 run - dd - span, 2 run - dd), backwards
  const bool rev = rev_odd && (pair & 1);
  const long long o0 = row * ld_out + base + (rev ? 2 * run - dd - kMergeSpan : dd);
  if (VEC) {
    for (int u = threadIdx.x; u < kMergeSpan / 4; u += kMergeThreads) {
      int4 kk;
      float4 vv;
      if (rev) {
        const int s = kMergeSpan - 1 - 4 * u;
        kk = make_int4(sk[pad(s)], sk[pad(s - 1)], sk[pad(s - 2)], sk[pad(s - 3)]);
        vv = make_float4(sv[pad(s)], sv[pad(s - 1)], sv[pad(s - 2)], sv[pad(s - 3)]);
      } else {
        const int s = 4 * u;
        kk = make_int4(sk[pad(s)], sk[pad(s + 1)], sk[pad(s + 2)], sk[pad(s + 3)]);
        vv = make_float4(sv[pad(s)], sv[pad(s + 1)], sv[pad(s + 2)], sv[pad(s + 3)]);
      }
      reinterpret_cast<int4*>(out_k + o0)[u] = kk;
      reinterpret_cast<float4*>(out_v + o0)[u] = vv;
    }
  } else {
    for (int w = threadIdx.x; w < kMergeSpan; w += kMergeThreads) {
      const int s = rev ? kMergeSpan - 1 - w : w;
      out_k[o0 + w] = sk[pad(s)];
      out_v[o0 + w] = sv[pad(s)];
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// One tile pass: stages k_lo .. k_hi on tiles of `tile` pairs. in_* and
// out_* are [q, p] device arrays with row strides ld_in and ld_out
// (elements), out_* may be in_* itself; p, tile, k_lo and k_hi powers of
// two with tile <= kMaxTile, tile | p, 2 <= k_lo <= k_hi <= tile.
extern "C" int sort_tile_pass(const void* in_k, const void* in_v, void* out_k,
                              void* out_v, int q, long long p, long long ld_in,
                              long long ld_out, int tile, long long k_lo,
                              long long k_hi, int tile_asc, void* stream) {
  if (tile < 2 || tile > kMaxTile || p % tile || k_lo < 2 || k_lo > k_hi || k_hi > tile)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // above 48 KB, dynamic shared memory must be opted into (per device)
  const cudaError_t attr = cudaFuncSetAttribute(
      bitonic_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, padded(kMaxTile) * 8);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // kItems pairs a thread (fewer when the tile is smaller)
  const int threads = tile <= kItems ? 1 : tile / kItems;
  for (int row0 = 0; row0 < q; row0 += MAX_GRID_Y) {
    const int rows = q - row0 < MAX_GRID_Y ? q - row0 : MAX_GRID_Y;
    dim3 grid(static_cast<unsigned>(p / tile), rows);
    bitonic_tile_kernel<<<grid, threads, static_cast<size_t>(padded(tile)) * 8, st>>>(
        static_cast<const int*>(in_k), static_cast<const float*>(in_v),
        static_cast<int*>(out_k), static_cast<float*>(out_v), row0, ld_in, ld_out,
        tile, static_cast<int>(k_lo), static_cast<int>(k_hi), tile_asc);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// One merge pass over [q, p] rows: runs of length `run` (a power of two,
// 2 * run a multiple of kMergeSpan and a divisor of p) merge pairwise.
// out_* must not overlap in_*.
extern "C" int sort_merge_pass(const void* in_k, const void* in_v, void* out_k,
                               void* out_v, int q, long long p, long long ld_in,
                               long long ld_out, long long run, int desc_odd,
                               int rev_odd, void* stream) {
  if (run < 1 || p % (2 * run) || (2 * run) % kMergeSpan)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = aligned16(in_k) && aligned16(in_v) && aligned16(out_k) &&
                   aligned16(out_v) && ld_in % 4 == 0 && ld_out % 4 == 0;
  const int* ik = static_cast<const int*>(in_k);
  const float* iv = static_cast<const float*>(in_v);
  int* ok = static_cast<int*>(out_k);
  float* ov = static_cast<float*>(out_v);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int row0 = 0; row0 < q; row0 += MAX_GRID_Y) {
    const int rows = q - row0 < MAX_GRID_Y ? q - row0 : MAX_GRID_Y;
    dim3 grid(static_cast<unsigned>(p / kMergeSpan), rows);
    if (vec)
      merge_pass_kernel<true><<<grid, kMergeThreads, 0, st>>>(ik, iv, ok, ov, row0, ld_in,
                                                             ld_out, run, desc_odd, rev_odd);
    else
      merge_pass_kernel<false><<<grid, kMergeThreads, 0, st>>>(ik, iv, ok, ov, row0, ld_in,
                                                              ld_out, run, desc_odd, rev_odd);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
