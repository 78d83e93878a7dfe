// K16 shuffle_reduce: the owner's merge of the rows the mesh exchange
// brought it, and the unpack of the gathered merged tables.
//
// shuffle_keys and shuffle_reduce replace sybil_tpu/parallel/mesh.py:
// _segment_reduce (146-194) for one owner's N = D * Sc received payload
// rows [N, WP] ([keys K | n_sum summed lanes | min per agg | max per agg];
// a row is live when its count or samples word is > 0):
//   shuffle_keys    the sort operands: key k of each row, SENTINEL where
//                   the row is dead, as [K, N];
//   (sorts)         the stable torch.sort passes over them (sort_rows);
//   shuffle_reduce  in sorted order, a segment starts where any key
//                   differs from the previous row's; gid = segments so
//                   far - 1; n_groups = live segment starts; a live row
//                   with gid < cap adds its summed lanes to merged[gid],
//                   and its min/max words into the segment's min/max;
//                   the segment's first row writes its keys.  Merged rows
//                   no row reaches keep keys 0, lanes 0, min INT64_MAX and
//                   max INT64_MIN (what segment_min/max give an empty
//                   segment).  flive[j] = j < min(n_groups, cap), and
//                   stats[0] = n_groups.
// shuffle_unpack replaces the compaction and _unpack_payload (197-227) of
// _sharded_scan (291-305): row i < S of the final table is the gathered
// merged row top[i] (K12's lax.top_k(flive, k) order) for i < k, else
// zero; its count, samples, agg lanes and bucket counts are zeroed unless
// that row is live, its keys and min/max are kept; the split outputs are
// keys [S, K], the lanes [S+1, L] (row S zero: the shape K3 and K10
// read), min and max [S, A] and each histogram aggregation's [S, nv].
// meta = the column sums of the shards' statistics rows [D, 3 + nstat]
// (n_groups, spill, overflow, outlier and hist pair counts), with
// max(n_groups - S, 0) added to the overflow word (the psums of 296-305).
//
// Bound: memory.  Each row's WP words are read once in sorted order (a
// random row gather) and each live segment's words written by one atomic
// per warp run of the segment.  Design (K8's): a tile count of segment
// starts, a one-CTA scan of the counts, then each CTA numbers its rows by
// a block scan, reduces every word over the runs of equal gid in a warp
// by shuffles and lets each run's first lane add it with one atomic.

#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "desc.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 4096;
constexpr int SCAN_THREADS = 1024;
constexpr long long SENTINEL = 0x7fffffffffffffffll;
constexpr long long I64_MIN = -SENTINEL - 1;
constexpr unsigned FULL = 0xffffffffu;

}  // namespace

// Mirrored field for field by ShuffleReduceArgs in ops/scan.py (ctypes).
struct ShuffleReduceArgs {
  const long long* rows;     // [N, WP]
  const long long* p;        // [N] the last sort's indices
  const long long* base;     // [N] the permutation before it, or null
  long long* merged;         // [cap, WP]
  int* flive;                // [cap]
  long long* stats;          // [1]: word 0 of the owner's statistics row
  int* offsets;              // [ntiles + 1] scratch
  long long N;
  int cap;
  int K;
  int n_sum;
  int A;
  int WP;
  int ntiles;
};

// Mirrored field for field by ShuffleUnpackArgs in ops/scan.py (ctypes).
struct ShuffleUnpackArgs {
  Desc desc;
  const long long* flat;           // [Dn, WP] gathered merged rows
  const int* flive;                // [Dn]
  const int* top;                  // [k]
  const long long* stats;          // [D, ncols]
  long long* keys;                 // [S, K]
  long long* sums;                 // [S+1, L]
  long long* mins;                 // [S, A]
  long long* maxs;                 // [S, A]
  long long* const* hist;          // [H] [S, nv_h]
  const long long* hist_nv;        // [H]
  long long* meta;                 // [ncols]
  int k;
  int S;
  int K;
  int L;
  int n_sum;
  int A;
  int H;
  int WP;
  int D;
  int ncols;
};

namespace {

__device__ __forceinline__ long long src_of(const ShuffleReduceArgs& a,
                                            long long i) {
  const long long q = a.p[i];
  return a.base ? a.base[q] : q;
}

__device__ __forceinline__ bool live_row(const ShuffleReduceArgs& a,
                                         long long r) {
  const long long* row = a.rows + r * a.WP;
  return row[a.K] > 0 || row[a.K + 1] > 0;
}

__device__ __forceinline__ long long skey(const ShuffleReduceArgs& a,
                                          long long r, bool live, int k) {
  return live ? a.rows[r * a.WP + k] : SENTINEL;
}

__device__ __forceinline__ bool starts(const ShuffleReduceArgs& a,
                                       long long i, long long r, bool live) {
  if (i == 0) return true;
  const long long q = src_of(a, i - 1);
  const bool ql = live_row(a, q);
  for (int k = 0; k < a.K; ++k)
    if (skey(a, r, live, k) != skey(a, q, ql, k)) return true;
  return false;
}

__global__ void keys_kernel(const long long* rows, long long* keys,
                            long long N, int K, int WP) {
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < N;
       i += (long long)gridDim.x * THREADS) {
    const long long* row = rows + i * WP;
    const bool live = row[K] > 0 || row[K + 1] > 0;
    for (int k = 0; k < K; ++k) keys[(long long)k * N + i] = live ? row[k]
                                                                  : SENTINEL;
  }
}

__global__ void init_kernel(const ShuffleReduceArgs a) {
  const long long n = (long long)a.cap * a.WP;
  for (long long x = (long long)blockIdx.x * THREADS + threadIdx.x; x < n;
       x += (long long)gridDim.x * THREADS) {
    const int c = (int)(x % a.WP);
    const int m = c - a.K - a.n_sum;     // >= 0: a min or max word
    a.merged[x] = m < 0 ? 0 : (m < a.A ? SENTINEL : I64_MIN);
  }
}

__global__ void __launch_bounds__(THREADS) count_kernel(
    const ShuffleReduceArgs a) {
  const long long lo = (long long)blockIdx.x * TILE;
  int n = 0, nlive = 0;
  for (int t = threadIdx.x; t < TILE; t += THREADS) {
    const long long i = lo + t;
    if (i < a.N) {
      const long long r = src_of(a, i);
      const bool live = live_row(a, r);
      if (starts(a, i, r, live)) {
        ++n;
        nlive += live;
      }
    }
  }
  n = __reduce_add_sync(FULL, n);
  nlive = __reduce_add_sync(FULL, nlive);
  __shared__ int s_n;
  if (threadIdx.x == 0) s_n = 0;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    if (n) atomicAdd(&s_n, n);
    if (nlive)
      atomicAdd(reinterpret_cast<unsigned long long*>(a.stats),
                (unsigned long long)nlive);
  }
  __syncthreads();
  if (threadIdx.x == 0) a.offsets[blockIdx.x] = s_n;
}

__global__ void __launch_bounds__(SCAN_THREADS) scan_kernel(
    const ShuffleReduceArgs a) {
  int carry = 0;
  for (int base = 0; base < a.ntiles; base += SCAN_THREADS) {
    const int t = base + threadIdx.x;
    const int x = t < a.ntiles ? a.offsets[t] : 0;
    int total;
    const int pre = block_scan<SCAN_THREADS>(x, &total);
    if (t < a.ntiles) a.offsets[t] = carry + pre;
    carry += total;
  }
  if (threadIdx.x == 0) a.offsets[a.ntiles] = carry;
}

__global__ void live_kernel(const ShuffleReduceArgs a) {
  const long long ng = a.stats[0];
  const long long m = ng < a.cap ? ng : a.cap;
  for (int j = blockIdx.x * THREADS + threadIdx.x; j < a.cap;
       j += gridDim.x * THREADS)
    a.flive[j] = j < m;
}

// Sum (op 0), min (1) or max (2) of x over the lanes of this lane's run
// of equal g at and after it; the run's first lane ends with the run's
// total.
__device__ __forceinline__ long long run_reduce(long long x, int g, int op) {
  const int lane = threadIdx.x & 31;
  for (int off = 1; off < 32; off <<= 1) {
    const long long y = __shfl_down_sync(FULL, x, off);
    const int gy = __shfl_down_sync(FULL, g, off);
    if (lane + off < 32 && gy == g)
      x = op == 0 ? x + y : (op == 1 ? (y < x ? y : x) : (y > x ? y : x));
  }
  return x;
}

__global__ void __launch_bounds__(THREADS) reduce_kernel(
    const ShuffleReduceArgs a) {
  const long long lo = (long long)blockIdx.x * TILE;
  int seg = a.offsets[blockIdx.x];
  const int lane = threadIdx.x & 31;
  for (int t0 = 0; t0 < TILE && lo + t0 < a.N; t0 += THREADS) {
    const long long i = lo + t0 + threadIdx.x;
    long long r = 0;
    bool live = false, first = false;
    if (i < a.N) {
      r = src_of(a, i);
      live = live_row(a, r);
      first = starts(a, i, r, live);
    }
    int nseg;
    const int pre = block_scan<THREADS>(first ? 1 : 0, &nseg);
    const int gid = seg + pre + (first ? 1 : 0) - 1;
    seg += nseg;
    const bool contrib = i < a.N && live && gid < a.cap;
    const int g = contrib ? gid : -1;
    const int gprev = __shfl_up_sync(FULL, g, 1);
    const bool head = contrib && (lane == 0 || gprev != g);
    const long long* row = a.rows + r * a.WP;
    long long* out = a.merged + (long long)(contrib ? gid : 0) * a.WP;
    if (contrib && first)
      for (int k = 0; k < a.K; ++k) out[k] = row[k];
    for (int j = 0; j < a.n_sum; ++j) {
      const long long v = run_reduce(contrib ? row[a.K + j] : 0, g, 0);
      if (head && v)
        atomicAdd(reinterpret_cast<unsigned long long*>(out + a.K + j),
                  (unsigned long long)v);
    }
    for (int m = 0; m < 2 * a.A; ++m) {
      const int op = m < a.A ? 1 : 2;
      const long long id = op == 1 ? SENTINEL : I64_MIN;
      const long long v =
          run_reduce(contrib ? row[a.K + a.n_sum + m] : id, g, op);
      if (head) {
        if (op == 1)
          atomicMin(out + a.K + a.n_sum + m, v);
        else
          atomicMax(out + a.K + a.n_sum + m, v);
      }
    }
  }
}

__global__ void unpack_kernel(const ShuffleUnpackArgs a) {
  const long long n = (long long)(a.S + 1);
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS) {
    long long* lanes = a.sums + i * a.L;
    if (i == a.S) {
      for (int j = 0; j < a.L; ++j) lanes[j] = 0;
      continue;
    }
    const long long src = i < a.k ? a.top[i] : -1;
    const bool live = src >= 0 && a.flive[src] != 0;
    const long long* row = a.flat + (src < 0 ? 0 : src) * a.WP;
    for (int k = 0; k < a.K; ++k) a.keys[i * a.K + k] = src >= 0 ? row[k] : 0;
    for (int j = 0; j < a.L; ++j) lanes[j] = live ? row[a.K + j] : 0;
    int c = a.K + a.L;
    for (int h = 0; h < a.H; ++h) {
      const int nv = (int)desc_at(a.desc, a.hist_nv, h);
      long long* dst = desc_at(a.desc, a.hist, h) + i * nv;
      for (int j = 0; j < nv; ++j) dst[j] = live ? row[c + j] : 0;
      c += nv;
    }
    for (int ai = 0; ai < a.A; ++ai) {
      a.mins[i * a.A + ai] = src >= 0 ? row[a.K + a.n_sum + ai] : 0;
      a.maxs[i * a.A + ai] = src >= 0 ? row[a.K + a.n_sum + a.A + ai] : 0;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (int c = 0; c < a.ncols; ++c) {
      long long s = 0;
      for (int d = 0; d < a.D; ++d) s += a.stats[(long long)d * a.ncols + c];
      a.meta[c] = s;
    }
    if (a.meta[0] > a.S) a.meta[2] += a.meta[0] - a.S;
  }
}

}  // namespace

// keys [K, N] of the rows [N, WP]: row i's key k, SENTINEL when dead.
extern "C" int shuffle_keys(const long long* rows, long long* keys,
                            long long N, int K, int WP, int grid,
                            void* stream) {
  if (N < 1 || K < 1 || WP < K + 2) return cudaErrorInvalidValue;
  keys_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, keys, N, K, WP);
  return cudaGetLastError();
}

// One owner's merge on `stream`: init, tile count, scan, live flags and
// the reduce.  Returns cudaError_t.
extern "C" int shuffle_reduce(const ShuffleReduceArgs* args, int grid,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ShuffleReduceArgs& a = *args;
  if (a.N < 1 || a.N >= (1ll << 31) || a.cap < 1 ||
      a.ntiles != (int)((a.N + TILE - 1) / TILE) ||
      a.WP != a.K + a.n_sum + 2 * a.A)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(a.stats, 0, sizeof(long long), s);
  if (err != cudaSuccess) return err;
  init_kernel<<<grid, THREADS, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  count_kernel<<<a.ntiles, THREADS, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_kernel<<<1, SCAN_THREADS, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  live_kernel<<<(a.cap + THREADS - 1) / THREADS, THREADS, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  reduce_kernel<<<a.ntiles, THREADS, 0, s>>>(a);
  return cudaGetLastError();
}

// The final table's split outputs and the meta sums on `stream`.
extern "C" int shuffle_unpack(const ShuffleUnpackArgs* args, int grid,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ShuffleUnpackArgs& a = *args;
  if (a.S < 1 || a.k < 0 || a.k > a.S || a.ncols < 3 ||
      a.WP < a.K + a.n_sum + 2 * a.A || a.n_sum < a.L)
    return cudaErrorInvalidValue;
  cudaError_t err = desc_upload(a.desc, s);
  if (err != cudaSuccess) return err;
  unpack_kernel<<<grid, THREADS, 0, s>>>(a);
  return cudaGetLastError();
}
