// K8 segment_reduce: the groups of the sorted scan strategy, from the
// rows in sorted order.
//
// Replaces sybil_tpu/ops/scan.py:_scan_sorted 1106-1233: the sorted row
// index and its matched flag (the sign bit of K7's idxm), the sorted key
// matrix kmat [R, K] (SENTINEL for unmatched rows), the segment
// boundaries (the packed key, or any key lane, differs from the row
// before), gid = their inclusive prefix count - 1, num_groups = gid[R-1]
// + 1 (the sentinel segment of unmatched rows included), the key table
// [S, K] at the segment starts (0 past num_groups), and per group below
// the cap S the exact sums of the lanes [w, 1, (exists, kw, kw*(v-bias))
// x A] of _agg_row_data, read from the columns at the sorted rows and
// never materialised, and the min/max of each histogram aggregation's
// kept values (+2^62 / -2^62 when none).  Rows of groups past the cap go
// to the dead slot S, which adds nothing.
//
// With D distinct columns (1191-1198; the lanes are unpacked, the D
// distinct lanes follow the K group lanes in K7's [K + D, R]) it also
// writes dmat [R, D], the sorted distinct lanes (kmat beside it holds the
// group lanes, so [kmat | dmat] is the reference's sorted_keys), and
// pair_mask [R]: a matched row that starts a new (group, distinct) tuple,
// row 0 included.  Groups still break on the K group lanes only.
//
// The sorted order is row base[p[i]] (p[i] without a base), p the last
// stable sort's indices.  With a packed key (sort_pack) the keys of a
// sorted row are decoded from its packed key (digit d > 0 is d - 1 + min;
// digit 0 is MISSING when min is 0); a digit 0 of a key with min != 0
// (MISSING, or a value of min - 1 that the bound does not flag), and the
// spilled rows, which sort under the sentinel with the unmatched ones,
// gather their keys from the columns, as the reference's `k[sidx]` does
// for every row.  A query-cache group scan's cache-group key (vg_span >
// 0, lane 0; cg_key, 405-411) is made from the row's block position,
// (r >> log2C) / vg_span, as K7 makes it; unpacked, K7's lanes carry it
// into kmat and the key table like any key.
//
// Bound: memory.  Per row: p and base, the random gathers of idxm, the
// key lanes (unpacked) and the aggregation and weight columns at the
// sorted row, and kmat, sidxm and gid written.  Design, four launches:
//   1. gather: sidxm and kmat (and dmat) per sorted row (grid-stride);
//   2. count:  each CTA counts the boundaries of its TILE-row tile;
//   3. scan:   one CTA turns the counts into exclusive offsets and
//              writes num_groups;
//   4. reduce: each CTA walks its tile 256 rows at a time: a block scan
//              of the boundaries gives each row's gid; boundary rows
//              write the key table; the lanes are summed per warp run of
//              equal gids (rows of a group are contiguous after the sort)
//              with shuffles, and each run's first lane adds its sums to
//              the global [S+1, L] table with one 64-bit atomic per lane,
//              so a warp of one group issues one atomic, not 32.  All sums
//              are unsigned 64-bit, wrapping mod 2^64 like the reference's
//              int64 nibble sums.  Min/max: signed 64-bit atomics after a
//              warp-run min/max, skipped when the value cannot move the
//              bound.  With distinct lanes each row also writes its pair
//              flag from its dmat row and the one before it.

#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "desc.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 4096;
constexpr int SCAN_THREADS = 1024;
constexpr long long BIG = 1ll << 62;
constexpr long long SENTINEL = 0x7fffffffffffffffll;
constexpr unsigned FULL = 0xffffffffu;

}  // namespace

// Mirrored field for field by SegmentReduceArgs in ops/scan.py (ctypes).  The
// per-key and per-aggregation arrays point into the descriptor block
// (desc.cuh): no fixed cap.
struct SegmentReduceArgs {
  Desc desc;
  const long long* p;              // [R] the last sort's indices
  const long long* base;           // [R] permutation before it, or null
  const int* idxm;                 // [R] K7's row index | matched bit
  const void* skey;                // packed: sorted key [R], int32/int64
  const long long* keys;           // unpacked: K7's key lanes [K + D, R]
  const long long* const* key_vals;  // [ngroups] group columns
  const unsigned char* const* key_valid;
  const long long* pack_min;       // [K]
  const long long* pack_card;
  const long long* t_vals;         // time column (has_time)
  const long long* const* agg_vals;  // [naggs]
  const unsigned char* const* agg_valid;
  const long long* agg_dmin;
  const long long* agg_dmax;
  const long long* agg_bias;
  const long long* agg_mm;         // min/max column of each agg, -1 = none
  const long long* w_vals;
  const unsigned char* w_valid;
  long long* kmat;                 // [R, K]
  long long* dmat;                 // [R, D] sorted distinct lanes, or null
  unsigned char* pair_mask;        // [R] (D > 0), or null
  int* sidxm;                      // [R]
  int* gid;                        // [R]
  unsigned long long* sums;        // [S+1, L]
  long long* mins;                 // [S, H]
  long long* maxs;                 // [S, H]
  long long* keys_tbl;             // [S, K]
  long long* num_groups;           // [1]
  int* offsets;                    // [ntiles + 1] scratch
  long long R;
  long long tb;                    // time bucket (> 0)
  long long sent;                  // packed sentinel
  int S;
  int L;
  int H;
  int K;
  int ngroups;
  int naggs;
  int ntiles;
  int has_time;
  int time_i32;
  int has_weight;
  int packed;                      // 0 unpacked, 1 int32, 2 int64 key
  int D;                           // distinct lanes (unpacked only)
  int log2C;                       // rows per block, log2
  int vg_span;                     // > 0: lane 0 is the cache-group key
};

namespace {

// The reference's _trunc_div for d > 0 (as in dense_scan.cu).
template <typename T, typename U>
__device__ __forceinline__ T go_trunc_div(T x, T d) {
  const T ax = x < 0 ? static_cast<T>(U(0) - static_cast<U>(x)) : x;
  T q = ax / d;
  if (ax < 0 && q * d != ax) --q;
  return x >= 0 ? q : static_cast<T>(U(0) - static_cast<U>(q));
}

// Key lane k of original row r (as sorted_front.cu computes it).
__device__ __forceinline__ long long key_lane(const SegmentReduceArgs& a,
                                              int k, long long r) {
  if (a.vg_span) {
    if (k == 0)  // vg_span is a power of two
      return r >> (a.log2C + __ffs(a.vg_span) - 1);
    --k;
  }
  if (a.has_time && k == 0) {
    const long long t = a.t_vals[r];
    if (a.time_i32) {
      const int tb = static_cast<int>(a.tb);
      const int q = go_trunc_div<int, unsigned>(static_cast<int>(t), tb);
      return static_cast<int>(static_cast<unsigned>(q) *
                              static_cast<unsigned>(tb));
    }
    const long long q = go_trunc_div<long long, unsigned long long>(t, a.tb);
    return (long long)((unsigned long long)q * (unsigned long long)a.tb);
  }
  const int g = k - a.has_time;
  if (g >= a.ngroups) return 0ll;
  return desc_at(a.desc, a.key_valid, g)[r]
             ? desc_at(a.desc, a.key_vals, g)[r] : -1ll;
}

__device__ __forceinline__ long long sorted_key(const SegmentReduceArgs& a,
                                                long long i) {
  return a.packed == 1 ? (long long)static_cast<const int*>(a.skey)[i]
                       : static_cast<const long long*>(a.skey)[i];
}

__global__ void __launch_bounds__(THREADS) gather_kernel(
    const SegmentReduceArgs a) {
  const int K = a.K;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < a.R;
       i += (long long)gridDim.x * THREADS) {
    const long long j = a.p[i];
    const long long r = a.base ? a.base[j] : j;
    const int m = a.idxm[r];
    a.sidxm[i] = m;
    long long* row = a.kmat + (size_t)i * K;
    if (!a.packed) {
      for (int k = 0; k < K; ++k) row[k] = a.keys[(size_t)k * a.R + r];
      for (int j = 0; j < a.D; ++j)
        a.dmat[(size_t)i * a.D + j] = a.keys[(size_t)(K + j) * a.R + r];
      continue;
    }
    long long x = sorted_key(a, i);
    if (x != a.sent) {
      // a packed key below the sentinel: every digit is in [0, card].
      // Digits 1..card give the key exactly; digit 0 is MISSING (-1) or,
      // when min != 0, possibly a value of min - 1, so that key is read
      // from its column
      for (int k = K - 1; k >= 0; --k) {
        const long long radix = desc_at(a.desc, a.pack_card, k) + 1;
        const long long mn = desc_at(a.desc, a.pack_min, k);
        const long long d = x % radix;
        x /= radix;
        if (d != 0)
          row[k] = (long long)((unsigned long long)d - 1ull +
                               (unsigned long long)mn);
        else
          row[k] = mn == 0 ? -1ll : key_lane(a, k, r);
      }
    } else if (m < 0) {  // spilled: matched, sorted under the sentinel
      for (int k = 0; k < K; ++k) row[k] = key_lane(a, k, r);
    } else {
      for (int k = 0; k < K; ++k) row[k] = SENTINEL;
    }
  }
}

__device__ __forceinline__ bool boundary(const SegmentReduceArgs& a,
                                         long long i) {
  if (i == 0) return true;
  if (a.packed) return sorted_key(a, i) != sorted_key(a, i - 1);
  const long long* row = a.kmat + (size_t)i * a.K;
  for (int k = 0; k < a.K; ++k)
    if (row[k] != row[k - a.K]) return true;
  return false;
}

// Row i starts a new (group, distinct) tuple: a group boundary, or a
// distinct lane that differs from the row before.
__device__ __forceinline__ bool pair_boundary(const SegmentReduceArgs& a,
                                              long long i, bool b) {
  if (b) return true;
  const long long* row = a.dmat + (size_t)i * a.D;
  for (int j = 0; j < a.D; ++j)
    if (row[j] != row[j - a.D]) return true;
  return false;
}

__global__ void __launch_bounds__(THREADS) count_tiles(
    const SegmentReduceArgs a) {
  const long long lo = (long long)blockIdx.x * TILE;
  int n = 0;
  for (int t = threadIdx.x; t < TILE; t += THREADS) {
    const long long i = lo + t;
    if (i < a.R && boundary(a, i)) ++n;
  }
  n = __reduce_add_sync(FULL, n);
  __shared__ int s_n;
  if (threadIdx.x == 0) s_n = 0;
  __syncthreads();
  if ((threadIdx.x & 31) == 0 && n) atomicAdd(&s_n, n);
  __syncthreads();
  if (threadIdx.x == 0) a.offsets[blockIdx.x] = s_n;
}

__global__ void __launch_bounds__(SCAN_THREADS) scan_tiles(
    const SegmentReduceArgs a) {
  int carry = 0;
  for (int base = 0; base < a.ntiles; base += SCAN_THREADS) {
    const int t = base + threadIdx.x;
    const int x = t < a.ntiles ? a.offsets[t] : 0;
    int total;
    const int pre = block_scan<SCAN_THREADS>(x, &total);
    if (t < a.ntiles) a.offsets[t] = carry + pre;
    carry += total;
  }
  if (threadIdx.x == 0) {
    a.offsets[a.ntiles] = carry;
    a.num_groups[0] = carry;
  }
}

// Warp-run reductions: lanes [lane, end] hold the rows of one run; after
// the call the run's first lane holds the run's total.
__device__ __forceinline__ unsigned long long run_sum(unsigned long long x,
                                                      int lane, int end) {
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long y = __shfl_down_sync(FULL, x, d);
    if (lane + d <= end) x += y;
  }
  return x;
}

__device__ __forceinline__ long long run_min(long long x, int lane, int end) {
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_down_sync(FULL, x, d);
    if (lane + d <= end && y < x) x = y;
  }
  return x;
}

__device__ __forceinline__ long long run_max(long long x, int lane, int end) {
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_down_sync(FULL, x, d);
    if (lane + d <= end && y > x) x = y;
  }
  return x;
}

__global__ void __launch_bounds__(THREADS) reduce_kernel(
    const SegmentReduceArgs a) {
  const long long lo = (long long)blockIdx.x * TILE;
  const int lane = threadIdx.x & 31;
  const int S = a.S, L = a.L, H = a.H, K = a.K;
  int run = a.offsets[blockIdx.x];  // boundaries before this row block
  for (int t0 = 0; t0 < TILE && lo + t0 < a.R; t0 += THREADS) {
    const long long i = lo + t0 + threadIdx.x;
    const bool in = i < a.R;
    const int b = in && boundary(a, i);
    int total;
    const int pre = block_scan<THREADS>(b, &total);
    const int gid = run + pre + b - 1;
    run += total;
    int m = 0;
    if (in) {
      a.gid[i] = gid;
      m = a.sidxm[i];
      if (a.D) a.pair_mask[i] = m < 0 && pair_boundary(a, i, b);
      if (b && gid < S)
        for (int k = 0; k < K; ++k)
          a.keys_tbl[(size_t)gid * K + k] = a.kmat[(size_t)i * K + k];
    }
    const bool contrib = in && m < 0 && gid < S;
    const long long r = m & 0x7fffffff;
    const int cg = contrib ? gid : S;
    // this warp's runs of equal cg
    const int prev = __shfl_up_sync(FULL, cg, 1);
    const unsigned heads = __ballot_sync(FULL, lane == 0 || prev != cg);
    const unsigned after = lane == 31 ? 0u : heads & (FULL << (lane + 1));
    const int end = after ? __ffs(after) - 2 : 31;
    const bool head = (heads >> lane) & 1u;
    const bool add = head && cg < S;
    unsigned long long* row = a.sums + (size_t)cg * L;
    unsigned long long w = 0ull;
    if (contrib)
      w = a.has_weight && a.w_valid[r] ? (unsigned long long)a.w_vals[r] : 1ull;
    unsigned long long x = run_sum(w, lane, end);
    if (add && x) atomicAdd(row, x);
    x = run_sum(contrib ? 1ull : 0ull, lane, end);
    if (add && x) atomicAdd(row + 1, x);
    for (int ai = 0; ai < a.naggs; ++ai) {
      const bool valid = contrib && desc_at(a.desc, a.agg_valid, ai)[r];
      const long long v = valid ? desc_at(a.desc, a.agg_vals, ai)[r] : 0ll;
      const bool keep = valid && !(v > desc_at(a.desc, a.agg_dmax, ai) ||
                                   v < desc_at(a.desc, a.agg_dmin, ai));
      x = run_sum(valid ? 1ull : 0ull, lane, end);
      if (add && x) atomicAdd(row + 2 + 3 * ai, x);
      x = run_sum(keep ? w : 0ull, lane, end);
      if (add && x) atomicAdd(row + 3 + 3 * ai, x);
      const unsigned long long bias =
          (unsigned long long)desc_at(a.desc, a.agg_bias, ai);
      x = run_sum(keep ? w * ((unsigned long long)v - bias) : 0ull, lane,
                  end);
      if (add && x) atomicAdd(row + 4 + 3 * ai, x);
      const int mm = (int)desc_at(a.desc, a.agg_mm, ai);
      if (mm >= 0) {
        const long long mn = run_min(keep ? v : BIG, lane, end);
        const long long mx = run_max(keep ? v : -BIG, lane, end);
        if (add) {
          long long* pmn = a.mins + (size_t)cg * H + mm;
          long long* pmx = a.maxs + (size_t)cg * H + mm;
          if (mn != BIG && mn < *(volatile long long*)pmn) atomicMin(pmn, mn);
          if (mx != -BIG && mx > *(volatile long long*)pmx) atomicMax(pmx, mx);
        }
      }
    }
  }
}

__global__ void fill_bounds(long long* mins, long long* maxs, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    mins[i] = BIG;
    maxs[i] = -BIG;
  }
}

}  // namespace

// Copies the descriptor block, zeroes the sums and the key table and sets
// the min/max tables to their sentinels on `stream`, then runs the four
// launches.  `grid` sizes the grid-stride gather.  Returns cudaError_t.
extern "C" int segment_reduce(const SegmentReduceArgs* args, int grid,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const SegmentReduceArgs& a = *args;
  if (a.R >= (1ll << 31) || a.ntiles != (int)((a.R + TILE - 1) / TILE) ||
      a.K < 1 || (a.D > 0 && (a.packed || !a.dmat || !a.pair_mask)) ||
      a.vg_span < 0 || (a.vg_span & (a.vg_span - 1)))
    return cudaErrorInvalidValue;
  cudaError_t err = desc_upload(a.desc, s);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(
      a.sums, 0, (size_t)(a.S + 1) * a.L * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(a.keys_tbl, 0, (size_t)a.S * a.K * sizeof(long long),
                        s);
  if (err != cudaSuccess) return err;
  const long long mmn = (long long)a.S * a.H;
  if (mmn > 0) {
    fill_bounds<<<(unsigned)((mmn + THREADS - 1) / THREADS), THREADS, 0, s>>>(
        a.mins, a.maxs, mmn);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  gather_kernel<<<grid, THREADS, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  count_tiles<<<a.ntiles, THREADS, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_tiles<<<1, SCAN_THREADS, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  reduce_kernel<<<a.ntiles, THREADS, 0, s>>>(a);
  return cudaGetLastError();
}
