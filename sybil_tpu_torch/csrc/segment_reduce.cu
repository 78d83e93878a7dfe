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
// sorted row, and kmat, sidxm and gid written: 69 B a row at path 2
// (0.1745 ms at 8,388,608 rows on an H100, 3.35 TB/s).
//
// What a trace of the former design showed (torch.profiler on the H100;
// PERF.md §6).  It ran four launches and two memsets: a gather of sidxm
// and kmat, a count of each tile's boundaries that reread kmat, a
// one-CTA scan of the counts, and a reduce that reread kmat and sidxm.
// At path 2 the gather took 239 us, the count 53 and the reduce 195; in
// the pair form (three lanes, every source row random) the gather took
// 1,212 us, one dependent chain of loads a thread at a time; at path 1
// (7 groups) the reduce took 244 us, its atomics a warp run each piling
// onto the same few words.
//
// Design: one launch (after one memset, and fill_bounds when H > 0), a
// CTA per TILE rows, the tile taken from an atomic ticket, so that every
// tile before it has started.
//   A. Gather: a warp takes 128 consecutive sorted rows, 32 consecutive
//      rows an item, so every load and store of a sorted row (p, svals,
//      the packed key; sidxm, kmat, dmat, pair_mask) is coalesced.  It
//      loads its rows' p, then their source rows r, then idxm at r, each
//      stage's ITEMS loads in flight before any store.  Its keys: a
//      packed key's word (a boundary is a change of the word), or each
//      lane gathered at r but lane 0, which the last sort's sorted values
//      hold already (svals).  Each row
//      is compared with the row before it in registers: the previous
//      lane's row or lane 31's of the previous item by a shuffle, or, for
//      the warp's first row, the row before the warp, loaded once more.
//      So kmat and dmat are written once and never read to find a
//      boundary.  The tile's idxm and boundary flags go to shared memory.
//   B. Look-back (Merrill and Garland, "Single-pass Parallel Prefix Scan
//      with Decoupled Look-back", 2016): the CTA publishes its tile's
//      boundary count, warp 0 sums its predecessors' published counts,
//      32 tiles a step, until it meets an inclusive prefix, and
//      publishes its own.  A status word is a flag in its top two bits
//      and the count below, stored with st.release and read with
//      ld.acquire.  No scan launch, no offsets scratch.
//   C. Reduce: a thread takes ITEMS consecutive rows from shared memory;
//      one block scan of the threads' counts gives each row's gid (staged
//      in shared memory, stored coalesced); a boundary row writes the key
//      table from its kmat row (this CTA's write, an L1 or L2 hit); the
//      last tile writes num_groups.
//      Every lane of [w, 1, (exists, kw, kw*(v-bias)) x A] is summed a
//      run at a time in the thread's rows, and the thread's last run is
//      carried across the warp by a segmented scan, so a segment adds to
//      its row of the [S+1, L] table once per warp it touches (one
//      64-bit atomic a lane; 128 rows a warp), not once per warp run.
//      The sums are unsigned 64-bit, wrapping mod 2^64 like the
//      reference's int64 nibble sums.  Min/max: signed 64-bit atomics the
//      same way, skipped when the value cannot move the bound.  Rows of
//      groups at or past S add nothing (the dead slot S stays 0).

#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "desc.cuh"
#include "time_key.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 4;                  // rows a thread
constexpr int TILE = THREADS * ITEMS;     // rows a CTA
constexpr long long BIG = 1ll << 62;
constexpr long long SENTINEL = 0x7fffffffffffffffll;
constexpr unsigned FULL = 0xffffffffu;
// look-back status words: a flag in the top two bits, the count below
constexpr unsigned long long FLAG_AGG = 1ull << 62;
constexpr unsigned long long FLAG_PREFIX = 2ull << 62;
constexpr unsigned long long COUNT_MASK = FLAG_AGG - 1;
// a.paths (optional) counts, for the checks: tiles whose look-back read
// more than one predecessor's word, and more than one window of 32;
// tiles whose first row continues a segment (cut by the tile edge); and
// warps where a lane's first rows continue a run of an earlier lane
enum { P_MULTI, P_DEEP, P_CUT, P_CARRY };

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
  const long long* svals;          // unpacked: lane 0 sorted [R]
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
  unsigned long long* status;      // [1 + ntiles]: the ticket, then a
                                   // status word a tile
  unsigned long long* zero;        // the block the memset clears (sums,
  long long nzero;                 // keys_tbl and status), in words
  unsigned long long* paths;       // [4] path counts (P_*), or null
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

// Key lane k of original row r (as sorted_front.cu computes it).
__device__ __forceinline__ long long key_lane(const SegmentReduceArgs& a,
                                              int k, long long r) {
  if (a.vg_span) {
    if (k == 0)  // vg_span is a power of two
      return r >> (a.log2C + __ffs(a.vg_span) - 1);
    --k;
  }
  if (a.has_time && k == 0) return time_key(a.t_vals[r], a.tb, a.time_i32);
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

// Key lane k (of K + D) of sorted row i, whose source row is r: lane 0
// from the last sort's values, the others gathered.
__device__ __forceinline__ long long sorted_lane(const SegmentReduceArgs& a,
                                                 int k, long long i, int r) {
  return k == 0 ? a.svals[i] : a.keys[(size_t)k * a.R + r];
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// The three reductions of a lane and their atomics: the operation, its
// identity, and the flush of a segment's partial into the table (skipped
// when it cannot change the word).
struct SumOp {
  typedef unsigned long long T;
  unsigned long long* col;  // the lane's word of row 0; rows L apart
  int L;
  __device__ static T identity() { return 0ull; }
  __device__ static T combine(T x, T y) { return x + y; }
  __device__ void flush(int g, T v) const {
    if (v) atomicAdd(col + (size_t)g * L, v);
  }
};

struct MinOp {
  typedef long long T;
  long long* col;  // rows H apart
  int H;
  __device__ static T identity() { return BIG; }
  __device__ static T combine(T x, T y) { return y < x ? y : x; }
  __device__ void flush(int g, T v) const {
    long long* w = col + (size_t)g * H;
    if (v != BIG && v < *(volatile long long*)w) atomicMin(w, v);
  }
};

struct MaxOp {
  typedef long long T;
  long long* col;
  int H;
  __device__ static T identity() { return -BIG; }
  __device__ static T combine(T x, T y) { return y > x ? y : x; }
  __device__ void flush(int g, T v) const {
    long long* w = col + (size_t)g * H;
    if (v != -BIG && v > *(volatile long long*)w) atomicMax(w, v);
  }
};

template <class T>
__device__ __forceinline__ T shfl_up(T v, int d) {
  return __shfl_up_sync(FULL, v, d);
}

// Adds one lane's values x of the thread's ITEMS rows to the table, a
// segment at a time.  bm holds the rows that start a segment, g their
// gids (all threads of the warp call it).  A run that starts and ends in
// the thread is flushed at once; the thread's last run is carried to the
// next lanes by a segmented scan and flushed by the lane where its
// segment ends, or by lane 31; the first run, when the thread's first
// row does not start a segment, joins what the previous lanes carried.
template <class Op>
__device__ __forceinline__ void seg_flush(const Op& op,
                                          const typename Op::T (&x)[ITEMS],
                                          unsigned bm, const int (&g)[ITEMS],
                                          int S, int lane) {
  typedef typename Op::T T;
  T acc = Op::identity(), head = Op::identity();
  const bool open = !(bm & 1u);  // the first run continues a segment
  bool first = true;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    if (k > 0 && ((bm >> k) & 1u)) {
      if (first && open)
        head = acc;
      else if (g[k - 1] < S)
        op.flush(g[k - 1], acc);
      first = false;
      acc = Op::identity();
    }
    acc = Op::combine(acc, x[k]);
  }
  // inclusive segmented scan of the lanes' last runs: a lane that starts
  // a segment restarts it
  T s = acc;
  bool f = bm != 0u;
  for (int d = 1; d < 32; d <<= 1) {
    const T su = shfl_up(s, d);
    const bool fu = __shfl_up_sync(FULL, (int)f, d);
    if (lane >= d) {
      if (!f) s = Op::combine(su, s);
      f = f || fu;
    }
  }
  T carry = shfl_up(s, 1);
  if (lane == 0) carry = Op::identity();
  if (bm != 0u && open && g[0] < S)  // the first run ends in this thread
    op.flush(g[0], Op::combine(carry, head));
  const unsigned next_starts = __shfl_down_sync(FULL, bm & 1u, 1);
  if ((lane == 31 || next_starts) && g[ITEMS - 1] < S)
    op.flush(g[ITEMS - 1], s);
}

__global__ void __launch_bounds__(THREADS, 4) segment_kernel(
    const SegmentReduceArgs a) {
  __shared__ int s_tile;
  __shared__ int s_prefix;
  __shared__ int s_count[THREADS / 32];
  __shared__ int s_m[TILE];            // idxm of the tile's rows, then gid
  __shared__ unsigned char s_b[TILE];  // the rows that start a group
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0)
    s_tile = (int)atomicAdd(a.status, 1ull);  // the ticket
  __syncthreads();
  const int tile = s_tile;
  const long long R = a.R;
  const long long lo = (long long)tile * TILE;
  const int K = a.K, KD = a.K + a.D;

  // ---- A. gather --------------------------------------------------------
  // Warp w takes the tile's rows [w * 128, (w + 1) * 128), row k * 32 +
  // lane of them in its item k, so every load and store of a sorted row
  // is coalesced.  Each stage issues all its loads before any store (a
  // store may alias a later load, so it would hold that load back): p,
  // then the source rows, then idxm with the first gathered key lane.
  // A row's predecessor is the previous lane's row, lane 31's of the
  // previous item, or, for lane 0 of item 0, the row before the warp,
  // loaded again (lead).
  {
    const long long wb = lo + (long long)warp * (ITEMS * 32);
    const bool lead = lane == 0 && wb > 0 && wb < R;
    int r[ITEMS], m[ITEMS];
    // lane 0's row before the warp: its source row for lanes past 0
    long long rp = lead && !a.packed && KD > 1 ? a.p[wb - 1] : 0;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const long long i = wb + k * 32 + lane;
      r[k] = i < R ? (int)a.p[i] : 0;
    }
    if (a.base) {
      if (lead && !a.packed && KD > 1) rp = a.base[rp];
#pragma unroll
      for (int k = 0; k < ITEMS; ++k)
        if (wb + k * 32 + lane < R) r[k] = (int)a.base[r[k]];
    }
#pragma unroll
    for (int k = 0; k < ITEMS; ++k)
      m[k] = wb + k * 32 + lane < R ? a.idxm[r[k]] : 0;
    unsigned bm = 0u, pm = 0u;  // items whose row starts a group / tuple
    if (a.packed) {
      long long x[ITEMS];
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        const long long i = wb + k * 32 + lane;
        x[k] = i < R ? sorted_key(a, i) : 0;
      }
      const long long before = lead ? sorted_key(a, wb - 1) : x[0];
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        const long long up = shfl_up(x[k], 1);
        const long long last = __shfl_sync(FULL, k ? x[k - 1] : 0ll, 31);
        if (x[k] != (lane ? up : k ? last : before)) bm |= 1u << k;
      }
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        const long long i = wb + k * 32 + lane;
        if (i >= R) continue;
        long long* row = a.kmat + (size_t)i * K;
        long long y = x[k];
        if (y != a.sent) {
          // a packed key below the sentinel: every digit is in [0, card].
          // Digits 1..card give the key exactly; digit 0 is MISSING (-1)
          // or, when min != 0, possibly a value of min - 1, so that key
          // is read from its column
          for (int kk = K - 1; kk >= 0; --kk) {
            const long long radix = desc_at(a.desc, a.pack_card, kk) + 1;
            const long long mn = desc_at(a.desc, a.pack_min, kk);
            const long long d = y % radix;
            y /= radix;
            if (d != 0)
              row[kk] = (long long)((unsigned long long)d - 1ull +
                                    (unsigned long long)mn);
            else
              row[kk] = mn == 0 ? -1ll : key_lane(a, kk, r[k]);
          }
        } else if (m[k] < 0) {  // spilled: matched, sorted under the sentinel
          for (int kk = 0; kk < K; ++kk) row[kk] = key_lane(a, kk, r[k]);
        } else {
          for (int kk = 0; kk < K; ++kk) row[kk] = SENTINEL;
        }
      }
    } else {
      for (int kk = 0; kk < KD; ++kk) {
        long long v[ITEMS];
#pragma unroll
        for (int k = 0; k < ITEMS; ++k) {
          const long long i = wb + k * 32 + lane;
          v[k] = i < R ? sorted_lane(a, kk, i, r[k]) : 0;
        }
        const long long before =
            lead ? sorted_lane(a, kk, wb - 1, (int)rp) : v[0];
        const bool grp = kk < K;
#pragma unroll
        for (int k = 0; k < ITEMS; ++k) {
          const long long up = shfl_up(v[k], 1);
          const long long last = __shfl_sync(FULL, k ? v[k - 1] : 0ll, 31);
          if (v[k] != (lane ? up : k ? last : before)) {
            if (grp) bm |= 1u << k;
            else pm |= 1u << k;
          }
        }
        long long* out = grp ? a.kmat + kk : a.dmat + (kk - K);
        const int stride = grp ? K : a.D;
#pragma unroll
        for (int k = 0; k < ITEMS; ++k) {
          const long long i = wb + k * 32 + lane;
          if (i < R) out[(size_t)i * stride] = v[k];
        }
      }
    }
    if (wb == 0 && lane == 0) bm |= 1u;  // row 0 starts the first group
    int own = 0;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const long long i = wb + k * 32 + lane;
      const bool b = i < R && ((bm >> k) & 1u);
      own += b;
      s_m[warp * (ITEMS * 32) + k * 32 + lane] = m[k];
      s_b[warp * (ITEMS * 32) + k * 32 + lane] = b;
      if (i < R) {
        a.sidxm[i] = m[k];
        if (a.D) a.pair_mask[i] = m[k] < 0 && (((bm | pm) >> k) & 1u);
      }
    }
    own = __reduce_add_sync(FULL, own);
    if (lane == 0) s_count[warp] = own;
  }
  __syncthreads();

  // ---- B. the tile's prefix by decoupled look-back -----------------------
  if (warp == 0) {
    int count = lane < THREADS / 32 ? s_count[lane] : 0;
    count = __reduce_add_sync(FULL, count);
    unsigned long long* st = a.status + 1;
    unsigned long long excl = 0ull;
    if (tile == 0) {
      if (lane == 0)
        st_release(st, FLAG_PREFIX | (unsigned long long)count);
    } else {
      if (lane == 0)
        st_release(st + tile, FLAG_AGG | (unsigned long long)count);
      int reads = 0, windows = 0;
      for (int hi = tile - 1;; hi -= 32) {
        const int j = hi - lane;
        unsigned long long w = j >= 0 ? ld_acquire(st + j) : FLAG_PREFIX;
        // wait until the 32 tiles before have each published
        while (__any_sync(FULL, (w >> 62) == 0))
          if ((w >> 62) == 0) w = ld_acquire(st + j);
        const unsigned pre = __ballot_sync(FULL, (w >> 62) == 2);
        const int stop = pre ? __ffs(pre) - 1 : 31;
        unsigned long long c = lane <= stop ? (w & COUNT_MASK) : 0ull;
        for (int d = 16; d; d >>= 1) c += __shfl_xor_sync(FULL, c, d);
        excl += c;
        reads += stop + 1;
        ++windows;
        if (pre) break;
      }
      if (lane == 0)
        st_release(st + tile,
                   FLAG_PREFIX | (excl + (unsigned long long)count));
      if (a.paths && lane == 0) {
        if (reads > 1) atomicAdd(a.paths + P_MULTI, 1ull);
        if (windows > 1) atomicAdd(a.paths + P_DEEP, 1ull);
      }
    }
    if (lane == 0) {
      s_prefix = (int)excl;
      if (tile == a.ntiles - 1) a.num_groups[0] = (long long)excl + count;
    }
  }
  __syncthreads();

  // ---- C. gids, the key table and the lanes ------------------------------
  // Thread t takes the tile's rows [t * ITEMS, (t + 1) * ITEMS) from
  // shared memory, so that its runs are consecutive rows.
  const int t0 = threadIdx.x * ITEMS;
  const long long i0 = lo + t0;
  const int nin = i0 >= R ? 0 : (int)min((long long)ITEMS, R - i0);
  int m[ITEMS];
  unsigned bm = 0u;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    m[k] = s_m[t0 + k];
    bm |= (unsigned)s_b[t0 + k] << k;
  }
  if (a.paths) {
    if (threadIdx.x == 0 && tile > 0 && !(bm & 1u))
      atomicAdd(a.paths + P_CUT, 1ull);
    if (__any_sync(FULL, lane > 0 && nin > 0 && !(bm & 1u)) && lane == 0)
      atomicAdd(a.paths + P_CARRY, 1ull);
  }
  int total;
  const int before = s_prefix + block_scan<THREADS>(__popc(bm), &total);
  int g[ITEMS];
  const int S = a.S;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    g[k] = before + __popc(bm & ((2u << k) - 1u)) - 1;
    s_m[t0 + k] = g[k];  // the thread's own slots, read above
    if (k < nin && ((bm >> k) & 1u) && g[k] < S)
      for (int kk = 0; kk < K; ++kk)
        a.keys_tbl[(size_t)g[k] * K + kk] = a.kmat[(size_t)(i0 + k) * K + kk];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < TILE && lo + j < R; j += THREADS)
    a.gid[lo + j] = s_m[j];
  bool contrib[ITEMS];
  int r[ITEMS];
  unsigned long long w[ITEMS], one[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    contrib[k] = k < nin && m[k] < 0 && g[k] < S;
    r[k] = m[k] & 0x7fffffff;
    w[k] = contrib[k] && a.has_weight && a.w_valid[r[k]]
               ? (unsigned long long)a.w_vals[r[k]]
               : 1ull;
    if (!contrib[k]) w[k] = 0ull;
    one[k] = contrib[k] ? 1ull : 0ull;
  }
  const int L = a.L, H = a.H;
  seg_flush(SumOp{a.sums, L}, w, bm, g, S, lane);
  seg_flush(SumOp{a.sums + 1, L}, one, bm, g, S, lane);
  for (int ai = 0; ai < a.naggs; ++ai) {
    const long long* vals = desc_at(a.desc, a.agg_vals, ai);
    const unsigned char* valid = desc_at(a.desc, a.agg_valid, ai);
    const long long dmax = desc_at(a.desc, a.agg_dmax, ai);
    const long long dmin = desc_at(a.desc, a.agg_dmin, ai);
    const unsigned long long bias =
        (unsigned long long)desc_at(a.desc, a.agg_bias, ai);
    long long v[ITEMS];
    unsigned ok = 0u, keep = 0u;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      v[k] = contrib[k] ? vals[r[k]] : 0ll;
      if (contrib[k] && valid[r[k]]) ok |= 1u << k;
    }
    unsigned long long x[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      if (!((ok >> k) & 1u)) v[k] = 0ll;
      if (((ok >> k) & 1u) && !(v[k] > dmax || v[k] < dmin)) keep |= 1u << k;
      x[k] = (ok >> k) & 1u;
    }
    unsigned long long* row = a.sums + 2 + 3 * ai;
    seg_flush(SumOp{row, L}, x, bm, g, S, lane);
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) x[k] = (keep >> k) & 1u ? w[k] : 0ull;
    seg_flush(SumOp{row + 1, L}, x, bm, g, S, lane);
#pragma unroll
    for (int k = 0; k < ITEMS; ++k)
      x[k] = (keep >> k) & 1u ? w[k] * ((unsigned long long)v[k] - bias)
                              : 0ull;
    seg_flush(SumOp{row + 2, L}, x, bm, g, S, lane);
    const int mm = (int)desc_at(a.desc, a.agg_mm, ai);
    if (mm >= 0) {
      long long y[ITEMS];
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) y[k] = (keep >> k) & 1u ? v[k] : BIG;
      seg_flush(MinOp{a.mins + mm, H}, y, bm, g, S, lane);
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) y[k] = (keep >> k) & 1u ? v[k] : -BIG;
      seg_flush(MaxOp{a.maxs + mm, H}, y, bm, g, S, lane);
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

// Copies the descriptor block, zeroes the sums, the key table, the ticket
// and the status words with one memset, sets the min/max tables to their
// sentinels when H > 0, then runs the kernel, a CTA a tile, on `stream`.
// Returns cudaError_t.
extern "C" int segment_reduce(const SegmentReduceArgs* args, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const SegmentReduceArgs& a = *args;
  if (a.R < 1 || a.R >= (1ll << 31) ||
      a.ntiles != (int)((a.R + TILE - 1) / TILE) || a.K < 1 ||
      (a.D > 0 && (a.packed || !a.dmat || !a.pair_mask)) ||
      (!a.packed && !a.svals) || a.vg_span < 0 ||
      (a.vg_span & (a.vg_span - 1)) ||
      a.nzero < (long long)(a.S + 1) * a.L + (long long)a.S * a.K + 1 +
                    a.ntiles)
    return cudaErrorInvalidValue;
  cudaError_t err = desc_upload(a.desc, s);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(a.zero, 0, (size_t)a.nzero * sizeof(long long), s);
  if (err != cudaSuccess) return err;
  const long long mmn = (long long)a.S * a.H;
  if (mmn > 0) {
    fill_bounds<<<(unsigned)((mmn + THREADS - 1) / THREADS), THREADS, 0, s>>>(
        a.mins, a.maxs, mmn);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  segment_kernel<<<a.ntiles, THREADS, 0, s>>>(a);
  return cudaGetLastError();
}
