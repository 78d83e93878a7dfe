// K2 dense_scan: one fused pass of the dense group-by over R = B*C rows.
//
// Replaces sybil_tpu/ops/scan.py: _front_end (row-in-range, the
// int/str/regex filters, the time key, key lanes, weight), _dense_gid
// (mixed-radix gid, MISSING = digit 0, the time digit, clip, spill
// count, dead slot), _agg_row_data (lanes [w, 1, (exists, kw,
// kw*(v-bias)) x A], never materialised here) and _dense_reduce (exact
// int64 per-slot sums mod 2^64, and the per-slot min/max of the kept
// values of every histogram aggregation), plain over the reduce space
// of _scan_dense or in its windowed form.  When the scan has a
// histogram aggregation it also writes each row's reduce-space gid
// (dead rows = Sc-1) for K4.
//
// Filters: a row is matched when it is inside its block's record count
// and passes every filter.  A filter never passes on a missing value;
// int and str compares read the constant from the device array
// filter_vals (str literals are dict ids, -1 for a never-ingested one);
// re/nre read the regex bitset at clamp(v, 0, len-1); a set filter
// (_front_end's set-CSR branch, 376-381) reads K14's two row bitmasks,
// `has` and `hit`: in passes on has & hit, nin on has & ~hit (a set
// column has no validity lane, so the op is read first); any other op
// never matches (filter.go's default).
//
// The matched mask (a samples query, want_matched_mask; _scan_dense
// 1062-1063): one byte a row of [0, R), the front end's `matched` (in
// range, every filter, the time column present under a rollup), written
// before a row is dropped, so a matched row whose key spilled into the
// dead slot is still 1.  MASK is a template parameter, like TIME.
//
// Cache-group key (a query-cache group scan, vg_span > 0; _front_end's
// cg_key, 405-411, 424-428): key 0 is each row's block position over the
// group span, (r >> log2C) / vg_span, made here from the row index with
// no column read (the reference's iota: no key column is uploaded).  The
// span is a power of two (the cache's 16 blocks), so the division is one
// shift by a loop-invariant count.  Its
// digit is cg - min + 1 like any key's, never MISSING.  Under a time
// rollup it leads the time key (vg_first), so a chunk of rows, which
// lies in one block, still spans one narrow band of gids and the
// windowed form applies unchanged.  CG is a template parameter, like
// TIME: the scans without it run the code they ran before.
//
// Time key (a rollup): a row without the time column is unmatched.  The
// key's digit is q - min + 1 with q = trunc_div(t, tb), Go's division
// (the reference's _trunc_div: floor of |t| / tb, negated for t < 0);
// the row spills when q falls outside [min, min + card).  When the bind
// proved the column and the bucket fit int32 (time_i32), q and the
// digit are int32 arithmetic like the reference's, which is also the
// fast form here: 64-bit division is a long software sequence.
//
// Bound: memory.  Each row is read once: 8 B value + 1 B validity per
// referenced column, plus 4 B of gid written when K4 follows.  The sums
// are tiny.  All lane arithmetic is unsigned 64-bit, so products and
// sums wrap mod 2^64 exactly as the reference's int64 lanes do.  Min and
// max are signed 64-bit; a leader reads the current bound first and
// skips the atomic when its value cannot change it (bounds only move one
// way, so a stale read only costs an extra atomic).  Empty slots keep the
// reference's sentinels, +2^62 and -2^62.  Unmatched rows add nothing
// (every lane is masked by `matched`, and spills only count matched
// rows).  The reference's byte-limb encoding (lane_limbs8), f32 min/max
// and one-hot matmuls are TPU devices and do not apply: all give the
// same int64 results.
//
// What a trace of the former shared and global forms showed (PERF.md §6,
// PR 15; torch.profiler and cuobjdump on the H100).  They took one row a
// thread a step, 8 CTAs of 256 threads a SM, and each matched row made
// its L = 2 + 3A 64-bit atomics on its own: a shared 64-bit atomicAdd is
// a CAS spin loop (ATOMS.CAST.SPIN.64), which every warp of a CTA spun on
// for config 1's 5 hosts (357 us at 8,388,608 rows; 179 us with 500
// hosts; 167 us at config 3, whose filter drops four rows of five), and
// the global form's uncombined 64-bit atomics piled onto the same words
// (27.2 ms at config 1).  A row's loads also formed one chain: the
// filters, then the keys, then each aggregation, each waiting on the
// last.
//
// Design: the tiled kernel (dense_scan_tiles), one CTA of TT threads a
// SM, serves the shared and global forms and the windowed form's
// resident mode.  A warp takes tiles of 32 x TU rows, TU rows a lane
// (rows lane + 32u, so every load and store is coalesced), and reads a
// tile a column at a time: a filter's, a key's or an aggregation's TU rows
// are loaded together, unconditionally, so a tile waits on one load a
// column rather than each row on one load a column.  The table, by size
// (the wrapper's choice, dense_scan_route; any gives the same words):
//   per warp   a table a warp in shared memory (the CTA's 32 fit): no
//              warp's atomics meet another's;
//   per CTA    one table a CTA (the windowed form's resident mode too);
//   global     the global tables directly.
// Shared tables keep narrow lanes (WinLayout): a lane that adds 0 or 1 a
// row is one 32-bit word, a 64-bit lane two words added by two native
// 32-bit atomics with the carry taken from the old low word, so nothing
// spins, and each matched row adds itself (add_own).  A CTA flushes its
// tables' non-zero words to the global tables once.  The global form
// first combines a warp's equal gids (add_rows: __match_any_sync groups
// them, 0/1 lanes are counted by ballot, the 64-bit lanes and the min/max
// reduced by shuffles, one leader a group touches the table), since its
// 64-bit global atomics pile onto the same words.  Tried and dropped on
// the H100 (PERF.md §6, PR 15): that combining in shared tables too
// (config 1 0.131 ms against 0.080 uncombined; the match and the shuffle
// rounds cost more than the atomics they save), a slot a lane summed by
// warp reductions (REDUX; twice as slow), an L2 prefetch of the next tile
// (7-18% slower) and tiles of 8 rows a lane (register spills).

// The windowed form (a rollup's table past a CTA's shared memory, PR 12)
// keeps its chunked kernel: a time-sorted chunk (one or two hours: about
// 9 distinct slots) spans a narrow band of slots, and a chunk of rows in
// arrival order spans every slot, so a band sized to the bind's window
// would be swept many times (PERF.md row 15b).  A CTA takes chunks of
// rows from an atomic counter and sizes each chunk's sweep to its live
// span, or sends a sparse chunk straight to the global tables; see "the
// windowed form" below.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "desc.cuh"
#include "filters.cuh"
#include "time_key.cuh"

namespace {

constexpr int THREADS = 256;       // fill_bounds
constexpr long long BIG = 1ll << 62;
constexpr unsigned FULL = 0xffffffffu;
constexpr int TT = 1024;     // the tiled kernel's threads (one CTA a SM)
constexpr int TU = 4;        // rows a lane a tile: 32 x TU rows a warp
constexpr int TH = 2;        // rows a lane add_own / add_rows take at once
constexpr int WT = 1024;     // the windowed kernel's threads

}  // namespace

// Mirrored field for field by DenseScanArgs in ops/scan.py (ctypes).  The
// per-key, per-aggregation and per-filter arrays point into the
// descriptor block (desc.cuh), so the counts of keys, aggregations and
// filters have no fixed cap.
struct DenseScanArgs {
  Desc desc;
  const long long* const* key_vals;   // [nkeys] [cg?, time?, *groups];
                                      // cg's and time's unused
  const unsigned char* const* key_valid;
  const long long* key_min;           // [nkeys]
  const long long* key_card;
  const long long* const* agg_vals;   // [naggs]
  const unsigned char* const* agg_valid;
  const long long* agg_dmin;
  const long long* agg_dmax;
  const long long* agg_bias;
  const long long* agg_mm;            // min/max column of each agg, -1 = none
  const long long* const* f_vals;     // [nfilters]; set ops: K14's hit
  const unsigned char* const* f_valid;  // set ops: K14's has
  const unsigned char* const* f_bits; // regex bitsets (re/nre) or null
  const long long* f_bits_len;
  // 0 gt, 1 lt, 2 eq, 3 neq, 4 re, 5 nre, 6 never, 7 set in, 8 set nin
  const long long* f_op;
  const long long* filter_vals;       // [nfilters] filter constants
  const long long* w_vals;
  const unsigned char* w_valid;
  const long long* t_vals;            // time column (has_time)
  const unsigned char* t_valid;
  const int* nrec;            // [B] valid records per block
  unsigned long long* sums;   // [Sc, L]
  unsigned long long* spill;  // [1]
  long long* mins;            // [Sc, H] (H = histogram aggregations)
  long long* maxs;            // [Sc, H]
  int* gid_out;               // [R] reduce-space gid, or null
  unsigned char* mask;        // [R] matched rows (MASK), or null
  long long R;
  long long tb;               // time bucket (> 0)
  int log2C;
  int nkeys;                  // key digits, the time key included
  int naggs;
  int nfilters;
  int slots;
  int Sc;
  int L;
  int H;
  int has_weight;
  int has_time;               // the time key follows the cg key, if any
  int time_i32;
  int band;                   // windowed form: slots of the shared table
  int chunk;                  // windowed form: rows per chunk, 0 resident
  int vg_span;                // > 0: key 0 is the cache-group key
  unsigned long long* counter;  // windowed form: the next chunk (zeroed)
  unsigned long long* paths;    // windowed form: [5] path counts, or null
};

namespace {

// The match and reduce-space gid of the N rows r + 32u (u < N; a warp's
// tile, or one row), a column at a time: each filter's, the time
// column's and each key's N rows are loaded before any of them is used.
// key[u] is row r + 32u's gid, or -1 for an unmatched row or one past R.
// Writes the rows' matched mask (MASK) and gid_out (dead rows Sc-1), and
// adds the matched rows that spilled to *spill.  A filter never passes on
// a missing value; CG (key 0 is the cache-group key) and TIME (the time
// key comes next) are template parameters and their digits are peeled
// off the key loop: a branch on the time key inside the loop made K2 a
// third slower or more on scans without one (sybil_tpu_torch/k2_ab.py on
// the H100).  So is HEAD, where the descriptor block lies (desc.cuh).
template <bool CG, bool TIME, bool HEAD, bool MASK, int N>
__device__ __forceinline__ void tile_gids(const DenseScanArgs& a,
                                          long long r, const long long* s_fv,
                                          int* key,
                                          unsigned long long* spill) {
  unsigned inr;
  unsigned live = tile_in_range<N>(a.nrec, a.R, a.log2C, r, &inr);
  live = tile_filters<HEAD, N>(a, r, inr, live, s_fv);
  unsigned sp = 0u;
  int gid[N];
#pragma unroll
  for (int u = 0; u < N; ++u) gid[u] = 0;
  int first = 0;
  if (CG) {
    const long long mn = desc_at<HEAD>(a.desc, a.key_min, 0);
    const long long card = desc_at<HEAD>(a.desc, a.key_card, 0);
    const int sh = a.log2C + __ffs(a.vg_span) - 1;
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const long long k = (r + 32 * u) >> sh;
      const long long digit =
          (long long)((unsigned long long)k - (unsigned long long)mn + 1ull);
      sp |= (unsigned)((k < mn) |
                       (k >= (long long)((unsigned long long)mn +
                                         (unsigned long long)card))) << u;
      gid[u] = (int)(digit < 0 ? 0 : (digit > card ? card : digit));
    }
    first = 1;
  }
  if (TIME) {
    const long long mn = desc_at<HEAD>(a.desc, a.key_min, first);
    const long long card = desc_at<HEAD>(a.desc, a.key_card, first);
    long long t[N];
    unsigned tv = 0u;
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const long long ru = r + 32 * u;
      t[u] = 0;
      if ((inr >> u) & 1u) {
        tv |= (unsigned)(a.t_valid[ru] != 0) << u;
        t[u] = a.t_vals[ru];
      }
    }
    live &= tv;
#pragma unroll
    for (int u = 0; u < N; ++u) {
      long long q, digit;
      if (a.time_i32) {
        const int q32 = go_trunc_div<int, unsigned>(static_cast<int>(t[u]),
                                                    static_cast<int>(a.tb));
        q = q32;
        // int32 like the reference's digit q - mn + 1
        digit = static_cast<int>(static_cast<unsigned>(q32) -
                                 static_cast<unsigned>(mn) + 1u);
      } else {
        q = go_trunc_div<long long, unsigned long long>(t[u], a.tb);
        digit = (long long)((unsigned long long)q - (unsigned long long)mn +
                            1ull);
      }
      sp |= (unsigned)((q < mn) | (q >= mn + card)) << u;
      gid[u] = gid[u] * (int)(card + 1) +
               (int)(digit < 0 ? 0 : (digit > card ? card : digit));
    }
    ++first;
  }
  for (int i = first; i < a.nkeys; ++i) {
    const long long* kv = desc_at<HEAD>(a.desc, a.key_vals, i);
    const unsigned char* km = desc_at<HEAD>(a.desc, a.key_valid, i);
    const long long mn = desc_at<HEAD>(a.desc, a.key_min, i);
    const long long card = desc_at<HEAD>(a.desc, a.key_card, i);
    const long long hi =
        (long long)((unsigned long long)mn + (unsigned long long)card);
    long long k[N];
    unsigned kok = 0u;
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const long long ru = r + 32 * u;
      k[u] = 0;
      if ((inr >> u) & 1u) {
        kok |= (unsigned)(km[ru] != 0) << u;
        k[u] = kv[ru];
      }
    }
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const long long kk = ((kok >> u) & 1u) ? k[u] : -1ll;
      long long digit = 0;
      if (kk != -1ll) {
        digit = (long long)((unsigned long long)kk - (unsigned long long)mn
                            + 1ull);
        sp |= (unsigned)((kk < mn) | (kk >= hi)) << u;
      }
      digit = digit < 0 ? 0 : (digit > card ? card : digit);
      gid[u] = gid[u] * (int)(card + 1) + (int)digit;
    }
  }
  live &= inr;
  *spill += __popc(sp & live);
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const long long ru = r + 32 * u;
    const bool m = (live >> u) & 1u;
    if ((inr >> u) & 1u) {
      if (MASK) a.mask[ru] = m;
      if (a.gid_out) a.gid_out[ru] = m ? gid[u] : a.Sc - 1;
    }
    key[u] = m ? gid[u] : -1;
  }
}

// ---- narrow shared tables and the warp's combine -------------------------
//
// A shared table holds narrow lanes: a lane that adds 0 or 1 a row (the
// count, each aggregation's exists, and w and kw when there is no weight
// column, where they equal the count and the kept count) is one 32-bit
// word, a lane of 64-bit sums two words (lo, hi) added by two native
// 32-bit shared atomics with the carry taken from the returned old low
// word.  A 64-bit shared atomicAdd compiles to a CAS spin loop
// (ATOMS.CAST.SPIN.64 on sm_90a); two 32-bit ones do not spin.

// Word offsets of the narrow lanes of one slot: [w lo, w hi]? count,
// then per aggregation [exists, kw (1 or 2 words), kwv lo, kwv hi].
struct WinLayout {
  int hw;   // a weight column: w and kw are 64-bit lanes
  int cw;   // the count's word
  int pa;   // words an aggregation
  int sw;   // words a slot
};

__device__ __forceinline__ WinLayout win_layout(const DenseScanArgs& a) {
  WinLayout w;
  w.hw = a.has_weight;
  w.cw = a.has_weight ? 2 : 0;
  w.pa = a.has_weight ? 5 : 4;
  w.sw = w.cw + 1 + a.naggs * w.pa;
  return w;
}

__device__ __forceinline__ void add64(unsigned* p, unsigned long long x) {
  const unsigned lo = (unsigned)x;
  unsigned hi = (unsigned)(x >> 32);
  if (lo) {
    const unsigned old = atomicAdd(p, lo);
    hi += (unsigned)(old + lo < old);     // the carry out of the low word
  }
  if (hi) atomicAdd(p + 1, hi);
}

__device__ __forceinline__ unsigned long long get64(const unsigned* p) {
  return (unsigned long long)p[0] | ((unsigned long long)p[1] << 32);
}


// Lane j of the narrow slot at p, widened to its u64 sum.
__device__ __forceinline__ unsigned long long lane_value(const WinLayout& w,
                                                        const unsigned* p,
                                                        int j) {
  if (j < 2) return (j == 0 && w.hw) ? get64(p) : p[w.cw];
  const int ai = (j - 2) / 3, k = j - 2 - 3 * ai;
  const unsigned* q = p + w.cw + 1 + ai * w.pa;
  if (k == 0) return q[0];
  if (k == 1) return w.hw ? get64(q + 1) : q[1];
  return get64(q + (w.hw ? 3 : 2));
}

struct OpAdd {
  __device__ unsigned long long operator()(unsigned long long x,
                                           unsigned long long y) const {
    return x + y;
  }
};
struct OpMin {
  __device__ long long operator()(long long x, long long y) const {
    return y < x ? y : x;
  }
};
struct OpMax {
  __device__ long long operator()(long long x, long long y) const {
    return y > x ? y : x;
  }
};

// x combined over the lanes of `peers` (this lane's group), a pairwise
// tree in the order of the lanes; the result is valid at the group's
// lowest lane.  Every lane of the warp calls it.
template <typename T, typename Op>
__device__ __forceinline__ T reduce_peers(unsigned peers, T x, Op op) {
  const int lane = threadIdx.x & 31;
  int rel = __popc(peers & ((1u << lane) - 1u));
  unsigned rest = peers & (0xfffffffeu << lane);
  while (__any_sync(FULL, rest)) {
    const int next = __ffs(rest);
    const T t = __shfl_sync(FULL, x, next ? next - 1 : lane);
    if (next) x = op(x, t);
    rest &= ~__ballot_sync(FULL, rel & 1);
    rel >>= 1;
  }
  return x;
}

// The table a row adds to: a warp's own shared table, a CTA's shared
// table, or the global tables.
enum { M_WARP, M_CTA, M_GLOBAL };

// Adds each matched row r + 32u (u < N; r is this lane's first row) of
// the warp to its slot key[u] (-1: none) of a shared table on its own:
// native 32-bit shared atomics (two, with the carry, for a 64-bit lane),
// and the min/max by 64-bit atomics when a plain read shows the value can
// move the bound.  A row's weight and each aggregation's N rows are
// loaded together.
template <bool HEAD, int N>
__device__ __forceinline__ void add_own(const DenseScanArgs& a,
                                        const WinLayout& w, long long r,
                                        const int* key, unsigned* tab,
                                        long long* tmin, long long* tmax) {
  unsigned long long wt[N];
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const long long ru = r + 32 * u;
    bool wv = false;
    long long wx = 1;
    if (w.hw && key[u] >= 0) {
      wv = a.w_valid[ru] != 0;
      wx = a.w_vals[ru];
    }
    wt[u] = wv ? (unsigned long long)wx : 1ull;
  }
#pragma unroll
  for (int u = 0; u < N; ++u) {
    if (key[u] < 0) continue;
    unsigned* p = tab + (size_t)key[u] * w.sw;
    if (w.hw) add64(p, wt[u]);
    atomicAdd(p + w.cw, 1u);
  }
  for (int ai = 0; ai < a.naggs; ++ai) {
    const long long* vals = desc_at<HEAD>(a.desc, a.agg_vals, ai);
    const unsigned char* valid = desc_at<HEAD>(a.desc, a.agg_valid, ai);
    const long long dmin = desc_at<HEAD>(a.desc, a.agg_dmin, ai);
    const long long dmax = desc_at<HEAD>(a.desc, a.agg_dmax, ai);
    const unsigned long long bias =
        (unsigned long long)desc_at<HEAD>(a.desc, a.agg_bias, ai);
    const int mm = (int)desc_at<HEAD>(a.desc, a.agg_mm, ai);
    long long v[N];
    unsigned ex = 0u;
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const long long ru = r + 32 * u;
      v[u] = 0;
      if (key[u] >= 0) {
        ex |= (unsigned)(valid[ru] != 0) << u;
        v[u] = vals[ru];
      }
    }
#pragma unroll
    for (int u = 0; u < N; ++u) {
      if (!((ex >> u) & 1u)) continue;
      unsigned* q = tab + (size_t)key[u] * w.sw + w.cw + 1 + ai * w.pa;
      atomicAdd(q, 1u);
      if (v[u] > dmax || v[u] < dmin) continue;  // not kept
      const unsigned long long kwv = wt[u] * ((unsigned long long)v[u] - bias);
      if (w.hw) {
        add64(q + 1, wt[u]);
        add64(q + 3, kwv);
      } else {
        atomicAdd(q + 1, 1u);
        add64(q + 2, kwv);
      }
      if (mm >= 0) {
        const size_t o = (size_t)key[u] * a.H + mm;
        if (v[u] < *(volatile long long*)(tmin + o)) atomicMin(tmin + o, v[u]);
        if (v[u] > *(volatile long long*)(tmax + o)) atomicMax(tmax + o, v[u]);
      }
    }
  }
}

// Adds the warp's rows r + 32u (u < N; r is this lane's first row) to
// their slots: key[u] is the row's slot in the shared table (M_GLOBAL: its
// gid in a.sums), -1 for a row that adds nothing.  A row's weight and each
// aggregation's N rows are loaded together.  Every lane of the warp calls
// it.
template <bool HEAD, int N>
__device__ __forceinline__ void add_rows(const DenseScanArgs& a,
                                         const WinLayout& w, long long r,
                                         const int* key, int mode,
                                         unsigned* tab, long long* tmin,
                                         long long* tmax) {
  const int lane = threadIdx.x & 31;
  const bool global = mode == M_GLOBAL;
  unsigned peers[N];
  unsigned long long wt[N];
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const long long ru = r + 32 * u;
    // a row that adds nothing is a group of its own and takes no part in
    // the match, whose time grows with the values it sees
    const unsigned lm = __ballot_sync(FULL, key[u] >= 0);
    peers[u] = 1u << lane;
    if (key[u] >= 0) peers[u] = __match_any_sync(lm, key[u]);
    bool wv = false;
    long long wx = 1;
    if (w.hw && key[u] >= 0) {
      wv = a.w_valid[ru] != 0;
      wx = a.w_vals[ru];
    }
    wt[u] = wv ? (unsigned long long)wx : 1ull;
  }
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const bool live = key[u] >= 0;
    const bool lead = live && lane == __ffs(peers[u]) - 1;
    const unsigned n = __popc(peers[u]);
    unsigned long long sw = n;
    if (w.hw) sw = reduce_peers(peers[u], live ? wt[u] : 0ull, OpAdd());
    if (lead) {
      if (global) {
        unsigned long long* row = a.sums + (size_t)key[u] * a.L;
        if (sw) atomicAdd(row, sw);
        atomicAdd(row + 1, (unsigned long long)n);
      } else {
        unsigned* p = tab + (size_t)key[u] * w.sw;
        if (w.hw) add64(p, sw);
        atomicAdd(p + w.cw, n);
      }
    }
  }
  for (int ai = 0; ai < a.naggs; ++ai) {
    const long long* vals = desc_at<HEAD>(a.desc, a.agg_vals, ai);
    const unsigned char* valid = desc_at<HEAD>(a.desc, a.agg_valid, ai);
    const long long dmin = desc_at<HEAD>(a.desc, a.agg_dmin, ai);
    const long long dmax = desc_at<HEAD>(a.desc, a.agg_dmax, ai);
    const unsigned long long bias =
        (unsigned long long)desc_at<HEAD>(a.desc, a.agg_bias, ai);
    const int mm = (int)desc_at<HEAD>(a.desc, a.agg_mm, ai);
    long long v[N];
    unsigned ex = 0u;
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const long long ru = r + 32 * u;
      v[u] = 0;
      if (key[u] >= 0) {
        ex |= (unsigned)(valid[ru] != 0) << u;
        v[u] = vals[ru];
      }
    }
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const bool e = (ex >> u) & 1u;
      const bool kept = e && !(v[u] > dmax || v[u] < dmin);
      const bool lead = key[u] >= 0 && lane == __ffs(peers[u]) - 1;
      const unsigned nex = __popc(__ballot_sync(FULL, e) & peers[u]);
      unsigned long long kw;
      if (w.hw)
        kw = reduce_peers(peers[u], kept ? wt[u] : 0ull, OpAdd());
      else
        kw = __popc(__ballot_sync(FULL, kept) & peers[u]);
      const unsigned long long kwv = reduce_peers(
          peers[u], kept ? wt[u] * ((unsigned long long)v[u] - bias) : 0ull,
          OpAdd());
      if (lead) {
        if (global) {
          unsigned long long* g = a.sums + (size_t)key[u] * a.L + 2 + 3 * ai;
          if (nex) atomicAdd(g, (unsigned long long)nex);
          if (kw) atomicAdd(g + 1, kw);
          if (kwv) atomicAdd(g + 2, kwv);
        } else {
          unsigned* q = tab + (size_t)key[u] * w.sw + w.cw + 1 + ai * w.pa;
          if (nex) atomicAdd(q, nex);
          if (w.hw) {
            add64(q + 1, kw);
            add64(q + 3, kwv);
          } else {
            if (kw) atomicAdd(q + 1, (unsigned)kw);
            add64(q + 2, kwv);
          }
        }
      }
      if (mm >= 0) {
        const long long lo = reduce_peers(peers[u], kept ? v[u] : BIG, OpMin());
        const long long hi =
            reduce_peers(peers[u], kept ? v[u] : -BIG, OpMax());
        if (lead) {
          const size_t o = (size_t)key[u] * a.H + mm;
          long long* pmn = (global ? a.mins : tmin) + o;
          long long* pmx = (global ? a.maxs : tmax) + o;
          if (lo < *(volatile long long*)pmn) atomicMin(pmn, lo);
          if (hi > *(volatile long long*)pmx) atomicMax(pmx, hi);
        }
      }
    }
  }
}

__device__ __forceinline__ void band_zero(const WinLayout& w, int H,
                                          unsigned* s_tab, long long* s_min,
                                          long long* s_max, int nslots) {
  for (int i = threadIdx.x; i < nslots * w.sw; i += blockDim.x) s_tab[i] = 0u;
  for (int i = threadIdx.x; i < nslots * H; i += blockDim.x) {
    s_min[i] = BIG;
    s_max[i] = -BIG;
  }
}

// The non-empty entries of slots [b0, b0 + nslots), summed over `nt`
// shared tables of nslots slots each ([nt][nslots, sw] narrow lanes,
// [nt][nslots, H] mins and maxs), to the global tables.
__device__ __forceinline__ void table_flush(const DenseScanArgs& a,
                                            const WinLayout& w,
                                            const unsigned* s_tab,
                                            const long long* s_min,
                                            const long long* s_max, int b0,
                                            int nslots, int nt) {
  const int L = a.L;
  const size_t tw = (size_t)nslots * w.sw, mw = (size_t)nslots * a.H;
  for (int i = threadIdx.x; i < nslots * L; i += blockDim.x) {
    const int s = i / L, j = i - s * L;
    unsigned long long v = 0ull;
    for (int t = 0; t < nt; ++t)
      v += lane_value(w, s_tab + t * tw + (size_t)s * w.sw, j);
    if (v) atomicAdd(a.sums + (size_t)(b0 + s) * L + j, v);
  }
  for (int i = threadIdx.x; i < nslots * a.H; i += blockDim.x) {
    long long mn = BIG, mx = -BIG;
    for (int t = 0; t < nt; ++t) {
      mn = min(mn, s_min[t * mw + i]);
      mx = max(mx, s_max[t * mw + i]);
    }
    if (mn != BIG) atomicMin(a.mins + (size_t)b0 * a.H + i, mn);
    if (mx != -BIG) atomicMax(a.maxs + (size_t)b0 * a.H + i, mx);
  }
}

// a.paths (optional) counts, for the checks, the CTAs of each table mode
// of the tiled kernel (shared and global forms: [per warp, per CTA,
// global]) and the windowed form's resident CTAs and chunks
// (WINDOW_PATHS of ops/scan.py).
enum { P_RESIDENT, P_FULL_SPAN, P_BANDED, P_DIRECT, P_EMPTY };

// ---- the tiled kernel ----------------------------------------------------
//
// One CTA of TT threads a SM.  A warp takes tiles of 32 x TU rows by a
// grid stride: tile_gids, then add_rows over TH rows a lane at a time.
// `mode` picks the table (M_WARP: TT / 32 tables of [Sc] slots, one a
// warp; M_CTA: one; M_GLOBAL: none); each CTA adds one to a.paths[path].
template <bool CG, bool TIME, bool HEAD, bool MASK>
__global__ void __launch_bounds__(TT, 1) dense_scan_tiles(
    const DenseScanArgs a, int mode, int path) {
  extern __shared__ __align__(16) unsigned long long s_dyn[];
  __shared__ unsigned long long s_spill;
  __shared__ long long s_fv[FV_SMEM];
  const WinLayout w = win_layout(a);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nt = mode == M_WARP ? TT / 32 : (mode == M_CTA ? 1 : 0);
  const size_t mmn = (size_t)a.Sc * a.H, tw = (size_t)a.Sc * w.sw;
  long long* s_min = reinterpret_cast<long long*>(s_dyn);  // [nt][Sc, H]
  long long* s_max = s_min + nt * mmn;
  unsigned* s_tab = reinterpret_cast<unsigned*>(s_max + nt * mmn);
  for (size_t i = threadIdx.x; i < nt * tw; i += TT) s_tab[i] = 0u;
  for (size_t i = threadIdx.x; i < nt * mmn; i += TT) {
    s_min[i] = BIG;
    s_max[i] = -BIG;
  }
  if (threadIdx.x < min(a.nfilters, FV_SMEM))
    s_fv[threadIdx.x] = a.filter_vals[threadIdx.x];
  if (threadIdx.x == 0) s_spill = 0ull;
  __syncthreads();
  const int t = mode == M_WARP ? warp : 0;
  unsigned* tab = s_tab + t * tw;
  long long* tmin = s_min + t * mmn;
  long long* tmax = s_max + t * mmn;
  unsigned long long my_spill = 0ull;
  const long long step = (long long)gridDim.x * TT * TU;
  for (long long r0 = ((long long)blockIdx.x * (TT / 32) + warp) * (32 * TU);
       r0 < a.R; r0 += step) {
    int key[TU];
    tile_gids<CG, TIME, HEAD, MASK, TU>(a, r0 + lane, s_fv, key, &my_spill);
#pragma unroll
    for (int h = 0; h < TU; h += TH) {
      bool any = false;
#pragma unroll
      for (int u = h; u < h + TH; ++u) any |= key[u] >= 0;
      if (mode == M_GLOBAL) {
        if (__any_sync(FULL, any))
          add_rows<HEAD, TH>(a, w, r0 + lane + 32 * h, key + h, M_GLOBAL,
                             tab, tmin, tmax);
      } else if (any) {
        add_own<HEAD, TH>(a, w, r0 + lane + 32 * h, key + h, tab, tmin,
                          tmax);
      }
    }
  }
  if (my_spill) atomicAdd(&s_spill, my_spill);
  __syncthreads();
  if (nt) table_flush(a, w, s_tab, s_min, s_max, 0, a.Sc, nt);
  if (threadIdx.x == 0) {
    if (s_spill) atomicAdd(a.spill, s_spill);
    if (a.paths) atomicAdd(a.paths + path, 1ull);
  }
}

// ---- the windowed form ---------------------------------------------------
//
// One CTA of WT threads a SM takes chunks of `chunk` rows from an atomic
// counter, stages their gids in shared memory with the live span [lo, hi]
// and the live count, then
//   full-span  (span <= band) zeroes span slots of its shared table of
//              narrow lanes, accumulates, flushes them;
//   banded     (span > band, at least 2 live rows a slot) sweeps the span
//              in bands of `band` slots;
//   direct     (sparser) adds each warp group straight to the global
//              tables, as the global form does.
// Rows are combined a warp at a time by add_rows.  When the whole reduce
// space fits one shared table (chunk 0, band = Sc), the tiled kernel runs
// instead with one table a CTA: the resident mode, counted as P_RESIDENT.
template <bool CG, bool TIME, bool HEAD, bool MASK>
__global__ void __launch_bounds__(WT, 1) dense_scan_windowed(
    const DenseScanArgs a) {
  extern __shared__ __align__(16) unsigned long long s_dyn[];
  __shared__ unsigned long long s_spill;
  __shared__ long long s_fv[FV_SMEM];
  __shared__ long long s_chunk;
  __shared__ int s_lo, s_hi, s_live;
  const WinLayout w = win_layout(a);
  const int band = a.band, H = a.H, lane = threadIdx.x & 31;
  long long* s_min = reinterpret_cast<long long*>(s_dyn);  // [band, H]
  long long* s_max = s_min + (size_t)band * H;
  unsigned* s_tab = reinterpret_cast<unsigned*>(s_max + (size_t)band * H);
  int* s_gid = reinterpret_cast<int*>(s_tab + (size_t)band * w.sw);
  if (threadIdx.x < min(a.nfilters, FV_SMEM))
    s_fv[threadIdx.x] = a.filter_vals[threadIdx.x];
  if (threadIdx.x == 0) s_spill = 0ull;
  unsigned long long my_spill = 0ull;

  const long long nchunks = (a.R + a.chunk - 1) / a.chunk;
  for (;;) {
    if (threadIdx.x == 0) {
      s_chunk = (long long)atomicAdd(a.counter, 1ull);
      s_lo = INT_MAX;
      s_hi = -1;
      s_live = 0;
    }
    __syncthreads();  // also: the last chunk's flush is done
    const long long c = s_chunk;
    if (c >= nchunks) break;
    const long long rc = c * a.chunk;
    const int n = (int)min((long long)a.chunk, a.R - rc);
    int lo = INT_MAX, hi = -1, nl = 0;
    for (int i = threadIdx.x; i < n; i += WT) {
      int gid;
      tile_gids<CG, TIME, HEAD, MASK, 1>(a, rc + i, s_fv, &gid, &my_spill);
      if (gid >= 0) {
        lo = min(lo, gid);
        hi = max(hi, gid);
        ++nl;
      }
      s_gid[i] = gid;
    }
    lo = __reduce_min_sync(FULL, lo);
    hi = __reduce_max_sync(FULL, hi);
    nl = __reduce_add_sync(FULL, nl);
    if (lane == 0 && nl) {
      atomicMin(&s_lo, lo);
      atomicMax(&s_hi, hi);
      atomicAdd(&s_live, nl);
    }
    __syncthreads();
    const int clo = s_lo, chi = s_hi, nlive = s_live;
    const int span = chi - clo + 1;
    int path = P_EMPTY;
    if (nlive == 0) {
    } else if (span <= band || nlive >= 2 * span) {
      path = span <= band ? P_FULL_SPAN : P_BANDED;
      for (int b0 = clo; b0 <= chi; b0 += band) {
        const int nb = min(band, chi + 1 - b0);
        band_zero(w, H, s_tab, s_min, s_max, nb);
        __syncthreads();
        for (int i0 = threadIdx.x & ~31; i0 < n; i0 += WT) {
          const int i = i0 + lane;
          const int g = i < n ? s_gid[i] : -1;
          const int k = g >= b0 && g < b0 + nb ? g - b0 : -1;
          add_rows<HEAD, 1>(a, w, rc + i, &k, M_CTA, s_tab, s_min, s_max);
        }
        __syncthreads();
        table_flush(a, w, s_tab, s_min, s_max, b0, nb, 1);
        __syncthreads();  // the band is free again
      }
    } else {
      path = P_DIRECT;
      for (int i0 = threadIdx.x & ~31; i0 < n; i0 += WT) {
        const int i = i0 + lane;
        const int g = i < n ? s_gid[i] : -1;
        add_rows<HEAD, 1>(a, w, rc + i, &g, M_GLOBAL, s_tab, s_min, s_max);
      }
    }
    if (a.paths && threadIdx.x == 0) atomicAdd(a.paths + path, 1ull);
    __syncthreads();  // every thread has read s_chunk, s_lo, s_hi
  }
  if (my_spill) atomicAdd(&s_spill, my_spill);
  __syncthreads();
  if (threadIdx.x == 0 && s_spill) atomicAdd(a.spill, s_spill);
}

__global__ void fill_bounds(long long* mins, long long* maxs, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    mins[i] = BIG;
    maxs[i] = -BIG;
  }
}

// The C entry's forms (ops/scan.py _K2_FORMS): the tiled kernel with the
// global tables, one shared table a CTA, or one a warp (at most 32 slots:
// a lane a slot); the windowed form.
enum { F_GLOBAL, F_SHARED, F_WINDOWED, F_WARP };

template <bool CG, bool TIME, bool HEAD, bool MASK>
cudaError_t launch_form(const DenseScanArgs* args, int form, int grid,
                        cudaStream_t s) {
  cudaError_t err;
  const int sw = (args->has_weight ? 2 : 0) + 1 +
                 args->naggs * (args->has_weight ? 5 : 4);
  const size_t slot = 16 * (size_t)args->H + 4 * (size_t)sw;
  if (args->R >= (1ll << 31)) return cudaErrorInvalidValue;  // 32-bit lanes
  if (form == F_WINDOWED && args->chunk != 0) {
    if (args->band <= 0 || args->chunk < 0 || args->band > args->Sc ||
        !args->counter)
      return cudaErrorInvalidValue;
    const size_t shm =
        (size_t)args->band * slot + (size_t)args->chunk * sizeof(int);
    err = cudaFuncSetAttribute(dense_scan_windowed<CG, TIME, HEAD, MASK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)shm);
    if (err != cudaSuccess) return err;
    dense_scan_windowed<CG, TIME, HEAD, MASK><<<grid, WT, shm, s>>>(*args);
    return cudaGetLastError();
  }
  int mode, path;
  switch (form) {
    case F_GLOBAL: mode = M_GLOBAL; path = 2; break;
    case F_SHARED: mode = M_CTA; path = 1; break;
    case F_WARP: mode = M_WARP; path = 0; break;
    case F_WINDOWED:  // the resident mode
      if (args->band != args->Sc) return cudaErrorInvalidValue;
      mode = M_CTA;
      path = P_RESIDENT;
      break;
    default: return cudaErrorInvalidValue;
  }
  const int nt = mode == M_WARP ? TT / 32 : (mode == M_CTA ? 1 : 0);
  const size_t shm = (size_t)nt * args->Sc * slot;
  err = cudaFuncSetAttribute(dense_scan_tiles<CG, TIME, HEAD, MASK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)shm);
  if (err != cudaSuccess) return err;
  dense_scan_tiles<CG, TIME, HEAD, MASK><<<grid, TT, shm, s>>>(*args, mode,
                                                                path);
  return cudaGetLastError();
}

template <bool CG, bool TIME, bool HEAD>
cudaError_t launch_mask(const DenseScanArgs* args, int form, int grid,
                        cudaStream_t s) {
  return args->mask ? launch_form<CG, TIME, HEAD, true>(args, form, grid, s)
                    : launch_form<CG, TIME, HEAD, false>(args, form, grid, s);
}

template <bool CG>
cudaError_t launch_cg(const DenseScanArgs* args, int form, int grid,
                      cudaStream_t s) {
  const bool head = args->desc.n <= DESC_HEAD;
  if (args->has_time)
    return head ? launch_mask<CG, true, true>(args, form, grid, s)
                : launch_mask<CG, true, false>(args, form, grid, s);
  return head ? launch_mask<CG, false, true>(args, form, grid, s)
              : launch_mask<CG, false, false>(args, form, grid, s);
}

}  // namespace

// Copies the descriptor block, zeroes sums, spill and the chunk counter
// (one block of words: spill follows the [Sc, L] sums, the counter
// follows spill) and sets the min/max tables to their sentinels on
// `stream`, then launches one form (F_*): the tiled kernel with the
// global tables (0), one shared table a CTA (1) or one a warp (3), or the
// windowed form (2: band slots of narrow lanes in shared memory, chunk
// rows a chunk; chunk 0 is the resident mode, band = Sc, which runs the
// tiled kernel with one table a CTA).  Each writes the matched mask when
// `mask` is set, and makes key 0 the cache-group key when vg_span > 0 (a
// power of two; with at least one key).  Takes fewer than 2^31 rows (the
// shared tables' 32-bit lanes).  Returns cudaError_t.
extern "C" int dense_scan(const DenseScanArgs* args, int form, int grid,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t tabn = (size_t)args->Sc * args->L;
  const size_t tab_bytes = tabn * sizeof(unsigned long long);
  if (args->spill != args->sums + tabn || args->counter != args->spill + 1)
    return cudaErrorInvalidValue;
  cudaError_t err = desc_upload(args->desc, s);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(args->sums, 0, tab_bytes + 2 * sizeof(long long), s);
  if (err != cudaSuccess) return err;
  const int mmn = args->Sc * args->H;
  if (mmn > 0) {
    fill_bounds<<<(mmn + THREADS - 1) / THREADS, THREADS, 0, s>>>(
        args->mins, args->maxs, mmn);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (args->vg_span < 0 || (args->vg_span & (args->vg_span - 1)) ||
      (args->vg_span > 0 && args->nkeys < 1))
    return cudaErrorInvalidValue;
  return args->vg_span > 0 ? launch_cg<true>(args, form, grid, s)
                           : launch_cg<false>(args, form, grid, s);
}
