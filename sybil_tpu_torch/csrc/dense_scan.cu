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
// max are signed 64-bit atomics; a thread reads the current bound first
// and skips the atomic when its value cannot change it (bounds only
// move one way, so a stale read only costs an extra atomic).  Empty
// slots keep the reference's sentinels, +2^62 and -2^62.  Unmatched
// rows add nothing (every lane is masked by `matched`, and spills only
// count matched rows), so they are skipped.  The reference's byte-limb
// encoding (lane_limbs8), f32 min/max and one-hot matmuls are TPU
// devices and do not apply: all give the same int64 results.  Three
// forms, the same words:
//   shared   a grid-stride loop, one row per thread per step; each CTA
//            accumulates private copies of the [Sc, L] sums and [Sc, H]
//            min/max tables in shared memory and merges them into the
//            global tables once (tables up to 200 KB);
//   global   the same loop updating the global tables directly;
//   windowed a rollup's table is often larger than a CTA's shared
//            memory in 64-bit lanes (config 4: 6,784 slots x 5 lanes =
//            271 KB).  A 64-bit shared atomicAdd compiles to a CAS spin
//            loop (ATOMS.CAST.SPIN.64; sybil_tpu_torch/k2_ab.py --trace),
//            which a time-sorted chunk (one or two hours: about 9
//            distinct slots) makes every warp contend on, and a chunk of
//            rows in arrival order spans every slot, so a band sized to
//            the bind's window is swept many times (PERF.md row 15b).  So
//            this form keeps narrow lanes (two native 32-bit atomics for
//            a 64-bit sum), combines a warp's equal slots before it
//            touches shared memory, holds the whole reduce space in one
//            table a CTA when it fits (34 bytes a slot or fewer at config
//            4's 6,784 slots: config 4 takes 20), and otherwise sizes each
//            chunk's sweep to its live span or sends a sparse chunk
//            straight to the global tables; see "the windowed form"
//            below.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "desc.cuh"
#include "filters.cuh"

namespace {

constexpr int THREADS = 256;
constexpr long long BIG = 1ll << 62;
constexpr int FV_SMEM = 16;  // filter constants staged in shared memory

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

// The reference's _trunc_div for d > 0, in the width of T: q = |x| // d
// (floor division; |x| wraps at T's minimum as jnp.abs does), then
// x >= 0 ? q : -q, wrapping.
template <typename T, typename U>
__device__ __forceinline__ T go_trunc_div(T x, T d) {
  const T ax = x < 0 ? static_cast<T>(U(0) - static_cast<U>(x)) : x;
  T q = ax / d;
  if (ax < 0 && q * d != ax) --q;  // floor for the one negative |x|
  return x >= 0 ? q : static_cast<T>(U(0) - static_cast<U>(q));
}

// Row r's match and reduce-space gid (s_fv: the first FV_SMEM filter
// constants).  Returns false for an unmatched row (gid and spill
// untouched).  CG (key 0 is the cache-group key) and TIME (the time key
// comes next) are template parameters and their digits are peeled off
// the key loop: a branch on the time key inside the loop made K2 a third
// slower or more on scans without one (sybil_tpu_torch/k2_ab.py on the
// H100).  So is HEAD, where the descriptor block lies (desc.cuh).
template <bool CG, bool TIME, bool HEAD>
__device__ __forceinline__ bool row_gid(const DenseScanArgs& a, long long r,
                                        const long long* s_fv, int* gid_out,
                                        bool* spill_out) {
  const long long cmask = (1ll << a.log2C) - 1;
  bool matched = (r & cmask) < a.nrec[r >> a.log2C];
  // the staged constants first, the rest (past FV_SMEM) from global
  const int nfs = min(a.nfilters, FV_SMEM);
  for (int i = 0; matched && i < nfs; ++i)
    matched = passes<HEAD>(a, i, r, s_fv[i]);
  for (int i = FV_SMEM; matched && i < a.nfilters; ++i)
    matched = passes<HEAD>(a, i, r, a.filter_vals[i]);
  if (TIME && matched) matched = a.t_valid[r] != 0;
  if (!matched) return false;
  int gid = 0;
  bool spilled = false;
  int first = 0;
  if (CG) {
    const long long k = r >> (a.log2C + __ffs(a.vg_span) - 1);
    const long long mn = desc_at<HEAD>(a.desc, a.key_min, 0);
    const long long card = desc_at<HEAD>(a.desc, a.key_card, 0);
    const long long digit =
        (long long)((unsigned long long)k - (unsigned long long)mn + 1ull);
    spilled = (k < mn) |
              (k >= (long long)((unsigned long long)mn +
                                (unsigned long long)card));
    gid = (int)(digit < 0 ? 0 : (digit > card ? card : digit));
    first = 1;
  }
  if (TIME) {
    const long long mn = desc_at<HEAD>(a.desc, a.key_min, first);
    const long long card = desc_at<HEAD>(a.desc, a.key_card, first);
    const long long t = a.t_vals[r];
    long long q, digit;
    if (a.time_i32) {
      const int q32 = go_trunc_div<int, unsigned>(static_cast<int>(t),
                                                  static_cast<int>(a.tb));
      q = q32;
      // int32 like the reference's digit q - mn + 1
      digit = static_cast<int>(static_cast<unsigned>(q32) -
                               static_cast<unsigned>(mn) + 1u);
    } else {
      q = go_trunc_div<long long, unsigned long long>(t, a.tb);
      digit = (long long)((unsigned long long)q - (unsigned long long)mn +
                          1ull);
    }
    spilled |= (q < mn) | (q >= mn + card);
    gid = gid * (int)(card + 1) +
          (int)(digit < 0 ? 0 : (digit > card ? card : digit));
    ++first;
  }
  for (int i = first; i < a.nkeys; ++i) {
    const long long k = desc_at<HEAD>(a.desc, a.key_valid, i)[r]
                            ? desc_at<HEAD>(a.desc, a.key_vals, i)[r] : -1ll;
    const long long mn = desc_at<HEAD>(a.desc, a.key_min, i);
    const long long card = desc_at<HEAD>(a.desc, a.key_card, i);
    long long digit = 0;
    if (k != -1ll) {
      digit = (long long)((unsigned long long)k - (unsigned long long)mn
                          + 1ull);
      const long long hi =
          (long long)((unsigned long long)mn + (unsigned long long)card);
      spilled |= (k < mn) | (k >= hi);
    }
    digit = digit < 0 ? 0 : (digit > card ? card : digit);
    gid = gid * (int)(card + 1) + (int)digit;
  }
  // a matched row's gid is below g <= Sc-1, the dead row
  *gid_out = gid;
  *spill_out = spilled;
  return true;
}

// Adds matched row r's lanes to `row` ([L] sums) and its kept values to
// `mn`/`mx` ([H] min and max) of its slot.
template <bool HEAD>
__device__ __forceinline__ void accumulate(const DenseScanArgs& a,
                                           long long r,
                                           unsigned long long* row,
                                           long long* mn, long long* mx) {
  unsigned long long w = 1ull;
  if (a.has_weight && a.w_valid[r]) w = (unsigned long long)a.w_vals[r];
  if (w) atomicAdd(row, w);
  atomicAdd(row + 1, 1ull);
  for (int ai = 0; ai < a.naggs; ++ai) {
    if (!desc_at<HEAD>(a.desc, a.agg_valid, ai)[r]) continue;
    const long long v = desc_at<HEAD>(a.desc, a.agg_vals, ai)[r];
    atomicAdd(row + 2 + 3 * ai, 1ull);
    if (v > desc_at<HEAD>(a.desc, a.agg_dmax, ai) ||
        v < desc_at<HEAD>(a.desc, a.agg_dmin, ai))
      continue;  // not kept
    const int mm = (int)desc_at<HEAD>(a.desc, a.agg_mm, ai);
    if (mm >= 0) {
      if (v < *(volatile long long*)(mn + mm)) atomicMin(mn + mm, v);
      if (v > *(volatile long long*)(mx + mm)) atomicMax(mx + mm, v);
    }
    if (!w) continue;
    atomicAdd(row + 3 + 3 * ai, w);
    const unsigned long long kwv =
        w * ((unsigned long long)v -
             (unsigned long long)desc_at<HEAD>(a.desc, a.agg_bias, ai));
    if (kwv) atomicAdd(row + 4 + 3 * ai, kwv);
  }
}

// At most 32 registers a thread, so the 8 CTAs a SM that the wrapper's
// grid assumes fit: left free, the descriptor offsets hoisted out of the
// row loop took 48, 5 CTAs fit, and K2 ran 19% (config 1's shape) and
// 63% (config 3's) slower, a second wave included (k2_ab.py on the H100).
template <bool SHARED, bool CG, bool TIME, bool HEAD, bool MASK>
__global__ void __launch_bounds__(THREADS, 8) dense_scan_kernel(
    const DenseScanArgs a) {
  extern __shared__ __align__(16) unsigned long long s_tab[];
  __shared__ unsigned long long s_spill;
  __shared__ long long s_fv[FV_SMEM];
  const int tabn = a.Sc * a.L;
  const int mmn = a.Sc * a.H;
  long long* s_min = reinterpret_cast<long long*>(s_tab + tabn);
  long long* s_max = s_min + mmn;
  if (SHARED) {
    for (int i = threadIdx.x; i < tabn; i += THREADS) s_tab[i] = 0ull;
    for (int i = threadIdx.x; i < mmn; i += THREADS) {
      s_min[i] = BIG;
      s_max[i] = -BIG;
    }
  }
  if (threadIdx.x < min(a.nfilters, FV_SMEM))
    s_fv[threadIdx.x] = a.filter_vals[threadIdx.x];
  if (threadIdx.x == 0) s_spill = 0ull;
  __syncthreads();
  unsigned long long* tab = SHARED ? s_tab : a.sums;
  long long* mins = SHARED ? s_min : a.mins;
  long long* maxs = SHARED ? s_max : a.maxs;
  unsigned long long my_spill = 0ull;

  for (long long r = (long long)blockIdx.x * THREADS + threadIdx.x;
       r < a.R; r += (long long)gridDim.x * THREADS) {
    int gid;
    bool spilled;
    const bool matched =
        row_gid<CG, TIME, HEAD>(a, r, s_fv, &gid, &spilled);
    if (MASK) a.mask[r] = matched;
    if (!matched) {
      if (a.gid_out) a.gid_out[r] = a.Sc - 1;
      continue;
    }
    if (a.gid_out) a.gid_out[r] = gid;
    my_spill += spilled;
    accumulate<HEAD>(a, r, tab + (size_t)gid * a.L,
                     mins + (size_t)gid * a.H, maxs + (size_t)gid * a.H);
  }
  if (my_spill) atomicAdd(&s_spill, my_spill);
  __syncthreads();
  if (SHARED) {
    for (int i = threadIdx.x; i < tabn; i += THREADS)
      if (s_tab[i]) atomicAdd(a.sums + i, s_tab[i]);
    for (int i = threadIdx.x; i < mmn; i += THREADS) {
      if (s_min[i] != BIG) atomicMin(a.mins + i, s_min[i]);
      if (s_max[i] != -BIG) atomicMax(a.maxs + i, s_max[i]);
    }
  }
  if (threadIdx.x == 0 && s_spill) atomicAdd(a.spill, s_spill);
}

// ---- the windowed form --------------------------------------------------
//
// One CTA of WT threads a SM.  A shared table holds the slots the CTA
// accumulates into in narrow lanes (WinLayout): a lane that adds 0 or 1
// a row (the count, each aggregation's exists, and w and kw when there is
// no weight column, where they equal the count and the kept count) is one
// 32-bit word, a lane of 64-bit sums two words (lo, hi) added by two
// native 32-bit shared atomics with the carry taken from the returned old
// low word.  A 64-bit shared atomicAdd compiles to a CAS spin loop
// (ATOMS.CAST.SPIN.64 on sm_90a); two 32-bit ones do not spin.  Rows are
// combined a warp at a time first: __match_any_sync groups the warp's
// equal slots, 0/1 lanes are counted by ballot and popc, the 64-bit lanes
// and the min/max are reduced over the group by shuffles (reduce_peers),
// and one leader a group touches the table.  Modes (a.chunk):
//   resident (chunk 0)  the whole reduce space fits: the table covers
//            every slot, each CTA strides over rows (an equal share each)
//            and flushes its non-zero entries to the global tables once;
//   per chunk  otherwise: a CTA takes chunks of `chunk` rows from an
//            atomic counter, stages their gids in shared memory with the
//            live span [lo, hi] and the live count, then
//            full-span  (span <= band) zeroes span slots, accumulates,
//                       flushes them;
//            banded     (span > band, at least 2 live rows a slot) sweeps
//                       the span in bands of `band` slots;
//            direct     (sparser) adds each warp group straight to the
//                       global tables, as the global form does.
// a.paths (optional, [5]) counts resident CTAs and full-span, banded,
// direct and empty chunks: the checks read which paths ran.

constexpr int WT = 1024;             // the windowed form's threads
constexpr unsigned FULL = 0xffffffffu;

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

// Adds the warp's rows to their slots.  Each lane holds row r; `key` is
// its slot in the shared table (GLOBAL: its gid in a.sums), -1 for a row
// that adds nothing here.  Every lane of the warp calls it.
template <bool HEAD, bool GLOBAL>
__device__ __forceinline__ void warp_add(const DenseScanArgs& a,
                                         const WinLayout& w, long long r,
                                         int key, unsigned* s_tab,
                                         long long* s_min, long long* s_max) {
  const bool live = key >= 0;
  const unsigned peers = __match_any_sync(FULL, key);
  const bool lead = live && (threadIdx.x & 31) == __ffs(peers) - 1;
  const unsigned n = __popc(peers);
  unsigned long long wt = 1ull;
  if (w.hw && live && a.w_valid[r]) wt = (unsigned long long)a.w_vals[r];
  unsigned* p = s_tab + (size_t)(live ? key : 0) * w.sw;
  unsigned long long* row = a.sums + (size_t)(live ? key : 0) * a.L;
  unsigned long long sw = n;
  if (w.hw) sw = reduce_peers(peers, live ? wt : 0ull, OpAdd());
  if (lead) {
    if (GLOBAL) {
      if (sw) atomicAdd(row, sw);
      atomicAdd(row + 1, (unsigned long long)n);
    } else {
      if (w.hw) add64(p, sw);
      atomicAdd(p + w.cw, n);
    }
  }
  for (int ai = 0; ai < a.naggs; ++ai) {
    const bool ex = live && desc_at<HEAD>(a.desc, a.agg_valid, ai)[r];
    const long long v = ex ? desc_at<HEAD>(a.desc, a.agg_vals, ai)[r] : 0ll;
    const bool kept = ex && !(v > desc_at<HEAD>(a.desc, a.agg_dmax, ai) ||
                              v < desc_at<HEAD>(a.desc, a.agg_dmin, ai));
    const unsigned nex = __popc(__ballot_sync(FULL, ex) & peers);
    unsigned long long kw;
    if (w.hw)
      kw = reduce_peers(peers, kept ? wt : 0ull, OpAdd());
    else
      kw = __popc(__ballot_sync(FULL, kept) & peers);
    const unsigned long long kwv = reduce_peers(
        peers,
        kept ? wt * ((unsigned long long)v -
                     (unsigned long long)desc_at<HEAD>(a.desc, a.agg_bias,
                                                       ai))
             : 0ull,
        OpAdd());
    if (lead) {
      if (GLOBAL) {
        unsigned long long* g = row + 2 + 3 * ai;
        if (nex) atomicAdd(g, (unsigned long long)nex);
        if (kw) atomicAdd(g + 1, kw);
        if (kwv) atomicAdd(g + 2, kwv);
      } else {
        unsigned* q = p + w.cw + 1 + ai * w.pa;
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
    const int mm = (int)desc_at<HEAD>(a.desc, a.agg_mm, ai);
    if (mm >= 0) {
      const long long mn = reduce_peers(peers, kept ? v : BIG, OpMin());
      const long long mx = reduce_peers(peers, kept ? v : -BIG, OpMax());
      if (lead) {
        long long* gmn = GLOBAL ? a.mins : s_min;
        long long* gmx = GLOBAL ? a.maxs : s_max;
        const size_t o = (size_t)key * a.H + mm;
        if (mn < *(volatile long long*)(gmn + o)) atomicMin(gmn + o, mn);
        if (mx > *(volatile long long*)(gmx + o)) atomicMax(gmx + o, mx);
      }
    }
  }
}

__device__ __forceinline__ void band_zero(const WinLayout& w, int H,
                                          unsigned* s_tab, long long* s_min,
                                          long long* s_max, int nslots) {
  for (int i = threadIdx.x; i < nslots * w.sw; i += WT) s_tab[i] = 0u;
  for (int i = threadIdx.x; i < nslots * H; i += WT) {
    s_min[i] = BIG;
    s_max[i] = -BIG;
  }
}

// The non-empty entries of slots [b0, b0 + nslots) to the global tables.
__device__ __forceinline__ void band_flush(const DenseScanArgs& a,
                                           const WinLayout& w,
                                           const unsigned* s_tab,
                                           const long long* s_min,
                                           const long long* s_max, int b0,
                                           int nslots) {
  const int L = a.L;
  for (int i = threadIdx.x; i < nslots * L; i += WT) {
    const int s = i / L, j = i - s * L;
    const unsigned long long v = lane_value(w, s_tab + (size_t)s * w.sw, j);
    if (v) atomicAdd(a.sums + (size_t)(b0 + s) * L + j, v);
  }
  for (int i = threadIdx.x; i < nslots * a.H; i += WT) {
    if (s_min[i] != BIG) atomicMin(a.mins + (size_t)b0 * a.H + i, s_min[i]);
    if (s_max[i] != -BIG) atomicMax(a.maxs + (size_t)b0 * a.H + i, s_max[i]);
  }
}

enum { P_RESIDENT, P_FULL_SPAN, P_BANDED, P_DIRECT, P_EMPTY };

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

  if (a.chunk == 0) {
    // resident: the table covers the reduce space
    band_zero(w, H, s_tab, s_min, s_max, a.Sc);
    __syncthreads();
    for (long long r0 = (long long)blockIdx.x * WT + (threadIdx.x & ~31);
         r0 < a.R; r0 += (long long)gridDim.x * WT) {
      const long long r = r0 + lane;
      int key = -1;
      if (r < a.R) {
        int gid;
        bool spilled;
        const bool matched =
            row_gid<CG, TIME, HEAD>(a, r, s_fv, &gid, &spilled);
        if (MASK) a.mask[r] = matched;
        if (a.gid_out) a.gid_out[r] = matched ? gid : a.Sc - 1;
        if (matched) {
          my_spill += spilled;
          key = gid;
        }
      }
      warp_add<HEAD, false>(a, w, r, key, s_tab, s_min, s_max);
    }
    __syncthreads();
    band_flush(a, w, s_tab, s_min, s_max, 0, a.Sc);
    if (a.paths && threadIdx.x == 0) atomicAdd(a.paths + P_RESIDENT, 1ull);
  } else {
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
        bool spilled;
        const bool matched =
            row_gid<CG, TIME, HEAD>(a, rc + i, s_fv, &gid, &spilled);
        if (MASK) a.mask[rc + i] = matched;
        if (a.gid_out) a.gid_out[rc + i] = matched ? gid : a.Sc - 1;
        if (matched) {
          my_spill += spilled;
          lo = min(lo, gid);
          hi = max(hi, gid);
          ++nl;
        } else {
          gid = -1;
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
            warp_add<HEAD, false>(a, w, rc + i,
                                  g >= b0 && g < b0 + nb ? g - b0 : -1,
                                  s_tab, s_min, s_max);
          }
          __syncthreads();
          band_flush(a, w, s_tab, s_min, s_max, b0, nb);
          __syncthreads();  // the band is free again
        }
      } else {
        path = P_DIRECT;
        for (int i0 = threadIdx.x & ~31; i0 < n; i0 += WT) {
          const int i = i0 + lane;
          warp_add<HEAD, true>(a, w, rc + i, i < n ? s_gid[i] : -1, s_tab,
                               s_min, s_max);
        }
      }
      if (a.paths && threadIdx.x == 0) atomicAdd(a.paths + path, 1ull);
      __syncthreads();  // every thread has read s_chunk, s_lo, s_hi
    }
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

template <bool CG, bool TIME, bool HEAD, bool MASK>
cudaError_t launch_form(const DenseScanArgs* args, int form, int grid,
                        size_t tab_bytes, size_t mm_bytes, cudaStream_t s) {
  cudaError_t err;
  if (form == 2) {
    const int sw = (args->has_weight ? 2 : 0) + 1 +
                   args->naggs * (args->has_weight ? 5 : 4);
    if (args->band <= 0 || args->chunk < 0 || args->band > args->Sc ||
        (args->chunk == 0 && args->band != args->Sc) ||
        (args->chunk > 0 && !args->counter) || args->R >= (1ll << 31))
      return cudaErrorInvalidValue;
    const size_t shm = (size_t)args->band * (16 * args->H + 4 * sw) +
                       (size_t)args->chunk * sizeof(int);
    err = cudaFuncSetAttribute(dense_scan_windowed<CG, TIME, HEAD, MASK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)shm);
    if (err != cudaSuccess) return err;
    dense_scan_windowed<CG, TIME, HEAD, MASK><<<grid, WT, shm, s>>>(*args);
  } else if (form == 1) {
    const size_t shm = tab_bytes + mm_bytes;
    err = cudaFuncSetAttribute(
        dense_scan_kernel<true, CG, TIME, HEAD, MASK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
    if (err != cudaSuccess) return err;
    dense_scan_kernel<true, CG, TIME, HEAD, MASK><<<grid, THREADS, shm, s>>>(
        *args);
  } else if (form == 0) {
    dense_scan_kernel<false, CG, TIME, HEAD, MASK><<<grid, THREADS, 0, s>>>(
        *args);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <bool CG, bool TIME, bool HEAD>
cudaError_t launch_mask(const DenseScanArgs* args, int form, int grid,
                        size_t tab_bytes, size_t mm_bytes, cudaStream_t s) {
  return args->mask
             ? launch_form<CG, TIME, HEAD, true>(args, form, grid, tab_bytes,
                                                 mm_bytes, s)
             : launch_form<CG, TIME, HEAD, false>(args, form, grid,
                                                  tab_bytes, mm_bytes, s);
}

template <bool CG>
cudaError_t launch_cg(const DenseScanArgs* args, int form, int grid,
                      size_t tab_bytes, size_t mm_bytes, cudaStream_t s) {
  const bool head = args->desc.n <= DESC_HEAD;
  if (args->has_time)
    return head ? launch_mask<CG, true, true>(args, form, grid, tab_bytes,
                                              mm_bytes, s)
                : launch_mask<CG, true, false>(args, form, grid, tab_bytes,
                                               mm_bytes, s);
  return head ? launch_mask<CG, false, true>(args, form, grid, tab_bytes,
                                             mm_bytes, s)
              : launch_mask<CG, false, false>(args, form, grid, tab_bytes,
                                              mm_bytes, s);
}

}  // namespace

// Copies the descriptor block, zeroes sums, spill and the chunk counter
// (one block of words: spill follows the [Sc, L] sums, the counter
// follows spill) and sets the min/max tables to their sentinels on
// `stream`, then launches one form: 0 global atomics, 1 per-CTA shared
// tables, 2 windowed (band slots of narrow lanes in shared memory; chunk
// rows a chunk, or 0 for the resident table, band = Sc); each writes the
// matched mask when `mask` is set, and makes key 0 the cache-group key
// when vg_span > 0 (a power of two; with at least one key).  Returns
// cudaError_t.
extern "C" int dense_scan(const DenseScanArgs* args, int form, int grid,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t tabn = (size_t)args->Sc * args->L;
  const size_t tab_bytes = tabn * sizeof(unsigned long long);
  const size_t mm_bytes = (size_t)args->Sc * args->H * 2 * sizeof(long long);
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
  return args->vg_span > 0
             ? launch_cg<true>(args, form, grid, tab_bytes, mm_bytes, s)
             : launch_cg<false>(args, form, grid, tab_bytes, mm_bytes, s);
}
