// K9 hist_pairs: the sparse histogram pairs of the sorted scan strategy,
// for one histogram aggregation, in two entry points around a stable sort
// of the pair keys.
//
// hist_prep replaces sybil_tpu/ops/scan.py:_hist_bucket (the bucket math
// of K4, dense_hist.cu, copied: basic buckets, or the multihist's
// sub-ranges top range first with a value that overflows its sub's
// buckets folded into its last bucket AND flagged) and _scan_sorted
// 1247-1255 and 1267-1271, per row in sorted order (K8's sidxm and gid):
//   hcontrib = contributes (matched, gid below the cap), kept (populated,
//              inside the discard bounds) and in a bucket range;
//   pairkey  = gid * nv + bucket where hcontrib, else (S+1) * nv: int32
//              when (S+1) * nv < 2^31 (key32), else int64.  The map
//              between the two widths is monotone, so the stable sort
//              between the entries gives the same order from 4-byte keys;
//   w        = with a weight column, the row's weight where hcontrib,
//              else 0.  Without one it is not written: every hcontrib row
//              weighs 1, so hist_pairs counts the rows;
//   outliers = hcontrib rows whose bucket overflowed: mask, value (else
//              0) and count, in sorted order (K5 compacts them with kmat).
//
// hist_pairs replaces _scan_sorted 1256-1266 after the sort (spk, si2):
//   hp_mask  = the first row of each pair-key segment below the sentinel,
//              for every row;
//   npairs   = the number of those rows;
// and at the rows hp_mask sets and at row R-1 only (the packed section's
// padding rows repeat row R-1):
//   hp_bv    = spk % nv at a set row, else 0;
//   hp_w     = the segment's weight sum (its row count without a weight
//              column) at a set row, else 0;
//   hp_keys  = kmat[si2].
// Every other row of hp_bv, hp_w and hp_keys is left unwritten: their
// readers (K10's pair sections, the plain pack, fetch_hist_pairs) read
// them at set rows and at row R-1 only.
//
// Bound: memory.  hist_prep reads sidxm, writes the pair key (4 or 8 B a
// row; with a weight column 8 B of w, with outliers 9 B), and reads gid
// and gathers the value, its valid byte (and the weight) at the sorted
// row for matched rows only, which K8 sorts first.  hist_pairs reads the
// sorted key (4 or 8 B) and writes one mask byte a row; with a weight
// column it also reads si2 and gathers w for the rows below the sentinel.
//
// What a trace of the former design showed (torch.profiler on the H100;
// PERF.md §6): hist_prep a 116 us kernel writing an int64 key and an
// int64 weight for every row, with a 64-bit shared atomic (a CAS loop)
// for the outlier count after a memset; the int64 key's stable sort 0.98
// ms in 22 operations; hist_pairs five operations (a memset, a count of
// each tile's segment starts, a one-CTA scan of the counts, a pass that
// wrote hp_bv, hp_w and hp_keys for every row with 8 B a row of segment
// scratch, and a pass of 64-bit atomics adding the weights), 265 us.
//
// Design of hist_prep: one launch, no memset.  A thread takes 4
// consecutive rows a step (16-byte loads and stores); a step of
// unmatched rows (sidxm's sign bit clear) reads no gid and gathers
// nothing.  With outliers tracked each CTA writes its count to its word
// of `part`, and the last CTA to finish, by an atomicInc on a counter
// that wraps back to 0 at the grid's last CTA (so it is 0 again for the
// next call on the stream), adds them into nout.
//
// Design of hist_pairs: one launch after one memset (npairs, a ticket and
// a status word a tile).  A CTA takes a TILE-row tile by the ticket, so
// every tile before it has started.  In CHUNKS steps a thread takes 16
// consecutive rows (16-byte loads), finds the segment starts and ends
// from the keys (its neighbours' by a shuffle), writes hp_mask (one
// 16-byte store) and sums each segment's weights; a thread whose 16 rows
// lie inside one segment, most of them, only counts or adds.  A segmented
// block scan carries the open segment (its first row and partial sum)
// from thread to thread and chunk to chunk, and the thread that holds a
// segment's last row stores its sum at its first row: a plain store,
// exact mod 2^64, no atomics.  A segment that began in an earlier tile: each tile publishes
// its open segment (first row and partial sum: an inclusive prefix where
// the tile holds a segment boundary, else an aggregate of its whole sum)
// as soon as its rows are done, and the one tile that holds the segment's
// last row walks back over the published words (warp 0, 32 x LB tiles a
// step, lookback.cuh's loads) to the nearest inclusive prefix.  A tile
// never waits on its own walk to publish, so no walk waits on another.

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

using lookback::FULL;
using lookback::ld_relaxed;
using lookback::st_release;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PREP_ROWS = 4;              // hist_prep: rows a thread a step
constexpr int ROWS_T = 16;                // hist_pairs: rows a thread a chunk
constexpr int CHUNK = THREADS * ROWS_T;   // 4,096
// chunks a tile: one (tiles of 4,096 rows) was faster than two or four
// (kernel_variants.py's k9 tile variants, PERF.md §6)
constexpr int CHUNKS = 1;
constexpr int TILE = CHUNK * CHUNKS;      // rows a CTA
constexpr int MAXSUB = 64;
constexpr int LB = 4;                     // look-back words a lane
// a tile's status word: 0 until published, then the inclusive-prefix
// flag with the first row of the tile's open segment in the low bits, or
// the aggregate flag (the tile holds no segment boundary)
constexpr unsigned long long PREFIX_BIT = 1ull << 63;
constexpr unsigned long long AGG_BIT = 1ull << 62;
constexpr unsigned long long START_MASK = (1ull << 32) - 1;
// hist_pairs' scratch words, zeroed by the entry: npairs (the output),
// the ticket, then a status word a tile
constexpr int S_NPAIRS = 0;
constexpr int S_TICKET = 1;
constexpr int S_STATUS = 2;
// a.paths (optional) counts, for the checks: tiles that walked back for
// the carry of a segment begun in an earlier tile, and walks past one
// window of 32 x LB tiles
enum { P_WALK, P_DEEP };

}  // namespace

// Mirrored field for field by HistPairsArgs in ops/scan.py (ctypes).
struct HistPairsArgs {
  const int* sidxm;              // [R] K8: sorted row index | matched bit
  const int* gid;                // [R] K8: gid of each sorted row
  const long long* vals;         // [R] the aggregation's column
  const unsigned char* valid;
  const long long* w_vals;       // weight column or null
  const unsigned char* w_valid;
  void* pairkey;                 // [R] hist_prep out, int32 (key32) or int64
  long long* w;                  // [R] hist_prep out, hist_pairs in; null
                                 // without a weight column
  unsigned char* out_mask;       // [R] or null (no outlier tracking)
  long long* out_val;            // [R] or null
  long long* nout;               // [1] or null
  unsigned long long* part;      // [grid] each CTA's outlier count
  unsigned int* done;            // CTAs done, 0 between calls
  const void* spk;               // [R] sorted pair keys (hist_pairs in)
  const long long* si2;          // [R] their sort indices
  const long long* kmat;         // [R, K] K8's sorted keys
  unsigned char* hp_mask;        // [R]
  long long* hp_bv;              // [R], set rows and R-1
  long long* hp_w;               // [R], set rows and R-1
  long long* hp_keys;            // [R, K], set rows and R-1
  unsigned long long* scratch;   // [S_STATUS + ntiles], zeroed by the entry
  unsigned long long* tsum;      // [ntiles] each tile's published sum
  unsigned long long* paths;     // [2] P_WALK, P_DEEP, or null
  long long sub_min[MAXSUB];
  long long sub_max[MAXSUB];
  long long sub_bs[MAXSUB];
  long long sub_nv[MAXSUB];
  long long sub_off[MAXSUB];
  long long R;
  long long hist_min;
  long long bucket_size;
  long long dmin;
  long long dmax;
  long long nv;
  long long sent_pk;             // (S+1) * nv
  int S;
  int K;
  int nsub;                      // 0 = basic layout
  int ntiles;
  int key32;                     // pair keys are int32
  int pad_;
};

namespace {

// Value v's bucket (*bv) and overflow flag, or false where it adds to no
// bucket: outside the discard bounds or every sub-range.
__device__ __forceinline__ bool bucket_of(const HistPairsArgs& a,
                                          long long v, long long* bv,
                                          bool* is_out) {
  if (v > a.dmax || v < a.dmin) return false;
  if (a.nsub == 0) {
    const long long raw =
        (long long)((unsigned long long)v - (unsigned long long)a.hist_min)
        / a.bucket_size;
    *is_out = raw >= a.nv;
    *bv = raw < 0 ? 0 : (raw > a.nv - 1 ? a.nv - 1 : raw);
    return true;
  }
  for (int s = 0; s < a.nsub; ++s) {
    if (v < a.sub_min[s] || v > a.sub_max[s]) continue;
    const long long raw =
        (long long)((unsigned long long)v - (unsigned long long)a.sub_min[s])
        / a.sub_bs[s];
    const long long snv = a.sub_nv[s];
    *is_out = raw >= snv;
    *bv = (raw < 0 ? 0 : (raw > snv - 1 ? snv - 1 : raw)) + a.sub_off[s];
    return true;
  }
  return false;
}

// Four consecutive words, by 16-byte stores or one at a time (the first
// n).  Every index is a constant after unrolling, so the words stay in
// registers.
__device__ __forceinline__ void store4(long long* p, const long long* v,
                                       bool full, int n) {
  if (full) {
    reinterpret_cast<longlong2*>(p)[0] = make_longlong2(v[0], v[1]);
    reinterpret_cast<longlong2*>(p)[1] = make_longlong2(v[2], v[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < PREP_ROWS; ++j)
    if (j < n) p[j] = v[j];
}

__device__ __forceinline__ void store4(int* p, const int* v, bool full,
                                       int n) {
  if (full) {
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < PREP_ROWS; ++j)
    if (j < n) p[j] = v[j];
}

__device__ __forceinline__ void load4(const int* p, int* v, bool full,
                                      int n) {
  if (full) {
    const int4 q = __ldcs(reinterpret_cast<const int4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < PREP_ROWS; ++j)
    if (j < n) v[j] = p[j];
}

// TRACK: outliers tracked; HAS_W: a weight column.
template <typename KeyT, bool HAS_W, bool TRACK>
__global__ void __launch_bounds__(THREADS) prep_kernel(const HistPairsArgs a) {
  KeyT* const pk = static_cast<KeyT*>(a.pairkey);
  const KeyT sent = static_cast<KeyT>(a.sent_pk);
  // 16-byte accesses where every array allows them
  const bool vec = (((uintptr_t)a.sidxm | (uintptr_t)a.gid | (uintptr_t)pk |
                     (uintptr_t)a.w | (uintptr_t)a.out_val) & 15) == 0 &&
                   ((uintptr_t)a.out_mask & 3) == 0;
  unsigned long long my_nout = 0ull;
  const long long step = (long long)gridDim.x * THREADS * PREP_ROWS;
  for (long long i0 = ((long long)blockIdx.x * THREADS + threadIdx.x) *
                      PREP_ROWS;
       i0 < a.R; i0 += step) {
    const bool full = vec && i0 + PREP_ROWS <= a.R;
    const int n = a.R - i0 < PREP_ROWS ? (int)(a.R - i0) : PREP_ROWS;
    int m[PREP_ROWS] = {0, 0, 0, 0}, g[PREP_ROWS] = {0, 0, 0, 0};
    load4(a.sidxm + i0, m, full, n);
    // K8 sorts the unmatched rows (sign bit clear) last: their steps read
    // no gid and gather nothing.  The gid and the gathers depend on
    // sidxm alone, so they are in flight together.
    const bool any = (m[0] | m[1] | m[2] | m[3]) < 0;
    bool mt[PREP_ROWS];
    long long v[PREP_ROWS], wv[PREP_ROWS];
    unsigned char ok[PREP_ROWS], wok[PREP_ROWS];
#pragma unroll
    for (int j = 0; j < PREP_ROWS; ++j) {
      const long long r = m[j] & 0x7fffffff;
      mt[j] = m[j] < 0;
      ok[j] = mt[j] ? a.valid[r] : 0;
      v[j] = mt[j] ? a.vals[r] : 0ll;
      if (HAS_W) {
        wok[j] = mt[j] ? a.w_valid[r] : 0;
        wv[j] = mt[j] ? a.w_vals[r] : 0ll;
      }
    }
    if (any) load4(a.gid + i0, g, full, n);
    KeyT key[PREP_ROWS];
    long long wo[PREP_ROWS], ov[PREP_ROWS];
    unsigned om = 0u;
#pragma unroll
    for (int j = 0; j < PREP_ROWS; ++j) {
      long long bv = 0;
      bool is_out = false;
      const bool c = mt[j] && g[j] < a.S && ok[j] &&
                     bucket_of(a, v[j], &bv, &is_out);
      key[j] = c ? static_cast<KeyT>((long long)g[j] * a.nv + bv) : sent;
      if (HAS_W) wo[j] = c ? (wok[j] ? wv[j] : 1ll) : 0ll;
      if (TRACK) {
        const bool o = c && is_out;
        om |= (unsigned)o << (8 * j);
        ov[j] = o ? v[j] : 0ll;
        my_nout += o;
      }
    }
    store4(pk + i0, key, full, n);
    if (HAS_W) store4(a.w + i0, wo, full, n);
    if (TRACK) {
      if (full) {
        *reinterpret_cast<unsigned*>(a.out_mask + i0) = om;
      } else {
#pragma unroll
        for (int j = 0; j < PREP_ROWS; ++j)
          if (j < n) a.out_mask[i0 + j] = (om >> (8 * j)) & 1u;
      }
      store4(a.out_val + i0, ov, full, n);
    }
  }
  if (!TRACK) return;
  // the outlier count: this CTA's to its word of part, then the last CTA
  // to finish adds every CTA's into nout
  __shared__ unsigned long long s_sum[WARPS];
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = 16; d; d >>= 1) my_nout += __shfl_xor_sync(FULL, my_nout, d);
  if (lane == 0) s_sum[warp] = my_nout;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long c = 0ull;
    for (int w = 0; w < WARPS; ++w) c += s_sum[w];
    a.part[blockIdx.x] = c;
    __threadfence();
    // wraps to 0 at the grid's last CTA
    s_last = atomicInc(a.done, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  unsigned long long c = 0ull;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += THREADS)
    c += __ldcg(a.part + b);
  for (int d = 16; d; d >>= 1) c += __shfl_xor_sync(FULL, c, d);
  __syncthreads();
  if (lane == 0) s_sum[warp] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    c = 0ull;
    for (int w = 0; w < WARPS; ++w) c += s_sum[w];
    a.nout[0] = (long long)c;
  }
}

// The carry of a segmented sum over a span of rows: the first row of the
// segment open at the span's end and its sum so far (start >= 0: a
// segment starts or ends inside the span), or the span's whole sum
// (start < 0: the span lies inside a segment that began before it).
struct Carry {
  int start;
  unsigned long long sum;
};

// The carry over span x then span y.
__device__ __forceinline__ Carry combine(Carry x, Carry y) {
  return y.start >= 0 ? y : Carry{x.start, x.sum + y.sum};
}

// Each thread's carry in from the threads before it in the CTA, and the
// CTA's carry (*total, every thread alike): a warp scan by shuffles, then
// the warps' carries through shared memory.
__device__ __forceinline__ Carry block_carry(Carry c, Carry* total,
                                             Carry* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Carry inc = c;
  for (int d = 1; d < 32; d <<= 1) {
    const int s = __shfl_up_sync(FULL, inc.start, d);
    const unsigned long long u = __shfl_up_sync(FULL, inc.sum, d);
    if (lane >= d && inc.start < 0) {
      inc.start = s;
      inc.sum += u;
    }
  }
  Carry ex{__shfl_up_sync(FULL, inc.start, 1),
           __shfl_up_sync(FULL, inc.sum, 1)};
  if (lane == 0) ex = Carry{-1, 0ull};
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  Carry before{-1, 0ull}, all{-1, 0ull};
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    if (w == warp) before = all;
    all = combine(all, s_warp[w]);
  }
  *total = all;
  __syncthreads();
  return combine(before, ex);
}

// ROWS_T consecutive words from p: 16-byte loads, or one at a time (the
// first n words, the rest `fill`).  Every index is a constant after
// unrolling, so the words stay in registers.
__device__ __forceinline__ void load_rows(const int* p, int* out, bool full,
                                          int n, int fill) {
  if (full) {
#pragma unroll
    for (int k = 0; k < ROWS_T / 4; ++k) {
      const int4 q = reinterpret_cast<const int4*>(p)[k];
      out[4 * k] = q.x;
      out[4 * k + 1] = q.y;
      out[4 * k + 2] = q.z;
      out[4 * k + 3] = q.w;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < ROWS_T; ++j) out[j] = j < n ? p[j] : fill;
}

__device__ __forceinline__ void load_rows(const long long* p, long long* out,
                                          bool full, int n, long long fill) {
  if (full) {
#pragma unroll
    for (int k = 0; k < ROWS_T / 2; ++k) {
      const longlong2 q = reinterpret_cast<const longlong2*>(p)[k];
      out[2 * k] = q.x;
      out[2 * k + 1] = q.y;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < ROWS_T; ++j) out[j] = j < n ? p[j] : fill;
}

// A set row i: its bucket and keys.
__device__ __forceinline__ void set_row(const HistPairsArgs& a, long long i,
                                        long long key, long long src) {
  a.hp_bv[i] = key % a.nv;
  for (int k = 0; k < a.K; ++k)
    a.hp_keys[(size_t)i * a.K + k] = a.kmat[(size_t)src * a.K + k];
}

// Warp 0 of tile `tile`, every lane: the carry into the tile from the
// tiles before it, walked back over their published words to the nearest
// inclusive prefix (tile 0 always publishes one: its first row starts a
// segment).  Every tile before it has started and publishes without
// waiting, so the walk ends.
__device__ __forceinline__ Carry walk_back(const HistPairsArgs& a, int tile) {
  const int lane = threadIdx.x & 31;
  const unsigned long long* st = a.scratch + S_STATUS;
  unsigned long long acc = 0ull;
  if (a.paths && lane == 0) atomicAdd(a.paths + P_WALK, 1ull);
  for (int hi = tile - 1;; hi -= 32 * LB) {
    if (a.paths && lane == 0 && hi == tile - 1 - 32 * LB)
      atomicAdd(a.paths + P_DEEP, 1ull);
    unsigned long long w[LB];
    bool unset = false;
#pragma unroll
    for (int k = 0; k < LB; ++k) {
      const int j = hi - LB * lane - k;
      w[k] = j >= 0 ? ld_relaxed(st + j) : PREFIX_BIT;
      unset |= w[k] == 0ull;
    }
    while (__any_sync(FULL, unset)) {
      unset = false;
#pragma unroll
      for (int k = 0; k < LB; ++k) {
        if (w[k] == 0ull) w[k] = ld_relaxed(st + hi - LB * lane - k);
        unset |= w[k] == 0ull;
      }
    }
    // this lane's nearest inclusive prefix, or LB
    int kp = LB;
#pragma unroll
    for (int k = LB - 1; k >= 0; --k)
      if (w[k] & PREFIX_BIT) kp = k;
    const unsigned pre = __ballot_sync(FULL, kp < LB);
    const int stop = pre ? __ffs(pre) - 1 : 31;
    // the sums published before the words the window saw
    lookback::fence_acquire();
    unsigned long long c = 0ull;
    int start = 0;
#pragma unroll
    for (int k = 0; k < LB; ++k) {
      const int j = hi - LB * lane - k;
      if (lane < stop || (lane == stop && k <= kp)) c += __ldcg(a.tsum + j);
      if (k == kp) start = (int)(w[k] & START_MASK);
    }
    for (int d = 16; d; d >>= 1) c += __shfl_xor_sync(FULL, c, d);
    acc += c;
    if (pre) return Carry{__shfl_sync(FULL, start, stop), acc};
  }
}

template <typename KeyT, bool HAS_W>
__global__ void __launch_bounds__(THREADS) pairs_kernel(const HistPairsArgs a) {
  __shared__ int s_tile;
  __shared__ Carry s_warp[WARPS];
  __shared__ int s_pairs[WARPS];
  __shared__ int s_head_ends;
  __shared__ unsigned long long s_head;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    s_tile = (int)atomicAdd(a.scratch + S_TICKET, 1ull);
    s_head_ends = 0;
  }
  __syncthreads();
  const int tile = s_tile;
  const KeyT* spk = static_cast<const KeyT*>(a.spk);
  const KeyT sent = static_cast<KeyT>(a.sent_pk);
  const long long R = a.R, lo = (long long)tile * TILE;
  const bool vec =
      (((uintptr_t)spk | (uintptr_t)a.si2 | (uintptr_t)a.hp_mask) & 15) == 0;
  Carry run{-1, 0ull};   // the tile's rows so far, every thread alike
  int my_pairs = 0;
  for (int c = 0; c < CHUNKS && lo + (long long)c * CHUNK < R; ++c) {
    const long long base =
        lo + (long long)c * CHUNK + (long long)threadIdx.x * ROWS_T;
    const int n = base >= R ? 0
                            : (int)(R - base < ROWS_T ? R - base : ROWS_T);
    const bool full = vec && n == ROWS_T;
    KeyT k[ROWS_T];
    load_rows(spk + (n ? base : 0), k, full, n, sent);
    // the keys of the rows before and after the thread's
    KeyT before = __shfl_up_sync(FULL, k[ROWS_T - 1], 1);
    KeyT after = __shfl_down_sync(FULL, k[0], 1);
    if (lane == 0) before = n && base > 0 ? spk[base - 1] : sent;
    if (lane == 31) after = n == ROWS_T && base + ROWS_T < R
                                ? spk[base + ROWS_T] : sent;
    // the weights of the rows below the sentinel: keys ascend, so the
    // first says whether a thread has any
    long long src[ROWS_T];
    unsigned long long x[ROWS_T];
    if constexpr (HAS_W) {
      const bool any = n > 0 && k[0] < sent;
      load_rows(a.si2 + (any ? base : 0), src, full && any, any ? n : 0,
                0ll);
#pragma unroll
      for (int j = 0; j < ROWS_T; ++j)
        x[j] = j < n && k[j] < sent ? (unsigned long long)a.w[src[j]] : 0ull;
    }
    unsigned bits = 0u;
    bool open_here = false, bounded = false, head_ends = false;
    int start = -1;
    unsigned long long sum = 0ull, head = 0ull;
    if (n == ROWS_T && base > 0 && base + ROWS_T < R && before == k[0] &&
        k[0] == k[ROWS_T - 1] && k[ROWS_T - 1] == after) {
      // the common thread: its rows inside one segment (a segment holds
      // hundreds of rows, the sentinel one most of a filtered batch), no
      // word to write but its mask's
      if (k[0] < sent) {
        if constexpr (HAS_W) {
#pragma unroll
          for (int j = 0; j < ROWS_T; ++j) sum += x[j];
        } else {
          sum = ROWS_T;
        }
      }
    } else {
      // the thread's rows in order: a segment that starts here is summed
      // here; one that ends here before any start is the carry's
#pragma unroll
      for (int j = 0; j < ROWS_T; ++j) {
        if (j < n) {
          const long long i = base + j;
          const bool valid = k[j] < sent;
          const bool st = i == 0 || k[j] != (j ? k[j - 1] : before);
          const bool en = i == R - 1 || k[j] != (j + 1 < ROWS_T ? k[j + 1]
                                                                : after);
          if (st) {
            open_here = bounded = true;
            start = (int)i;
            sum = 0ull;
            if (valid) {
              bits |= 1u << j;
              ++my_pairs;
              set_row(a, i, (long long)k[j], HAS_W ? src[j] : a.si2[i]);
            }
          }
          if (i == R - 1 && !(st && valid)) {
            // the padding rows' source row, when it is not a set row
            a.hp_bv[i] = 0ll;
            a.hp_w[i] = 0ll;
            // its own load: a sentinel row's si2 was not read
            const long long s = a.si2[i];
            for (int q = 0; q < a.K; ++q)
              a.hp_keys[(size_t)i * a.K + q] = a.kmat[(size_t)s * a.K + q];
          }
          sum += HAS_W ? x[j] : (unsigned long long)valid;
          if (en) {
            if (open_here) {
              if (valid) a.hp_w[start] = (long long)sum;
            } else {
              head = sum;
              head_ends = valid;   // the sentinel segment needs no sum
            }
            open_here = false;
            bounded = true;
            start = (int)(i + 1);
            sum = 0ull;
          }
        }
      }
    }
    // hp_mask: one 16-byte store a thread
    if (full) {
      uint4 q;
      unsigned* qw = reinterpret_cast<unsigned*>(&q);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const unsigned b = bits >> (4 * t);
        qw[t] = (b & 1u) | ((b >> 1) & 1u) << 8 | ((b >> 2) & 1u) << 16 |
                ((b >> 3) & 1u) << 24;
      }
      *reinterpret_cast<uint4*>(a.hp_mask + base) = q;
    } else {
#pragma unroll
      for (int j = 0; j < ROWS_T; ++j)
        if (j < n) a.hp_mask[base + j] = (bits >> j) & 1u;
    }
    Carry total;
    const Carry in = combine(
        run, block_carry(Carry{bounded ? start : -1, sum}, &total, s_warp));
    if (head_ends) {
      if (in.start >= 0) {
        a.hp_w[in.start] = (long long)(in.sum + head);
      } else {
        // the tile's first segment, begun in an earlier tile, ends here
        s_head = in.sum + head;
        s_head_ends = 1;
      }
    }
    run = combine(run, total);
  }
  // npairs, and the tile's open segment for the tiles after it
  for (int d = 16; d; d >>= 1) my_pairs += __shfl_xor_sync(FULL, my_pairs, d);
  if (lane == 0) s_pairs[warp] = my_pairs;
  __syncthreads();
  if (threadIdx.x == 0) {
    int p = 0;
    for (int w = 0; w < WARPS; ++w) p += s_pairs[w];
    if (p) atomicAdd(a.scratch + S_NPAIRS, (unsigned long long)p);
    a.tsum[tile] = run.sum;
    st_release(a.scratch + S_STATUS + tile,
               run.start >= 0 ? PREFIX_BIT | (unsigned long long)run.start
                              : AGG_BIT);
  }
  if (s_head_ends && warp == 0) {
    const Carry in = walk_back(a, tile);
    if (lane == 0) a.hp_w[in.start] = (long long)(in.sum + s_head);
  }
}

template <typename KeyT>
void launch_prep(const HistPairsArgs& a, int grid, cudaStream_t s) {
  if (a.w && a.nout)
    prep_kernel<KeyT, true, true><<<grid, THREADS, 0, s>>>(a);
  else if (a.w)
    prep_kernel<KeyT, true, false><<<grid, THREADS, 0, s>>>(a);
  else if (a.nout)
    prep_kernel<KeyT, false, true><<<grid, THREADS, 0, s>>>(a);
  else
    prep_kernel<KeyT, false, false><<<grid, THREADS, 0, s>>>(a);
}

template <typename KeyT>
void launch_pairs(const HistPairsArgs& a, cudaStream_t s) {
  if (a.w)
    pairs_kernel<KeyT, true><<<a.ntiles, THREADS, 0, s>>>(a);
  else
    pairs_kernel<KeyT, false><<<a.ntiles, THREADS, 0, s>>>(a);
}

}  // namespace

// The first entry: one launch of `grid` CTAs, no memset.  Returns
// cudaError_t.
extern "C" int hist_prep(const HistPairsArgs* args, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const HistPairsArgs& a = *args;
  if (a.R < 1 || a.R >= (1ll << 31) || a.nsub > MAXSUB || a.nv <= 0 ||
      grid < 1 || (a.nout && (!a.part || !a.done || !a.out_mask)) ||
      (a.key32 && a.sent_pk >= (1ll << 31)))
    return cudaErrorInvalidValue;
  if (a.key32)
    launch_prep<int>(a, grid, s);
  else
    launch_prep<long long>(a, grid, s);
  return cudaGetLastError();
}

// The second entry: zeroes npairs, the ticket and the status words, then
// one launch of a CTA a tile.  Returns cudaError_t.
extern "C" int hist_pairs(const HistPairsArgs* args, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const HistPairsArgs& a = *args;
  if (a.R < 1 || a.R >= (1ll << 31) ||
      a.ntiles != (int)((a.R + TILE - 1) / TILE) || a.nv <= 0 ||
      !a.scratch || !a.tsum || (a.key32 && a.sent_pk >= (1ll << 31)))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaMemsetAsync(
      a.scratch, 0, (S_STATUS + (size_t)a.ntiles) * sizeof(unsigned long long),
      s);
  if (err != cudaSuccess) return err;
  if (a.key32)
    launch_pairs<int>(a, s);
  else
    launch_pairs<long long>(a, s);
  return cudaGetLastError();
}
