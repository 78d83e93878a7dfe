// K16 shuffle_reduce: the owner's merge of the rows the mesh exchange
// brought it, and the unpack of the gathered merged tables.
//
// shuffle_keys and shuffle_reduce replace sybil_tpu/parallel/mesh.py:
// _segment_reduce (146-194) for one owner's N = D * Sc received payload
// rows [N, WP] ([keys K | n_sum summed lanes | min per agg | max per agg];
// a row is live when its count or samples word is > 0):
//   shuffle_keys    the sort operands: key k of each row, SENTINEL where
//                   the row is dead, as [K, N]; and per CTA the live rows
//                   and the live rows whose keys all equal SENTINEL (the
//                   "tied" rows), [grid, 2];
//   (sorts)         the stable torch.sort passes over them (sort_rows);
//   shuffle_reduce  in sorted order, a segment starts where any key
//                   differs from the previous row's; gid = segments so
//                   far - 1; n_groups = live segment starts; a live row
//                   with gid < cap adds its summed lanes to merged[gid],
//                   and its min/max words into the segment's min/max;
//                   the segment's first row writes its keys when it is
//                   live.  Merged rows no row reaches keep keys 0, lanes
//                   0, min INT64_MAX and max INT64_MIN (what segment_min/
//                   max give an empty segment).  flive[j] = j <
//                   min(n_groups, cap), and stats[0] = n_groups.
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
// Bounds: memory, and at the mesh's shapes launch latency.
//   shuffle_reduce reads the sorted order (p, and base when the sort had
//   two passes) and the WP words of each live row, and writes the merged
//   table [cap, WP] and its flags: at one path-2 owner (201,024 rows,
//   9,108 live, cap 25,128, WP 9) about 3 MB.  Dead rows are keyed
//   SENTINEL and sort after every live row, unless a live row's keys all
//   equal SENTINEL (int64 columns may reach INT64_MAX) and tie with them.
//   So when shuffle_keys counted no tied row, the live rows are exactly
//   the first n_live sorted positions: the merge walks only those (the
//   "live walk"), and the dead tail is one segment that takes a gid and
//   writes nothing.  Otherwise it walks all N positions and tests each
//   row (the "general walk").  Two launches:
//     1. heads: every CTA sums shuffle_keys' counts (the walk), writes its
//        share of the merged table's empty rows, and numbers a tile of
//        the walk (T = the walk / grid, 256-row multiples, so the grid
//        spans the card): each position's source row (one int32, ~row
//        when dead) and its segment count within the tile with the head
//        flag (one uint32), and the tile's segment and live-segment
//        counts.  The previous row's keys come by a warp shuffle.
//     2. reduce: every CTA sums the counts of the tiles before its own
//        (its first gid) and of all tiles (n_groups: stats[0], flive),
//        then walks its tile from the scratch words alone.  Rows of at
//        most 32 reduced words (n_sum + 2A): a row a lane, the lanes of a
//        warp reduced over each run of equal gid by shuffles.  Wider rows
//        (the dense strategy's bucket lanes): a warp takes a run of
//        consecutive positions, skips those that add nothing by a ballot,
//        and its lanes stride over the row's words with running sums,
//        mins and maxs in registers, flushed at each gid change.  A
//        segment that lies wholly in one warp's run is stored; one that
//        crosses runs adds each run's part by atomics.  All arithmetic is
//        integer (sums wrap as int64, min and max exact), so the order of
//        the atomics cannot change a word.
//   shuffle_unpack reads k rows of WP words and writes S rows of K + L +
//   nv + 2A words: at path 2's final table (100,000 rows, WP 9) about
//   14.4 MB.  One launch: a thread per output word, region by region
//   (keys, lanes, each histogram, mins, maxs), so neighbouring threads
//   write neighbouring words and read neighbouring words of a gathered
//   row; one warp sums the statistics rows, a lane a column.

#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "desc.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WIDE_WORDS = 32;  // reduced words past which a warp takes a row
constexpr int ACC = 8;          // a lane's register words per pass (wide)
constexpr long long SENTINEL = 0x7fffffffffffffffll;
constexpr long long I64_MIN = -SENTINEL - 1;
constexpr unsigned FULL = 0xffffffffu;

}  // namespace

// Mirrored field for field by ShuffleReduceArgs in parallel/mesh.py
// (ctypes).
struct ShuffleReduceArgs {
  const long long* rows;     // [N, WP]
  const long long* p;        // [N] the last sort's indices
  const long long* base;     // [N] the permutation before it, or null
  const int* counts;         // [ncnt, 2] shuffle_keys' live and tied rows
  long long* merged;         // [cap, WP]
  int* flive;                // [cap]
  long long* stats;          // [1]: word 0 of the owner's statistics row
  int* scratch;              // [2N + 2 grid + 1]: see scratch_of
  long long N;
  int cap;
  int K;
  int n_sum;
  int A;
  int WP;
  int ncnt;
};

// Mirrored field for field by ShuffleUnpackArgs in parallel/mesh.py
// (ctypes).
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

// The merge's scratch words: each walked position's source row (~row
// when dead), its tile-local segment count << 1 | head flag, each tile's
// segment and live-segment counts, and the walk's length.
struct Scratch {
  int* src;
  unsigned* seg;
  int* tiles;   // [2 * grid]: segments, then live segments
  int* walk;    // [1]: the walk's length
};

__device__ __forceinline__ Scratch scratch_of(const ShuffleReduceArgs& a) {
  Scratch s;
  s.src = a.scratch;
  s.seg = reinterpret_cast<unsigned*>(a.scratch + a.N);
  s.tiles = a.scratch + 2 * a.N;
  s.walk = s.tiles + 2 * gridDim.x;
  return s;
}

// x and y summed over the CTA; every thread gets both totals.  All
// threads must call it.
__device__ int2 block_sum2(int x, int y) {
  __shared__ int2 s_part[WARPS];
  x = __reduce_add_sync(FULL, x);
  y = __reduce_add_sync(FULL, y);
  if ((threadIdx.x & 31) == 0) s_part[threadIdx.x >> 5] = make_int2(x, y);
  __syncthreads();
  int2 t = make_int2(0, 0);
  for (int w = 0; w < WARPS; ++w) {
    t.x += s_part[w].x;
    t.y += s_part[w].y;
  }
  __syncthreads();
  return t;
}

// Positions of the walk per CTA: a multiple of THREADS.
__device__ __forceinline__ long long tile_rows(long long M) {
  const long long t = (M + gridDim.x - 1) / gridDim.x;
  const long long r = (t + THREADS - 1) / THREADS * THREADS;
  return r > 0 ? r : THREADS;
}

__device__ __forceinline__ int src_of(const ShuffleReduceArgs& a,
                                      long long i) {
  const long long q = a.p[i];
  return (int)(a.base ? a.base[q] : q);
}

__device__ __forceinline__ bool live_row(const ShuffleReduceArgs& a, int r) {
  const long long* row = a.rows + (long long)r * a.WP;
  return row[a.K] > 0 || row[a.K + 1] > 0;
}

__device__ __forceinline__ long long identity(int op) {
  return op == 0 ? 0 : (op == 1 ? SENTINEL : I64_MIN);
}

// Reduced word j (after the keys): 0 sum, 1 min, 2 max.
__device__ __forceinline__ int op_of(const ShuffleReduceArgs& a, int j) {
  return j < a.n_sum ? 0 : (j < a.n_sum + a.A ? 1 : 2);
}

__device__ __forceinline__ long long combine(long long x, long long y,
                                             int op) {
  return op == 0 ? x + y : (op == 1 ? (y < x ? y : x) : (y > x ? y : x));
}

// A segment's part into its merged word: stored when the part is the
// whole segment, else added by an atomic.  Identity parts are skipped:
// the word was seeded with the identity.
__device__ __forceinline__ void put(long long* w, long long v, int op,
                                    bool whole) {
  if (v == identity(op)) return;
  if (whole)
    *w = v;
  else if (op == 0)
    atomicAdd(reinterpret_cast<unsigned long long*>(w),
              (unsigned long long)v);
  else if (op == 1)
    atomicMin(w, v);
  else
    atomicMax(w, v);
}

// shuffle_keys: the sort operands, and per CTA the live and tied rows.
__global__ void __launch_bounds__(THREADS) keys_kernel(
    const long long* rows, long long* keys, int* counts, long long N, int K,
    int WP) {
  int nl = 0, nt = 0;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < N;
       i += (long long)gridDim.x * THREADS) {
    const long long* row = rows + i * WP;
    const bool live = row[K] > 0 || row[K + 1] > 0;
    bool tied = live;
    for (int k = 0; k < K; ++k) {
      const long long v = live ? row[k] : SENTINEL;
      keys[(long long)k * N + i] = v;
      tied = tied && v == SENTINEL;
    }
    nl += live;
    nt += tied;
  }
  const int2 t = block_sum2(nl, nt);
  if (threadIdx.x == 0) {
    counts[2 * blockIdx.x] = t.x;
    counts[2 * blockIdx.x + 1] = t.y;
  }
}

// Pass 1: the walk, the merged table's empty rows, and each position's
// source row and segment count within its tile.
__global__ void __launch_bounds__(THREADS) heads_kernel(
    const ShuffleReduceArgs a) {
  const Scratch sc = scratch_of(a);
  int nl = 0, nt = 0;
  for (int j = threadIdx.x; j < a.ncnt; j += THREADS) {
    nl += a.counts[2 * j];
    nt += a.counts[2 * j + 1];
  }
  const int2 c = block_sum2(nl, nt);
  const bool fast = c.y == 0;
  const long long M = fast ? c.x : a.N;
  if (blockIdx.x == 0 && threadIdx.x == 0) *sc.walk = (int)M;

  const int nw = a.cap * a.WP;  // < 2^31, checked by the entry
  for (int x = blockIdx.x * THREADS + threadIdx.x; x < nw;
       x += gridDim.x * THREADS) {
    const int m = x % a.WP - a.K - a.n_sum;  // >= 0: a min or max word
    a.merged[x] = m < 0 ? 0 : (m < a.A ? SENTINEL : I64_MIN);
  }

  const long long T = tile_rows(M);
  const long long lo = min((long long)blockIdx.x * T, M);
  const long long hi = min(lo + T, M);
  __shared__ int s_src[THREADS];  // the chunk's source rows, ~row if dead
  __shared__ int s_prev;          // the position before the chunk's
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0 && lo > 0 && lo < hi) {
    const int r = src_of(a, lo - 1);
    s_prev = fast || live_row(a, r) ? r : ~r;
  }
  int seg = 0, nlh = 0;
  for (long long c0 = lo; c0 < hi; c0 += THREADS) {
    const long long i = c0 + threadIdx.x;
    const bool in = i < hi;
    int r = 0;
    bool live = false;
    if (in) {
      r = src_of(a, i);
      live = fast || live_row(a, r);
    }
    s_src[threadIdx.x] = live ? r : ~r;
    __syncthreads();
    // the previous position's row: lane - 1's by a shuffle, lane 0 loads
    int q = 0;
    bool ql = false;
    if (lane == 0 && in && i > 0) {
      const int v = threadIdx.x ? s_src[threadIdx.x - 1] : s_prev;
      ql = v >= 0;
      q = ql ? v : ~v;
    }
    const long long* row = a.rows + (long long)r * a.WP;
    const long long* prow = a.rows + (long long)q * a.WP;
    bool head = in && i == 0;
    for (int k = 0; k < a.K; ++k) {
      const long long v = in && live ? row[k] : SENTINEL;
      long long pv = __shfl_up_sync(FULL, v, 1);
      if (lane == 0) pv = ql ? prow[k] : SENTINEL;
      head = head || (in && i > 0 && v != pv);
    }
    int total;
    const int h = head ? 1 : 0;
    const int pre = block_scan<THREADS>(h, &total);
    if (in) {
      sc.src[i] = s_src[threadIdx.x];
      sc.seg[i] = ((unsigned)(seg + pre + h) << 1) | (unsigned)h;
    }
    nlh += head && live;
    seg += total;
    if (threadIdx.x == THREADS - 1) s_prev = s_src[THREADS - 1];
    __syncthreads();
  }
  const int2 t = block_sum2(0, nlh);
  if (threadIdx.x == 0) {
    sc.tiles[blockIdx.x] = seg;
    sc.tiles[gridDim.x + blockIdx.x] = t.y;
  }
}

// Sum (op 0), min (1) or max (2) of x over the lanes of this lane's run
// of equal g at and after it (runs are contiguous); the run's first lane
// ends with the run's total.
__device__ __forceinline__ long long run_reduce(long long x, int g, int op) {
  const int lane = threadIdx.x & 31;
  for (int off = 1; off < 32; off <<= 1) {
    const long long y = __shfl_down_sync(FULL, x, off);
    const int gy = __shfl_down_sync(FULL, g, off);
    if (lane + off < 32 && gy == g) x = combine(x, y, op);
  }
  return x;
}

// Rows of at most WIDE_WORDS reduced words: a position a lane, warps
// taking 32 positions at a time.
__device__ void walk_narrow(const ShuffleReduceArgs& a, const Scratch& sc,
                            int before, long long lo, long long hi,
                            long long M) {
  const int lane = threadIdx.x & 31;
  for (long long c0 = lo + (threadIdx.x & ~31); c0 < hi; c0 += THREADS) {
    const long long i = c0 + lane;
    const bool in = i < hi;
    const int s = in ? sc.src[i] : -1;
    const unsigned w = in ? sc.seg[i] : 0u;
    const int gid = before + (int)(w >> 1) - 1;
    const bool contrib = in && s >= 0 && gid < a.cap;
    if (!__any_sync(FULL, contrib)) continue;
    // g: the position's segment while it is one the table holds (dead
    // rows too, so equal g stay contiguous), else -1
    const int g = in && gid < a.cap ? gid : -1;
    const bool hd = (w & 1u) != 0;
    const bool hnext = __shfl_down_sync(FULL, (int)hd, 1) != 0;
    // whether this position's segment ends with it
    bool ends = true;
    if (lane < 31 && i + 1 < hi)
      ends = hnext;
    else if (in && i + 1 < M)
      ends = (sc.seg[i + 1] & 1u) != 0;
    const int gprev = __shfl_up_sync(FULL, g, 1);
    const int gnext = __shfl_down_sync(FULL, g, 1);
    const bool rhead = g >= 0 && (lane == 0 || gprev != g);
    const unsigned lastm = __ballot_sync(FULL, lane == 31 || gnext != g);
    const int e = __ffs(lastm & (FULL << lane)) - 1;
    // the run is the whole segment: it starts here and ends at lane e
    const bool whole = __shfl_sync(FULL, (int)ends, e) != 0 && hd;
    const long long* row = a.rows + (long long)(contrib ? s : 0) * a.WP;
    long long* out = a.merged + (long long)(g < 0 ? 0 : g) * a.WP;
    if (contrib && hd)
      for (int k = 0; k < a.K; ++k) out[k] = row[k];
    const int nw = a.n_sum + 2 * a.A;
    for (int j = 0; j < nw; ++j) {
      const int op = op_of(a, j);
      const long long v =
          run_reduce(contrib ? row[a.K + j] : identity(op), g, op);
      if (rhead) put(out + a.K + j, v, op, whole);
    }
  }
}

// Rows of more reduced words: a warp takes a run of positions, its lanes
// stride over the row's words, ACC a lane per pass.
__device__ void walk_wide(const ShuffleReduceArgs& a, const Scratch& sc,
                          int before, long long lo, long long hi,
                          long long M) {
  const int lane = threadIdx.x & 31;
  const long long span = (hi - lo + WARPS - 1) / WARPS;
  const long long wlo = lo + (threadIdx.x >> 5) * span;
  const long long whi = min(wlo + span, hi);
  if (wlo >= whi) return;
  // the run's first segment and whether it starts in the run; its last
  // segment and whether the position after the run starts another
  const unsigned w0 = sc.seg[wlo];
  const int g0 = before + (int)(w0 >> 1) - 1;
  const bool h0 = (w0 & 1u) != 0;
  const int gend = before + (int)(sc.seg[whi - 1] >> 1) - 1;
  const bool cut = whi >= M || (sc.seg[whi] & 1u) != 0;
  const int nw = a.n_sum + 2 * a.A;
  for (int c0 = 0; c0 < nw; c0 += 32 * ACC) {
    long long acc[ACC];
    int cur = -1;
    for (long long b0 = wlo; b0 < whi; b0 += 32) {
      const long long i = b0 + lane;
      const bool in = i < whi;
      const int s = in ? sc.src[i] : -1;
      const unsigned w = in ? sc.seg[i] : 0u;
      const int gid = before + (int)(w >> 1) - 1;
      unsigned cm = __ballot_sync(FULL, in && s >= 0 && gid < a.cap);
      while (cm) {
        const int l = __ffs(cm) - 1;
        cm &= cm - 1;
        const int gl = __shfl_sync(FULL, gid, l);
        const int sl = __shfl_sync(FULL, s, l);
        const bool hl = __shfl_sync(FULL, (int)(w & 1u), l) != 0;
        long long* out = a.merged + (long long)gl * a.WP;
        if (gl != cur) {
          if (cur >= 0) {
            long long* prev = a.merged + (long long)cur * a.WP + a.K;
#pragma unroll
            for (int m = 0; m < ACC; ++m) {
              const int j = c0 + lane + 32 * m;
              if (j < nw) put(prev + j, acc[m], op_of(a, j),
                              cur > g0 || h0);
            }
          }
          cur = gl;
#pragma unroll
          for (int m = 0; m < ACC; ++m)
            acc[m] = identity(op_of(a, c0 + lane + 32 * m));
        }
        const long long* row = a.rows + (long long)sl * a.WP;
        if (hl && c0 == 0)
          for (int k = lane; k < a.K; k += 32) out[k] = row[k];
#pragma unroll
        for (int m = 0; m < ACC; ++m) {
          const int j = c0 + lane + 32 * m;
          if (j < nw) acc[m] = combine(acc[m], row[a.K + j], op_of(a, j));
        }
      }
    }
    if (cur >= 0) {
      long long* out = a.merged + (long long)cur * a.WP + a.K;
      const bool whole = (cur > g0 || h0) && (cur < gend || cut);
#pragma unroll
      for (int m = 0; m < ACC; ++m) {
        const int j = c0 + lane + 32 * m;
        if (j < nw) put(out + j, acc[m], op_of(a, j), whole);
      }
    }
  }
}

// Pass 2: each CTA's first gid and n_groups from the tile counts, the
// live flags, and the tile's reduce.
template <bool WIDE>
__global__ void __launch_bounds__(THREADS) reduce_kernel(
    const ShuffleReduceArgs a) {
  const Scratch sc = scratch_of(a);
  const long long M = *sc.walk;
  int before = 0, ng = 0;
  for (int j = threadIdx.x; j < (int)gridDim.x; j += THREADS) {
    if (j < (int)blockIdx.x) before += sc.tiles[j];
    ng += sc.tiles[gridDim.x + j];
  }
  const int2 t = block_sum2(before, ng);
  if (blockIdx.x == 0 && threadIdx.x == 0) a.stats[0] = t.y;
  const int m = t.y < a.cap ? t.y : a.cap;
  for (int j = blockIdx.x * THREADS + threadIdx.x; j < a.cap;
       j += gridDim.x * THREADS)
    a.flive[j] = j < m;
  const long long T = tile_rows(M);
  const long long lo = min((long long)blockIdx.x * T, M);
  const long long hi = min(lo + T, M);
  if (lo >= hi) return;
  if (WIDE)
    walk_wide(a, sc, t.x, lo, hi, M);
  else
    walk_narrow(a, sc, t.x, lo, hi, M);
}

__global__ void __launch_bounds__(THREADS) unpack_kernel(
    const ShuffleUnpackArgs a) {
  const int lane = threadIdx.x & 31;
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    // the statistics: a lane a column, then the overflow rule
    for (int c0 = 0; c0 < a.ncols; c0 += 32) {
      const int c = c0 + lane;
      long long s = 0;
      if (c < a.ncols)
        for (int d = 0; d < a.D; ++d) s += a.stats[(long long)d * a.ncols + c];
      const long long ng = __shfl_sync(FULL, s, 0);
      if (c0 == 0 && lane == 2 && ng > a.S) s += ng - a.S;
      if (c < a.ncols) a.meta[c] = s;
    }
  }
  const int t0 = blockIdx.x * THREADS + threadIdx.x;
  const int stride = gridDim.x * THREADS;
  // (S + 1) * WP < 2^31, checked by the entry: word indices fit an int
  const int nk = a.S * a.K;
  for (int x = t0; x < nk; x += stride) {
    const int i = x / a.K;
    const int src = i < a.k ? a.top[i] : -1;
    a.keys[x] = src < 0 ? 0 : a.flat[(long long)src * a.WP + (x - i * a.K)];
  }
  const int nl = (a.S + 1) * a.L;
  for (int x = t0; x < nl; x += stride) {
    const int i = x / a.L;
    const int src = i < a.k ? a.top[i] : -1;
    a.sums[x] = src < 0 || !a.flive[src]
                    ? 0
                    : a.flat[(long long)src * a.WP + a.K + (x - i * a.L)];
  }
  int c = a.K + a.L;
  for (int h = 0; h < a.H; ++h) {
    const int nv = (int)desc_at(a.desc, a.hist_nv, h);
    long long* dst = desc_at(a.desc, a.hist, h);
    const int n = a.S * nv;
    for (int x = t0; x < n; x += stride) {
      const int i = x / nv;
      const int src = i < a.k ? a.top[i] : -1;
      dst[x] = src < 0 || !a.flive[src]
                   ? 0
                   : a.flat[(long long)src * a.WP + c + (x - i * nv)];
    }
    c += nv;
  }
  const int na = a.S * a.A;
  const int mn = a.K + a.n_sum;
  for (int x = t0; x < na; x += stride) {
    const int i = x / a.A;
    const int src = i < a.k ? a.top[i] : -1;
    const long long* row = a.flat + (long long)(src < 0 ? 0 : src) * a.WP +
                           mn + (x - i * a.A);
    a.mins[x] = src < 0 ? 0 : row[0];
    a.maxs[x] = src < 0 ? 0 : row[a.A];
  }
}

}  // namespace

// keys [K, N] of the rows [N, WP] (row i's key k, SENTINEL when dead) and
// counts [grid, 2] (each CTA's live rows and live rows whose keys all
// equal SENTINEL) on `stream`.  Returns cudaError_t.
extern "C" int shuffle_keys(const long long* rows, long long* keys,
                            int* counts, long long N, int K, int WP,
                            int grid, void* stream) {
  if (N < 1 || K < 1 || WP < K + 2 || grid < 1)
    return cudaErrorInvalidValue;
  keys_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, keys, counts, N, K, WP);
  return cudaGetLastError();
}

// One owner's merge on `stream` in two launches (heads, reduce) of
// `grid` CTAs; scratch holds 2N + 2 grid + 1 ints.  Returns cudaError_t.
extern "C" int shuffle_reduce(const ShuffleReduceArgs* args, int grid,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ShuffleReduceArgs& a = *args;
  if (a.N < 1 || a.N >= (1ll << 31) || a.cap < 1 || a.K < 1 ||
      (long long)a.cap * a.WP >= (1ll << 31) || a.ncnt < 1 || grid < 1 ||
      a.WP != a.K + a.n_sum + 2 * a.A)
    return cudaErrorInvalidValue;
  heads_kernel<<<grid, THREADS, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (a.n_sum + 2 * a.A > WIDE_WORDS)
    reduce_kernel<true><<<grid, THREADS, 0, s>>>(a);
  else
    reduce_kernel<false><<<grid, THREADS, 0, s>>>(a);
  return cudaGetLastError();
}

// The final table's split outputs and the meta sums on `stream`.
extern "C" int shuffle_unpack(const ShuffleUnpackArgs* args, int grid,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ShuffleUnpackArgs& a = *args;
  if (a.S < 1 || a.k < 0 || a.k > a.S || a.ncols < 3 || a.K < 1 ||
      a.A < 0 || a.WP < a.K + a.n_sum + 2 * a.A || a.n_sum < a.L ||
      (long long)(a.S + 1) * a.WP >= (1ll << 31) || grid < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = desc_upload(a.desc, s);
  if (err != cudaSuccess) return err;
  unpack_kernel<<<grid, THREADS, 0, s>>>(a);
  return cudaGetLastError();
}
