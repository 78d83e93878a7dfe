// K16 shuffle_reduce: the owners' merge of the rows the mesh exchange
// brought them, and the unpack of the gathered merged tables.
//
// shuffle_keys and shuffle_reduce replace sybil_tpu/parallel/mesh.py:
// _segment_reduce (146-194), which the reference runs for every local
// owner inside one shard_map program, over the Dl local owners' received
// payload rows [Dl, N, WP] (N = D * Sc; a row is [keys K | n_sum summed
// lanes | min per agg | max per agg], live when its count or samples
// word is > 0), in one call each for all of them:
//   shuffle_keys    compacts each owner's rows: the live rows, and the
//                   first dead row of each KT-row tile, in row order,
//                   owner after owner; for each kept row its flat row
//                   index (src), and the sort operands [K + 1, M]: lane
//                   0 the owner, lane 1 + k key k (SENTINEL where the
//                   row is dead); off [Dl + 1], each owner's first kept
//                   position and M last;
//   (sorts)         the stable torch.sort passes over them (sort_rows),
//                   the owner the most significant: K + 1 sorts a mesh
//                   batch, each owner's kept rows at [off[d], off[d+1]);
//   shuffle_reduce  for each owner, in sorted order, a segment starts
//                   where any key differs from the previous row's; gid =
//                   segments so far - 1; n_groups = live segment starts;
//                   a live row with gid < cap adds its summed lanes to
//                   merged[d, gid], and its min/max words into the
//                   segment's min/max; the segment's first row writes its
//                   keys when it is live.  Merged rows no row reaches keep
//                   keys 0, lanes 0, min INT64_MAX and max INT64_MIN
//                   (what segment_min/max give an empty segment).
//                   flive[d, j] = j < min(n_groups, cap), and stats[d, 0]
//                   = n_groups.
// Why the compaction keeps the reference's answer: dead rows are keyed
// SENTINEL (INT64_MAX) and add nothing; they all fall in the last
// segment, the one keyed SENTINEL in every key, which a live row whose
// keys all equal SENTINEL (int64 columns may reach INT64_MAX; "tied")
// shares with them.  That segment's first row, which decides whether it
// counts in n_groups and writes its keys, is the tied row or dead row of
// the lowest index; the owner's first dead row is its tile's first, so
// it is kept, and the segment's first row is the same with or without
// the other dead rows.  The merge then tests each walked row's liveness.
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
//   shuffle_keys reads every received row's count and samples words (a
//   32-byte sector a row) and a kept row's keys, and writes the kept
//   rows' operands: at path 2's mesh batch (8 owners of 201,024 rows,
//   9,108 live each, WP 9) about 52 MB read.
//   shuffle_reduce reads the sorted order (p, and base when the sort had
//   two passes), src and the WP words of each kept row, and writes the
//   merged tables [Dl, cap, WP] and their flags: at path 2's batch about
//   18 MB.
//   shuffle_unpack reads k rows of WP words and writes S rows of K + L +
//   nv + 2A words: at path 2's final table (100,000 rows, WP 9) about
//   14.4 MB.
//
// What the former design cost (PERF.md §6): the loop ran an owner at a
// time, Dl x (shuffle_keys, K stable sorts over all N rows, 95% of them
// dead at path 2, and shuffle_reduce's two launches): 64 device
// operations a config 3 -loghist batch and 384 a path 2 batch (each
// int64 sort of 201,024 rows eight radix passes and ten memsets), 1.15
// and 2.92 ms of host and device time by CUDA events.
//
// Design:
//   shuffle_keys: one memset (the look-back's ticket and status words)
//   and one launch of KT-row CTAs over every owner's tiles, owner after
//   owner, as one sequence.  A thread takes a row: its live test, and the
//   tile's first dead row by a ballot a warp and a shared minimum; a
//   block scan ranks the kept rows in the tile; a decoupled look-back
//   (Merrill and Garland 2016, as shuffle_partition.cu: the tile comes
//   from an atomic ticket, so every tile before it has started; a status
//   word is a flag in its top two bits and the count below, stored with
//   st.release and read with ld.acquire) gives the kept rows before the
//   tile, so a kept row's position is global across the owners.  An
//   owner's first tile writes off[d], the last tile M.  The wrapper reads
//   M (one device-to-host copy a mesh batch) to size the sorts.
//   shuffle_reduce: two launches over a grid of G x Dl CTAs, G CTAs an
//   owner (blockIdx.y), each owner's walk (its kept positions) cut into
//   G tiles that never cross to another owner:
//     1. heads: every CTA writes its share of its owner's merged table's
//        empty rows, and numbers its tile (T = the walk / G, 256-row
//        multiples): each position's source row (one int32, ~row when
//        dead) and its segment count within the tile with the head flag
//        (one uint32), and the tile's segment and live-segment counts.
//        The previous row's keys come by a warp shuffle; an owner's first
//        position starts a segment.
//     2. reduce: every CTA sums the counts of its owner's tiles before its
//        own (its first gid) and of all of them (n_groups: stats[d, 0],
//        flive[d]), then walks its tile from the scratch words alone.
//        Rows of at most 32 reduced words (n_sum + 2A): a row a lane, the
//        lanes of a warp reduced over each run of equal gid by shuffles.
//        Wider rows (the dense strategy's bucket lanes): a warp takes a
//        run of consecutive positions, skips those that add nothing by a
//        ballot, and its lanes stride over the row's words with running
//        sums, mins and maxs in registers, flushed at each gid change.  A
//        segment that lies wholly in one warp's run is stored; one that
//        crosses runs adds each run's part by atomics.  All arithmetic is
//        integer (sums wrap as int64, min and max exact), so the order of
//        the atomics cannot change a word.
//   shuffle_unpack: one launch, a thread per output word, region by
//   region (keys, lanes, each histogram, mins, maxs), so neighbouring
//   threads write neighbouring words and read neighbouring words of a
//   gathered row; one warp sums the statistics rows, a lane a column.

#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "desc.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WIDE_WORDS = 32;  // reduced words past which a warp takes a row
constexpr int ACC = 8;          // a lane's register words per pass (wide)
constexpr int KT = 1024;        // threads of a shuffle_keys CTA
constexpr int KR = 8;           // consecutive rows a thread
constexpr int KTILE = KT * KR;  // rows a tile
constexpr int MAX_PACK = 64;    // lanes a packed sort key holds
constexpr long long SENTINEL = 0x7fffffffffffffffll;
constexpr long long I64_MIN = -SENTINEL - 1;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long FLAG_AGG = 1ull << 62;
constexpr unsigned long long FLAG_PREFIX = 2ull << 62;
constexpr unsigned long long COUNT_MASK = (1ull << 62) - 1;

}  // namespace

// Mirrored field for field by ShuffleKeysArgs in parallel/mesh.py
// (ctypes).
struct ShuffleKeysArgs {
  const long long* rows;           // [Dl, N, WP]
  long long* keys;                 // [K + 1, Dl * N]: the first M columns
  int* src;                        // [Dl * N]: the first M
  int* off;                        // [Dl + 1]
  unsigned long long* status;      // [1 + Dl * ntiles], zeroed
  unsigned long long* info;        // [1 + 2K], zeroed: M, then per key
                                   // the live rows' greatest u and ~u
                                   // (u = key ^ 2^63: unsigned order)
  long long N;
  int Dl;
  int K;
  int WP;
  int ntiles;                      // tiles an owner: ceil(N / KTILE)
};

// Mirrored field for field by ShufflePackArgs in parallel/mesh.py
// (ctypes): the sort key of each kept row packed from its lanes, lane
// lane[j] at bits[j] bits, its code v - lo[j], or dead[j] for SENTINEL.
struct ShufflePackArgs {
  const long long* keys;           // [K + 1, stride]: shuffle_keys' lanes
  void* out;                       // [M] int32 or int64
  long long stride;
  long long M;
  int n;                           // lanes packed, the most significant
  int wide;                        // first; 1: int64 out, 0: int32
  int lane[MAX_PACK];
  int bits[MAX_PACK];
  long long lo[MAX_PACK];
  long long dead[MAX_PACK];
};

// Mirrored field for field by ShuffleReduceArgs in parallel/mesh.py
// (ctypes).
struct ShuffleReduceArgs {
  const long long* rows;     // [Dl * N, WP]
  const int* src;            // [M] shuffle_keys' kept rows
  const long long* p;        // [M] the last sort's indices
  const long long* base;     // [M] the permutation before it, or null
  const int* off;            // [Dl + 1] each owner's first position, M
  long long* merged;         // [Dl, cap, WP]
  int* flive;                // [Dl, cap]
  long long* stats;          // [Dl, nstat]: word 0 of each owner's row
  int* scratch;              // [2M + 2 Dl G]: see scratch_of
  long long M;
  int cap;
  int K;
  int n_sum;
  int A;
  int WP;
  int Dl;
  int nstat;
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

// The merge's scratch words: each walked position's source row (~row
// when dead), its tile-local segment count << 1 | head flag, and each
// (owner, tile)'s segment and live-segment counts.
struct Scratch {
  int* src;
  unsigned* seg;
  int* tiles;   // [Dl, 2, G]: segments, then live segments
};

__device__ __forceinline__ Scratch scratch_of(const ShuffleReduceArgs& a) {
  Scratch s;
  s.src = a.scratch;
  s.seg = reinterpret_cast<unsigned*>(a.scratch + a.M);
  s.tiles = a.scratch + 2 * a.M + 2 * blockIdx.y * gridDim.x;
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
  return a.src[a.base ? a.base[q] : q];
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

// The greatest x over the warp's lanes.
__device__ __forceinline__ unsigned long long warp_max(unsigned long long x) {
  for (int k = 16; k; k >>= 1) {
    const unsigned long long y = __shfl_xor_sync(FULL, x, k);
    x = y > x ? y : x;
  }
  return x;
}

// shuffle_keys: the kept rows of every owner, their operands and places,
// and the live rows' key ranges.  A thread takes KR consecutive rows.
__global__ void __launch_bounds__(KT) keys_kernel(const ShuffleKeysArgs a) {
  __shared__ int s_ticket, s_first, s_excl;
  __shared__ unsigned long long s_mm[KT / 32][2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    s_ticket = (int)atomicAdd(a.status, 1ull);
    s_first = KTILE;
  }
  __syncthreads();
  const int t = s_ticket;
  const int d = t / a.ntiles;
  const long long i0 = (long long)(t - d * a.ntiles) * KTILE +
                       threadIdx.x * KR;
  // this thread's first row (past the owner's last one: its rows are
  // not read), and its rows' live tests, their loads issued together
  const long long* rows = a.rows + ((long long)d * a.N + i0) * a.WP;
  const long long* last = a.rows + ((long long)d * a.N + a.N - 1) * a.WP;
  unsigned live = 0u, in = 0u;
#pragma unroll
  for (int j = 0; j < KR; ++j) {
    const long long* row = i0 + j < a.N ? rows + j * a.WP : last;
    const long long c = row[a.K], s = row[a.K + 1];
    if (i0 + j < a.N) {
      in |= 1u << j;
      if (c > 0 || s > 0) live |= 1u << j;
    }
  }
  // the tile's first dead row: the first thread with one, its first
  const unsigned dead = in & ~live;
  const unsigned has = __ballot_sync(FULL, dead != 0u);
  if (has && lane == __ffs(has) - 1)
    atomicMin(&s_first, (int)threadIdx.x * KR + __ffs(dead) - 1);
  __syncthreads();
  unsigned keep = live;
  const int f = s_first - (int)threadIdx.x * KR;
  if (f >= 0 && f < KR) keep |= 1u << f;
  int count;
  const int rank = block_scan<KT>(__popc(keep), &count);
  // the kept rows of every tile before this one, by the look-back
  if (warp == 0) {
    unsigned long long* st = a.status + 1;
    unsigned long long excl = 0ull;
    if (t == 0) {
      if (lane == 0) st_release(st, FLAG_PREFIX | (unsigned long long)count);
    } else {
      if (lane == 0) st_release(st + t, FLAG_AGG | (unsigned long long)count);
      for (int hi = t - 1;; hi -= 32) {
        const int j = hi - lane;
        unsigned long long w = j >= 0 ? ld_acquire(st + j) : FLAG_PREFIX;
        // wait until the 32 tiles before have each published
        while (__any_sync(FULL, (w >> 62) == 0))
          if ((w >> 62) == 0) w = ld_acquire(st + j);
        const unsigned pre = __ballot_sync(FULL, (w >> 62) == 2);
        const int stop = pre ? __ffs(pre) - 1 : 31;
        unsigned long long c = lane <= stop ? (w & COUNT_MASK) : 0ull;
        for (int k = 16; k; k >>= 1) c += __shfl_xor_sync(FULL, c, k);
        excl += c;
        if (pre) break;
      }
      if (lane == 0)
        st_release(st + t, FLAG_PREFIX | (excl + (unsigned long long)count));
    }
    if (lane == 0) {
      s_excl = (int)excl;
      if (t == d * a.ntiles) a.off[d] = (int)excl;
      if (t == a.Dl * a.ntiles - 1) {
        a.off[a.Dl] = (int)excl + count;
        a.info[0] = excl + (unsigned long long)count;
      }
    }
  }
  __syncthreads();
  const long long stride = (long long)a.Dl * a.N;
  long long pos = s_excl + rank;
  for (int j = 0; j < KR; ++j) {
    if (!((keep >> j) & 1u)) continue;
    a.src[pos] = (int)((long long)d * a.N + i0 + j);
    a.keys[pos] = d;
    ++pos;
  }
  // the key lanes, and each lane's range over the live rows
  for (int k = 0; k < a.K; ++k) {
    unsigned long long mx = 0ull, mn = 0ull;   // greatest u and ~u
    pos = s_excl + rank;
    for (int j = 0; j < KR; ++j) {
      if (!((keep >> j) & 1u)) continue;
      const bool lv = (live >> j) & 1u;
      const long long v = lv ? rows[j * a.WP + k] : SENTINEL;
      a.keys[(k + 1) * stride + pos] = v;
      ++pos;
      if (!lv) continue;
      const unsigned long long u = (unsigned long long)v ^ (1ull << 63);
      mx = u > mx ? u : mx;
      mn = ~u > mn ? ~u : mn;
    }
    mx = warp_max(mx);
    mn = warp_max(mn);
    if (lane == 0) {
      s_mm[warp][0] = mx;
      s_mm[warp][1] = mn;
    }
    __syncthreads();
    if (warp == 0) {
      mx = warp_max(s_mm[lane][0]);
      mn = warp_max(s_mm[lane][1]);
      if (lane == 0 && (mx | mn)) {
        atomicMax(a.info + 1 + 2 * k, mx);
        atomicMax(a.info + 2 + 2 * k, mn);
      }
    }
    __syncthreads();
  }
}

// The packed sort keys of the kept rows: a thread a row.
template <bool WIDE>
__global__ void __launch_bounds__(THREADS) pack_kernel(
    const ShufflePackArgs a) {
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < a.M;
       i += (long long)gridDim.x * THREADS) {
    unsigned long long code = 0ull;
    for (int j = 0; j < a.n; ++j) {
      const long long v = a.keys[a.lane[j] * a.stride + i];
      code = (code << a.bits[j]) |
             (v == SENTINEL ? (unsigned long long)a.dead[j]
                            : (unsigned long long)v -
                                  (unsigned long long)a.lo[j]);
    }
    if (WIDE)
      static_cast<long long*>(a.out)[i] = (long long)code;
    else
      static_cast<int*>(a.out)[i] = (int)code;
  }
}

// Pass 1: each owner's merged table's empty rows, and each position's
// source row and segment count within its tile.
__global__ void __launch_bounds__(THREADS) heads_kernel(
    const ShuffleReduceArgs a) {
  const Scratch sc = scratch_of(a);
  const int d = blockIdx.y;
  const long long first = a.off[d];
  const long long M = a.off[d + 1] - first;

  long long* merged = a.merged + (long long)d * a.cap * a.WP;
  const int nw = a.cap * a.WP;  // < 2^31, checked by the entry
  for (int x = blockIdx.x * THREADS + threadIdx.x; x < nw;
       x += gridDim.x * THREADS) {
    const int m = x % a.WP - a.K - a.n_sum;  // >= 0: a min or max word
    merged[x] = m < 0 ? 0 : (m < a.A ? SENTINEL : I64_MIN);
  }

  const long long T = tile_rows(M);
  const long long lo = first + min((long long)blockIdx.x * T, M);
  const long long hi = first + min((long long)blockIdx.x * T + T, M);
  __shared__ int s_src[THREADS];  // the chunk's source rows, ~row if dead
  __shared__ int s_prev;          // the position before the chunk's
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0 && lo > first && lo < hi) {
    const int r = src_of(a, lo - 1);
    s_prev = live_row(a, r) ? r : ~r;
  }
  int seg = 0, nlh = 0;
  for (long long c0 = lo; c0 < hi; c0 += THREADS) {
    const long long i = c0 + threadIdx.x;
    const bool in = i < hi;
    int r = 0;
    bool live = false;
    if (in) {
      r = src_of(a, i);
      live = live_row(a, r);
    }
    s_src[threadIdx.x] = live ? r : ~r;
    __syncthreads();
    // the previous position's row: lane - 1's by a shuffle, lane 0 loads
    int q = 0;
    bool ql = false;
    if (lane == 0 && in && i > first) {
      const int v = threadIdx.x ? s_src[threadIdx.x - 1] : s_prev;
      ql = v >= 0;
      q = ql ? v : ~v;
    }
    const long long* row = a.rows + (long long)r * a.WP;
    const long long* prow = a.rows + (long long)q * a.WP;
    bool head = in && i == first;
    for (int k = 0; k < a.K; ++k) {
      const long long v = in && live ? row[k] : SENTINEL;
      long long pv = __shfl_up_sync(FULL, v, 1);
      if (lane == 0) pv = ql ? prow[k] : SENTINEL;
      head = head || (in && i > first && v != pv);
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
// taking 32 positions at a time.  [lo, hi): the tile; end: the owner's
// walk's end; merged: the owner's table.
__device__ void walk_narrow(const ShuffleReduceArgs& a, const Scratch& sc,
                            long long* merged, int before, long long lo,
                            long long hi, long long end) {
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
    else if (in && i + 1 < end)
      ends = (sc.seg[i + 1] & 1u) != 0;
    const int gprev = __shfl_up_sync(FULL, g, 1);
    const int gnext = __shfl_down_sync(FULL, g, 1);
    const bool rhead = g >= 0 && (lane == 0 || gprev != g);
    const unsigned lastm = __ballot_sync(FULL, lane == 31 || gnext != g);
    const int e = __ffs(lastm & (FULL << lane)) - 1;
    // the run is the whole segment: it starts here and ends at lane e
    const bool whole = __shfl_sync(FULL, (int)ends, e) != 0 && hd;
    const long long* row = a.rows + (long long)(contrib ? s : 0) * a.WP;
    long long* out = merged + (long long)(g < 0 ? 0 : g) * a.WP;
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
                          long long* merged, int before, long long lo,
                          long long hi, long long end) {
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
  const bool cut = whi >= end || (sc.seg[whi] & 1u) != 0;
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
        long long* out = merged + (long long)gl * a.WP;
        if (gl != cur) {
          if (cur >= 0) {
            long long* prev = merged + (long long)cur * a.WP + a.K;
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
      long long* out = merged + (long long)cur * a.WP + a.K;
      const bool whole = (cur > g0 || h0) && (cur < gend || cut);
#pragma unroll
      for (int m = 0; m < ACC; ++m) {
        const int j = c0 + lane + 32 * m;
        if (j < nw) put(out + j, acc[m], op_of(a, j), whole);
      }
    }
  }
}

// Pass 2: each CTA's first gid and its owner's n_groups from the tile
// counts, the live flags, and the tile's reduce.
template <bool WIDE>
__global__ void __launch_bounds__(THREADS) reduce_kernel(
    const ShuffleReduceArgs a) {
  const Scratch sc = scratch_of(a);
  const int d = blockIdx.y;
  const long long first = a.off[d];
  const long long M = a.off[d + 1] - first;
  int before = 0, ng = 0;
  for (int j = threadIdx.x; j < (int)gridDim.x; j += THREADS) {
    if (j < (int)blockIdx.x) before += sc.tiles[j];
    ng += sc.tiles[gridDim.x + j];
  }
  const int2 t = block_sum2(before, ng);
  if (blockIdx.x == 0 && threadIdx.x == 0)
    a.stats[(long long)d * a.nstat] = t.y;
  const int m = t.y < a.cap ? t.y : a.cap;
  for (int j = blockIdx.x * THREADS + threadIdx.x; j < a.cap;
       j += gridDim.x * THREADS)
    a.flive[(long long)d * a.cap + j] = j < m;
  const long long T = tile_rows(M);
  const long long lo = first + min((long long)blockIdx.x * T, M);
  const long long hi = first + min((long long)blockIdx.x * T + T, M);
  if (lo >= hi) return;
  long long* merged = a.merged + (long long)d * a.cap * a.WP;
  if (WIDE)
    walk_wide(a, sc, merged, t.x, lo, hi, first + M);
  else
    walk_narrow(a, sc, merged, t.x, lo, hi, first + M);
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

// Every owner's kept rows, their sort operands and places on `stream`:
// one memset of the ticket, status and info words, then one launch of
// Dl * ntiles CTAs.  Returns cudaError_t.
extern "C" int shuffle_keys(const ShuffleKeysArgs* args, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ShuffleKeysArgs& a = *args;
  if (a.N < 1 || a.Dl < 1 || a.K < 1 || a.WP < a.K + 2 ||
      (long long)a.Dl * a.N >= (1ll << 31) ||
      a.ntiles != (int)((a.N + KTILE - 1) / KTILE) ||
      a.info != a.status + 1 + (size_t)a.Dl * a.ntiles)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(
      a.status, 0,
      (2 + (size_t)a.Dl * a.ntiles + 2 * (size_t)a.K) *
          sizeof(unsigned long long),
      s);
  if (err != cudaSuccess) return err;
  keys_kernel<<<a.Dl * a.ntiles, KT, 0, s>>>(a);
  return cudaGetLastError();
}

// The packed sort keys on `stream`: one launch.  Returns cudaError_t.
extern "C" int shuffle_pack(const ShufflePackArgs* args, int grid,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ShufflePackArgs& a = *args;
  if (a.M < 1 || a.n < 1 || a.n > MAX_PACK || grid < 1)
    return cudaErrorInvalidValue;
  if (a.wide)
    pack_kernel<true><<<grid, THREADS, 0, s>>>(a);
  else
    pack_kernel<false><<<grid, THREADS, 0, s>>>(a);
  return cudaGetLastError();
}

// Every owner's merge on `stream` in two launches (heads, reduce) of G x
// Dl CTAs; scratch holds 2M + 2 Dl G ints.  Returns cudaError_t.
extern "C" int shuffle_reduce(const ShuffleReduceArgs* args, int G,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ShuffleReduceArgs& a = *args;
  if (a.M < 1 || a.M >= (1ll << 31) || a.cap < 1 || a.K < 1 ||
      (long long)a.cap * a.WP >= (1ll << 31) || a.Dl < 1 || G < 1 ||
      a.nstat < 1 || a.WP != a.K + a.n_sum + 2 * a.A)
    return cudaErrorInvalidValue;
  const dim3 grid(G, a.Dl);
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
