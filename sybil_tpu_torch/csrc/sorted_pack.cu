// K10 sorted_pack: the keyed group table and the packed download buffer of
// the sorted scan strategy, with the device prune's score and totals, and
// the enumerated strategy's table (enum_pack).
//
// Replaces sybil_tpu/ops/scan.py:pack_outputs for a non-dense scan:
//   table    [S, K+2+5A] (1865-1872): each slot's keys, count, samples,
//            and per aggregation exists (0/1: its lane sum > 0), count,
//            wv, min, max (+2^62 / -2^62 for an avg aggregation; a mesh
//            scan's merged table brings every aggregation's min and max,
//            mmw = A); it stays on the device for the engine's escalation;
//   meta     row 0 (1902-1965): [num_groups, spill, nout per hist agg,
//            npairs (distinct pairs, else 0), the mesh shuffle's overflow
//            (0 without a mesh), pruned,
//            total count, total samples, nhistpairs per hist agg],
//            zero-padded to W;
//   prefix   rows 1..P: the table's first P rows, zero-padded to W;
//   pairs    per histogram aggregation (1979-1991), Hcap rows [keys,
//            bucket, Σw, live] of the first Hcap rows of hp_mask in row
//            order; when fewer are set the rest repeat row R-1 with live
//            = 0, as _mask_positions' clipped searchsorted does;
//   distinct with D distinct columns (1925-1933), kmax_pairs rows [the
//            K group and D distinct keys, live] of the first kmax_pairs
//            rows of K8's pair_mask, padded the same way, and meta word
//            2 + H = npairs, the number of set rows.
// K5 writes the outlier rows between the prefix and the pair sections;
// this kernel leaves them alone.
//
// The device prune (prune_topk > 0, 1874-1900, 1961-1963): the prefix is
// not written; each slot's score (live = count > 0 or samples > 0; by
// $COUNT its count where live else -1, int64; by an aggregation's mean
// f32(wv) / f32(max(count, 1)) where live and count > 0, else -inf, with
// IEEE division) goes to `score` for K12, and the meta row gets pruned =
// min(prune_topk, S, P) and the sums of the count and samples columns over
// the whole [S] table.  K12's entry then writes table[pidx] (its winners,
// in their order) as the prefix and as the pruned table, right after its
// select (topk_rows.cu: the gather, which was prune_gather here).
//
// enum_pack replaces the readout of _scan_enum (1547-1607) and its part of
// pack_outputs (1866-1879, 1902-1960): for each of the Pk = min(P, R)
// winners of K12 (row indices into the sorted packed keys) its live flag
// (the last row of a segment whose key is below the radix), its keys (the
// mixed-radix digits of its packed key, digit 0 = MISSING, else digit - 1
// + min; SENTINEL when dead), its lanes from K11's sums (0 when dead),
// min/max +2^62 / -2^62; padding rows to P (SENTINEL keys, zero lanes);
// the meta row [num_groups, spill, 0, 0, pruned = P, total count, total
// samples].
//
// Bound: memory.  The table is S x (K+2+5A) words (100,000 slots by
// default), written once with its prefix; the pair sections read one byte
// of hp_mask or pair_mask per row (8 MB each at 8,388,608 rows) and write
// their Hcap or kmax_pairs rows of W words.
//
// What a trace of the former design showed (torch.profiler on the H100;
// PERF.md §6): a call was up to five device operations (the table, the
// prune's score pass, a count of each 4,096-row tile, a one-CTA scan of
// the counts and the ranked write), the byte masks were read twice one
// byte a thread, and the wrapper's host time exceeded the device's.
//
// Design: one launch a call, after one memset of its scratch words where
// it has pair sections or the prune.
// The grid's last `tctas` CTAs write the table: a warp takes 32 / W rows
// a step (lane c of a row its column c, whose source array, stride and
// transform it works out once; W > 32 loops over the columns), issues
// its UNROLL loads before any store and stores each word to the table
// and, unpruned, to the prefix row, so every store is a whole row's
// coalesced run.  Under the prune the row's lane 0 takes the count,
// samples and the scored aggregation's lanes from the lanes that loaded
// them (shuffles) and writes the score; each CTA's count and sample sums
// go to its own scratch words, and the last table CTA to finish (a
// counter) adds them into meta words 5 + H and 6 + H.  Table CTA 0 writes
// the rest of the meta row.  The grid's first CTAs, which the hardware
// starts first, take an atomic ticket each: every section's tiles in
// order, then NHELP padding helpers a section.  A tile compacts TILE mask
// rows by Merrill and Garland's decoupled look-back (as K8's
// segment_reduce.cu): a thread loads its 64 mask bytes as four 16-byte
// vectors (byte loads where the mask is not 16-byte aligned or R % 16
// leaves a tail; lookback.cuh's mask_bits, shared with K5), the tile
// publishes its count, warp 0 sums its predecessors' published counts 32
// x LB tiles a step, by acquire loads (every tile of a call runs at once,
// so a walk of 32 a step back to tile 0 was 16 steps at 512 tiles;
// relaxed loads, all in flight at once, were 1.5 us slower at path 1's
// pair section) until it meets an inclusive prefix, and a tile whose exclusive prefix reaches the
// section's cap writes nothing; the others rank their set rows with one
// block scan and write them, and the last tile writes npairs (distinct).
// A helper waits for its section's last tile to publish the total (its
// ticket follows every tile's, so every tile has started), then writes
// its share of the padding rows [total, cap) from a copy of row R-1 in
// shared memory.  The ticket, the done count and the status words live in
// a scratch buffer of the wrapper's, one per device and stream, that the
// entry zeroes (cudaMemsetAsync) on the call's stream before the launch;
// the calls that share a buffer run in the order of that stream.  enum_pack
// is one launch, a warp a winner row: lane c computes column c and the
// row and its prefix copy are stored whole.

#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "desc.cuh"
#include "lookback.cuh"
#include <math_constants.h>

namespace {

using lookback::FULL;
using lookback::ROWS_T;
using lookback::ld_acquire;
using lookback::st_release;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = THREADS * ROWS_T;        // mask rows a CTA: 16,384
constexpr int UNROLL = 4;                     // table steps a loop
constexpr int PAD_WORDS = 512;                // padding row kept in smem
constexpr int NHELP = 16;                     // padding helpers a section
constexpr int LB = 4;                         // look-back words a lane
constexpr long long BIG = 1ll << 62;
constexpr long long SENTINEL = 0x7fffffffffffffffll;
// look-back status words: 0 until published, then the aggregate flag
// (bit 62) or the inclusive-prefix flag (bit 63), the count below
constexpr unsigned long long PREFIX_BIT = 1ull << 63;
constexpr unsigned long long AGG_BIT = 1ull << 62;
constexpr unsigned long long COUNT_MASK = AGG_BIT - 1;
// the scratch words, all zeroed by the entry: the ticket, the done count,
// two words a table CTA (its count and sample sums, written before it
// counts itself done), then nsec x ntiles status words
constexpr int MAX_TCTAS = 528;                // table CTAs at most
constexpr int S_TICKET = 0;
constexpr int S_DONE = 1;
constexpr int S_PART = 2;
constexpr int S_STATUS = S_PART + 2 * MAX_TCTAS;

}  // namespace

// Mirrored field for field by SortedPackArgs in ops/scan.py (ctypes).  The
// per-aggregation arrays point into the descriptor block (desc.cuh): no
// fixed cap on their count.
struct SortedPackArgs {
  Desc desc;
  const unsigned long long* sums;       // [S+1, L]
  const long long* mins;                // [S, H]
  const long long* maxs;                // [S, H]
  const long long* keys_tbl;            // [S, K]
  const long long* num_groups;          // [1]
  const long long* spill;               // [1]
  const long long* const* nout;         // [H] [1] per hist agg, or null
  const unsigned char* const* hp_mask;  // [H] [R] per hist agg
  const long long* const* hp_keys;      // [H] [R, K]
  const long long* const* hp_bv;        // [H] [R]
  const long long* const* hp_w;         // [H] [R]
  const long long* const* npairs;       // [H] [1]
  const long long* hp_row;              // [H] first row of each pair section
  const long long* agg_mm;              // [A] hist index of each agg, -1 = none
  const unsigned char* pair_mask;       // [R] K8's distinct pair mask (D > 0)
  const long long* kmat;                // [R, K] sorted group keys
  const long long* dmat;                // [R, D] sorted distinct keys
  long long pair_row;                   // first row of the distinct section
  long long* table;                     // [S, K+2+5A]
  long long* main;                      // [rows, W]
  unsigned long long* scratch;          // see S_TICKET (pairs or prune)
  void* score;                          // [S] prune score, int64 or f32
  long long R;
  int S;
  int P;                                // table rows in main
  int K;
  int A;
  int L;
  int H;
  int W;
  int Hcap;
  int ntiles;                           // TILE-row tiles a section
  int prune;                            // the device prune's form
  int prune_agg;                        // -1: $COUNT, else the agg
  int pruned;                           // min(prune_topk, S, P)
  int D;                                // distinct columns
  int kmax_pairs;                       // rows of the distinct section
  const long long* overflow;            // [1] meta word 3 + H, or null
  int mmw;                              // words in a row of mins and maxs
  int tctas;                            // CTAs that write the table
};

// Mirrored field for field by EnumPackArgs in ops/scan.py (ctypes).
// pack_min and pack_card point into the descriptor block (desc.cuh), of
// [K] each.
struct EnumPackArgs {
  Desc desc;
  const int* skey;                      // [R] sorted packed key
  const int* gid;                       // [R] K11's segment of each row
  const unsigned long long* sums;       // [Smax, L] K11's segment sums
  const int* widx;                      // [Pk] K12's winners
  const long long* num_groups;          // [1] live segments
  const long long* spill;               // [1]
  const long long* totals;              // [2] total count, total samples
  long long* table;                     // [P, K+2+5A]
  long long* main;                      // [1 + P, W]
  const long long* pack_min;            // [K]
  const long long* pack_card;
  long long R;
  int radix;
  int Pk;
  int P;
  int K;
  int A;
  int L;
  int W;
  int pad_;
};

namespace {

// A published status word: an aggregate or an inclusive prefix, and its
// count.
__device__ __forceinline__ unsigned long long status_word(
    bool prefix, unsigned long long count) {
  return (prefix ? PREFIX_BIT : AGG_BIT) | count;
}

__device__ __forceinline__ bool published(unsigned long long w) {
  return w != 0ull;
}

__device__ __forceinline__ bool is_prefix(unsigned long long w) {
  return (w & PREFIX_BIT) != 0ull;
}

__device__ __forceinline__ void write_score(const SortedPackArgs& a,
                                            long long g,
                                            unsigned long long cnt_u,
                                            unsigned long long smp_u,
                                            unsigned long long acnt_u,
                                            unsigned long long wv_u) {
  const long long cnt = (long long)cnt_u, smp = (long long)smp_u;
  const bool live = cnt > 0 || smp > 0;
  if (a.prune_agg >= 0) {
    const long long acnt = (long long)acnt_u, wv = (long long)wv_u;
    static_cast<float*>(a.score)[g] =
        live && acnt > 0
            ? __fdiv_rn(__ll2float_rn(wv),
                        __ll2float_rn(acnt > 1 ? acnt : 1ll))
            : -CUDART_INF_F;
  } else {
    static_cast<long long*>(a.score)[g] = live ? cnt : -1ll;
  }
}

// A lane's column of the table: its word of row g is base[g * stride]
// (kind C_LOAD), that word > 0 (C_EXISTS), or `konst` (C_CONST: an avg
// aggregation's min/max sentinel, or the prefix's zero columns past Wt).
enum { C_LOAD, C_EXISTS, C_CONST };

struct ColSrc {
  const long long* base;
  long long konst;
  int stride;
  int kind;
};

__device__ __forceinline__ ColSrc col_src(const SortedPackArgs& a, int c) {
  const long long* sums = reinterpret_cast<const long long*>(a.sums);
  if (c < a.K) return {a.keys_tbl + c, 0ll, a.K, C_LOAD};
  if (c < a.K + 2) return {sums + (c - a.K), 0ll, a.L, C_LOAD};
  const int ai = (c - a.K - 2) / 5, f = (c - a.K - 2) - 5 * ai;
  if (ai >= a.A) return {sums, 0ll, 0, C_CONST};
  if (f < 3) return {sums + 2 + 3 * ai + f, 0ll, a.L, f ? C_LOAD : C_EXISTS};
  const int mm = (int)desc_at(a.desc, a.agg_mm, ai);
  if (mm < 0) return {sums, f == 3 ? BIG : -BIG, 0, C_CONST};
  return {(f == 3 ? a.mins : a.maxs) + mm, 0ll, a.mmw, C_LOAD};
}

__device__ __forceinline__ long long col_value(const ColSrc& cs,
                                               long long raw) {
  return cs.kind == C_LOAD ? raw : cs.kind == C_EXISTS ? (long long)(raw > 0)
                                                       : cs.konst;
}

// The table CTAs (tb of tctas): the table, the prefix, the prune's scores
// and totals, and (tb 0) the meta row.
__device__ void table_part(const SortedPackArgs& a, int tb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = a.W, Wt = a.K + 2 + 5 * a.A;
  const bool narrow = W <= 32;
  const int rpw = narrow ? 32 / W : 1;        // rows a warp step
  const int rr = narrow ? lane / W : 0;       // this lane's row of the step
  const int c0 = narrow ? lane - rr * W : lane;
  const bool on = rr < rpw;                   // narrow: lanes past rpw * W idle
  const int base = rr * W;                    // the row's first lane
  const int pa = a.prune_agg;
  // the score's source lanes: count, samples, the agg's count and wv
  const int l_cnt = base + a.K, l_smp = base + a.K + 1;
  const int l_acnt = pa >= 0 ? base + a.K + 3 + 5 * pa : base;
  const int l_wv = pa >= 0 ? base + a.K + 4 + 5 * pa : base;
  unsigned long long my_cnt = 0ull, my_smp = 0ull;
  const long long step = (long long)a.tctas * WARPS * rpw;
  const ColSrc cs = col_src(a, on && narrow ? c0 : 0);
  const bool loads = on && cs.kind != C_CONST;
  for (long long wb = ((long long)tb * WARPS + warp) * rpw; wb < a.S;
       wb += step * UNROLL) {
    if (narrow) {
      // every lane issues its UNROLL loads before any store
      long long raw[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long g = wb + u * step + rr;
        raw[u] = loads && g < a.S ? __ldg(cs.base + g * cs.stride) : 0ll;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long g = wb + u * step + rr;
        const bool ok = on && g < a.S;
        const long long v = col_value(cs, raw[u]);
        if (ok && c0 < Wt) a.table[g * Wt + c0] = v;
        if (ok && !a.prune && g < a.P) a.main[(1 + g) * W + c0] = v;
        if (a.prune) {
          const unsigned long long r = (unsigned long long)raw[u];
          const unsigned long long cnt = __shfl_sync(FULL, r, l_cnt);
          const unsigned long long smp = __shfl_sync(FULL, r, l_smp);
          const unsigned long long acnt = __shfl_sync(FULL, r, l_acnt);
          const unsigned long long wv = __shfl_sync(FULL, r, l_wv);
          if (ok && c0 == 0) {
            write_score(a, g, cnt, smp, acnt, wv);
            my_cnt += cnt;
            my_smp += smp;
          }
        }
      }
    } else {
      // a row a step, the lanes over its W > 32 columns
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long g = wb + u * step;
        if (g >= a.S) break;
        for (int c = c0; c < W; c += 32) {
          const ColSrc cc = col_src(a, c);
          const long long v = col_value(
              cc, cc.kind != C_CONST ? __ldg(cc.base + g * cc.stride) : 0ll);
          if (c < Wt) a.table[g * Wt + c] = v;
          if (!a.prune && g < a.P) a.main[(1 + g) * W + c] = v;
        }
        if (a.prune && lane == 0) {
          const unsigned long long* s = a.sums + g * a.L;
          write_score(a, g, s[0], s[1], pa >= 0 ? s[3 + 3 * pa] : 0ull,
                      pa >= 0 ? s[4 + 3 * pa] : 0ull);
          my_cnt += s[0];
          my_smp += s[1];
        }
      }
    }
  }
  if (tb == 0) {
    for (int c = threadIdx.x; c < W; c += THREADS) {
      long long v = 0;
      if (c == 0) {
        v = a.num_groups[0];
      } else if (c == 1) {
        v = a.spill[0];
      } else if (c < 2 + a.H) {
        const long long* nout = desc_at(a.desc, a.nout, c - 2);
        v = nout ? nout[0] : 0ll;
      } else if (c == 2 + a.H) {
        if (a.D > 0) continue;  // npairs: the distinct section's last tile
      } else if (c == 3 + a.H) {
        v = a.overflow ? a.overflow[0] : 0ll;
      } else if (c == 4 + a.H) {
        v = a.prune ? a.pruned : 0;
      } else if (c == 5 + a.H || c == 6 + a.H) {
        if (a.prune) continue;  // the totals: the last table CTA
      } else if (c >= 7 + a.H && c < 7 + 2 * a.H) {
        v = desc_at(a.desc, a.npairs, c - 7 - a.H)[0];
      }
      a.main[c] = v;
    }
  }
  if (!a.prune) return;
  // the totals: this CTA's sums to its scratch words; the last CTA to
  // finish adds every CTA's into the meta row
  __shared__ unsigned long long s_sum[2][WARPS];
  __shared__ bool s_last;
  for (int d = 16; d; d >>= 1) {
    my_cnt += __shfl_xor_sync(FULL, my_cnt, d);
    my_smp += __shfl_xor_sync(FULL, my_smp, d);
  }
  if (lane == 0) {
    s_sum[0][warp] = my_cnt;
    s_sum[1][warp] = my_smp;
  }
  __syncthreads();
  unsigned long long* part = a.scratch + S_PART;
  if (threadIdx.x == 0) {
    unsigned long long c = 0ull, s = 0ull;
    for (int w = 0; w < WARPS; ++w) {
      c += s_sum[0][w];
      s += s_sum[1][w];
    }
    part[2 * tb] = c;
    part[2 * tb + 1] = s;
    __threadfence();
    s_last = atomicAdd(a.scratch + S_DONE, 1ull) ==
             (unsigned)a.tctas - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  unsigned long long c = 0ull, s = 0ull;
  for (int b = threadIdx.x; b < a.tctas; b += THREADS) {
    c += __ldcg(part + 2 * b);
    s += __ldcg(part + 2 * b + 1);
  }
  for (int d = 16; d; d >>= 1) {
    c += __shfl_xor_sync(FULL, c, d);
    s += __shfl_xor_sync(FULL, s, d);
  }
  __syncthreads();
  if (lane == 0) {
    s_sum[0][warp] = c;
    s_sum[1][warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    c = s = 0ull;
    for (int w = 0; w < WARPS; ++w) {
      c += s_sum[0][w];
      s += s_sum[1][w];
    }
    a.main[5 + a.H] = (long long)c;
    a.main[6 + a.H] = (long long)s;
  }
}

// Section h of the compaction: histogram aggregation h < H, or the
// distinct pairs (h == H).
__device__ __forceinline__ const unsigned char* sec_mask(
    const SortedPackArgs& a, int h) {
  return h < a.H ? desc_at(a.desc, a.hp_mask, h) : a.pair_mask;
}

__device__ __forceinline__ int sec_cap(const SortedPackArgs& a, int h) {
  return h < a.H ? a.Hcap : a.kmax_pairs;
}

__device__ __forceinline__ long long* sec_row(const SortedPackArgs& a, int h,
                                              long long j) {
  return a.main +
         ((h == a.H ? a.pair_row : desc_at(a.desc, a.hp_row, h)) + j) * a.W;
}

// Word c of section h's row for mask row r (live 1, or 0 for padding).
__device__ __forceinline__ long long pair_word(const SortedPackArgs& a,
                                               int h, long long r, int c,
                                               long long live) {
  if (h == a.H) {  // distinct: [K group keys, D distinct keys, live]
    if (c < a.K) return a.kmat[r * a.K + c];
    if (c < a.K + a.D) return a.dmat[r * a.D + c - a.K];
    return c == a.K + a.D ? live : 0ll;
  }
  if (c < a.K) return desc_at(a.desc, a.hp_keys, h)[r * a.K + c];
  if (c == a.K) return desc_at(a.desc, a.hp_bv, h)[r];
  if (c == a.K + 1) return desc_at(a.desc, a.hp_w, h)[r];
  return c == a.K + 2 ? live : 0ll;
}

// A compaction CTA: tile `tile` of section h.
__device__ void pairs_part(const SortedPackArgs& a, int h, int tile) {
  __shared__ int s_count[WARPS];
  __shared__ unsigned long long s_excl;
  __shared__ unsigned short s_rows[TILE];   // the tile's set rows, ranked
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned char* mask = sec_mask(a, h);
  const long long cap = sec_cap(a, h);
  const long long r0 = (long long)tile * TILE + (long long)threadIdx.x * ROWS_T;
  const unsigned long long bits = lookback::mask_bits(mask, r0, a.R);
  const int mine = __popcll(bits);
  const int wsum = __reduce_add_sync(FULL, mine);
  if (lane == 0) s_count[warp] = wsum;
  __syncthreads();
  // ---- the tile's prefix by decoupled look-back (warp 0) ----------------
  if (warp == 0) {
    int count = lane < WARPS ? s_count[lane] : 0;
    count = __reduce_add_sync(FULL, count);
    unsigned long long* st = a.scratch + S_STATUS + (size_t)h * a.ntiles;
    unsigned long long excl = 0ull;
    if (tile == 0) {
      if (lane == 0)
        st_release(st, status_word(true, (unsigned long long)count));
    } else {
      if (lane == 0)
        st_release(st + tile, status_word(false, (unsigned long long)count));
      // a window of 32 x LB predecessors, lane l reading tiles hi - LB *
      // l - k (k < LB): every tile has started and publishes its count
      // once it has read its mask, so the walk back to the nearest
      // inclusive prefix takes at most ntiles / (32 LB) windows even when
      // every tile publishes at once
      for (int hi = tile - 1;; hi -= 32 * LB) {
        unsigned long long w[LB];
        bool unset = false;
#pragma unroll
        for (int k = 0; k < LB; ++k) {
          const int j = hi - LB * lane - k;
          w[k] = j >= 0 ? ld_acquire(st + j) : status_word(true, 0ull);
          unset |= !published(w[k]);
        }
        while (__any_sync(FULL, unset)) {
          unset = false;
#pragma unroll
          for (int k = 0; k < LB; ++k) {
            if (!published(w[k]))
              w[k] = ld_acquire(st + hi - LB * lane - k);
            unset |= !published(w[k]);
          }
        }
        // this lane's first inclusive prefix (nearest first), or LB
        int kp = LB;
#pragma unroll
        for (int k = LB - 1; k >= 0; --k)
          if (is_prefix(w[k])) kp = k;
        const unsigned pre = __ballot_sync(FULL, kp < LB);
        const int stop = pre ? __ffs(pre) - 1 : 31;
        unsigned long long c = 0ull;
#pragma unroll
        for (int k = 0; k < LB; ++k)
          if (lane < stop || (lane == stop && k <= kp))
            c += w[k] & COUNT_MASK;
        for (int d = 16; d; d >>= 1) c += __shfl_xor_sync(FULL, c, d);
        excl += c;
        if (pre) break;
      }
      if (lane == 0)
        st_release(st + tile,
                   status_word(true, excl + (unsigned long long)count));
    }
    if (lane == 0) {
      s_excl = excl;
      s_count[0] = count;
    }
  }
  __syncthreads();
  const long long excl = (long long)s_excl;
  const int count = s_count[0];
  // ---- this tile's set rows below the cap -------------------------------
  if (count > 0 && excl < cap) {
    // the tile's set rows below the cap, ranked, to shared memory; then
    // the CTA writes their rows word by word (set rows cluster where the
    // segments are short: a thread's 64 rows may hold dozens)
    int total;
    int k = block_scan<THREADS>(mine, &total);
    const int n = (int)(cap - excl < count ? cap - excl : count);
    for (unsigned long long b = bits; b && k < n; b &= b - 1, ++k)
      s_rows[k] = (unsigned short)(threadIdx.x * ROWS_T + __ffsll((long long)b)
                                   - 1);
    __syncthreads();
    long long* o = sec_row(a, h, excl);
    const long long lo = (long long)tile * TILE;
    int c = threadIdx.x % a.W;
    const int adv = THREADS % a.W;
    for (int i = threadIdx.x; i < n * a.W; i += THREADS) {
      o[i] = pair_word(a, h, lo + s_rows[i / a.W], c, 1ll);
      c += adv;
      if (c >= a.W) c -= a.W;
    }
  }
  if (tile == a.ntiles - 1 && h == a.H && threadIdx.x == 0)
    a.main[2 + a.H] = excl + count;  // npairs: the distinct section's total
}

// A padding helper (slice `slice` of NHELP of section h): waits for the
// section's last tile to publish the total, then writes its share of the
// padding rows [total, cap), copies of row R-1 with live 0.  Its ticket
// follows every tile's, so every tile has started: the wait ends.
__device__ void pad_part(const SortedPackArgs& a, int h, int slice) {
  __shared__ long long s_total;
  __shared__ long long s_pad[PAD_WORDS];
  if (threadIdx.x == 0) {
    const unsigned long long* last =
        a.scratch + S_STATUS + (size_t)h * a.ntiles + a.ntiles - 1;
    unsigned long long w = ld_acquire(last);
    while (!is_prefix(w)) {
      __nanosleep(100);
      w = ld_acquire(last);
    }
    s_total = (long long)(w & COUNT_MASK);
  }
  __syncthreads();
  const long long cap = sec_cap(a, h), total = s_total;
  if (total >= cap) return;
  const long long share = (cap - total + NHELP - 1) / NHELP;
  const long long lo = total + slice * share;
  const long long hi = lo + share < cap ? lo + share : cap;
  if (lo >= hi) return;
  long long* dst = sec_row(a, h, lo);
  const long long npad = hi - lo;
  if (a.W <= PAD_WORDS) {
    for (int c = threadIdx.x; c < a.W; c += THREADS)
      s_pad[c] = pair_word(a, h, a.R - 1, c, 0ll);
    __syncthreads();
    const long long n = npad * a.W;
    int c = threadIdx.x % a.W;
    const int adv = THREADS % a.W;
    for (long long i = threadIdx.x; i < n; i += THREADS) {
      dst[i] = s_pad[c];
      c += adv;
      if (c >= a.W) c -= a.W;
    }
  } else {
    for (long long j = threadIdx.x; j < npad; j += THREADS)
      for (int c = 0; c < a.W; ++c)
        dst[j * a.W + c] = pair_word(a, h, a.R - 1, c, 0ll);
  }
}

// The grid: nsec x (ntiles + NHELP) pair CTAs first, which start first,
// each given its role by an atomic ticket (every section's tiles, in
// order, then the padding helpers); then the tctas table CTAs.
__global__ void __launch_bounds__(THREADS, 4) sorted_pack_kernel(
    const SortedPackArgs a) {
  const int nsec = a.H + (a.D > 0 ? 1 : 0);
  const int npc = nsec * (a.ntiles + NHELP);
  if ((int)blockIdx.x >= npc) {
    table_part(a, (int)blockIdx.x - npc);
    return;
  }
  __shared__ int s_ticket;
  if (threadIdx.x == 0)
    s_ticket = (int)atomicAdd(a.scratch + S_TICKET, 1ull);
  __syncthreads();
  const int t = s_ticket, ntile = nsec * a.ntiles;
  if (t < ntile)
    pairs_part(a, t / a.ntiles, t % a.ntiles);
  else
    pad_part(a, (t - ntile) / NHELP, (t - ntile) % NHELP);
}

__global__ void __launch_bounds__(THREADS) enum_pack_kernel(
    const EnumPackArgs a) {
  const int lane = threadIdx.x & 31;
  const int K = a.K, W = a.W, Wt = a.K + 2 + 5 * a.A;
  for (long long j = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
       j < a.P; j += (long long)gridDim.x * WARPS) {
    bool live = false;
    int key = 0, seg = 0;
    if (j < a.Pk) {  // every lane loads the same words: one broadcast
      const long long w = a.widx[j];
      key = a.skey[w];
      live = key < a.radix && (w == a.R - 1 || a.skey[w + 1] != key);
      seg = a.gid[w];
    }
    const unsigned long long* s = a.sums + (size_t)seg * a.L;
    for (int c = lane; c < W; c += 32) {
      long long v = 0;
      if (c < K) {
        long long g = key, d = 0;
        for (int k = K - 1; k >= c; --k) {
          const long long radix = desc_at(a.desc, a.pack_card, k) + 1;
          d = g % radix;
          g /= radix;
        }
        const unsigned long long mn =
            (unsigned long long)desc_at(a.desc, a.pack_min, c);
        v = !live ? SENTINEL
                  : d == 0 ? -1ll
                           : (long long)((unsigned long long)d - 1ull + mn);
      } else if (c < K + 2) {
        v = live ? (long long)s[c - K] : 0ll;
      } else if (c < Wt) {
        const int ai = (c - K - 2) / 5, f = (c - K - 2) - 5 * ai;
        if (f == 0) v = live && (long long)s[2 + 3 * ai] > 0;
        else if (f < 3) v = live ? (long long)s[2 + 3 * ai + f] : 0ll;
        else v = f == 3 ? BIG : -BIG;
      }
      if (c < Wt) a.table[j * Wt + c] = v;
      a.main[(1 + j) * W + c] = v;
    }
  }
  for (int c = threadIdx.x; blockIdx.x == 0 && c < W; c += THREADS) {
    long long v = 0;
    if (c == 0) v = a.num_groups[0];
    else if (c == 1) v = a.spill[0];
    else if (c == 4) v = a.P;
    else if (c == 5) v = a.totals[0];
    else if (c == 6) v = a.totals[1];
    a.main[c] = v;
  }
}

}  // namespace

// Copies the descriptor block, zeroes the scratch words (pairs or prune),
// then runs the one launch on `stream`.  Returns cudaError_t.
extern "C" int sorted_pack(const SortedPackArgs* args, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const SortedPackArgs& a = *args;
  const int nsec = a.H + (a.D > 0 ? 1 : 0);
  if (a.W < 7 + 2 * a.H || a.P > a.S || a.S < 1 || a.R < 1 ||
      a.R >= (1ll << 31) || a.L != 2 + 3 * a.A || a.tctas < 1 ||
      a.tctas > MAX_TCTAS ||
      a.ntiles != (int)((a.R + TILE - 1) / TILE) ||
      ((nsec > 0 || a.prune) && a.scratch == nullptr) ||
      (a.prune && (a.score == nullptr || a.prune_agg >= a.A)) ||
      (a.D > 0 && (!a.pair_mask || !a.kmat || !a.dmat ||
                   a.W < a.K + a.D + 1)) ||
      (a.H > 0 && a.W < a.K + 3))
    return cudaErrorInvalidValue;
  cudaError_t err = desc_upload(a.desc, s);
  if (err != cudaSuccess) return err;
  if (nsec > 0 || a.prune) {
    err = cudaMemsetAsync(a.scratch, 0,
                          (S_STATUS + (size_t)nsec * a.ntiles) *
                              sizeof(unsigned long long), s);
    if (err != cudaSuccess) return err;
  }
  sorted_pack_kernel<<<a.tctas + nsec * (a.ntiles + NHELP), THREADS, 0,
                       s>>>(a);
  return cudaGetLastError();
}

// Copies the descriptor block, then writes the enumerated strategy's
// table, meta row and prefix in one launch.  Returns cudaError_t.
extern "C" int enum_pack(const EnumPackArgs* args, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const EnumPackArgs& a = *args;
  if (a.K < 1 || a.L != 2 + 3 * a.A ||
      a.Pk < 1 || a.Pk > a.P || a.W < 7 || a.W < a.K + 2 + 5 * a.A)
    return cudaErrorInvalidValue;
  const cudaError_t err = desc_upload(a.desc, s);
  if (err != cudaSuccess) return err;
  const int grid = (a.P + WARPS - 1) / WARPS;
  enum_pack_kernel<<<grid, THREADS, 0, s>>>(a);
  return cudaGetLastError();
}
