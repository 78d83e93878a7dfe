// K11 enum_segments: the groups of the enumerated scan strategy, from the
// rows sorted by their packed key.
//
// Replaces sybil_tpu/ops/scan.py:_scan_enum 1484-1546.  The reference sums
// each group in row space without a scatter (bit-packed carriers through
// the sort, their cumsum minus a cummax-propagated segment base, or a
// gather and cumsum of int64 lanes), because large scatters are serial
// loops on a TPU.  Only its outputs have to match:
//   gid[i]      the segment of sorted row i (segments are runs of equal
//               packed keys);
//   sums[s, L]  per live segment s (key below the radix: the radix segment
//               holds the unmatched and spilled rows) the exact sums of the
//               lanes [w, 1, (exists, kw, kw*(v-bias)) x A] of
//               _agg_row_data, read from the columns at the original row
//               p[i]; unsigned 64-bit, wrapping like the reference's int64
//               sums; 0 for the radix segment and past the last segment.
//               Every lane is summed, whatever the reference's carry plan
//               skips: the plan's claims (a lane equal to the row count)
//               hold exactly when the bind proved them;
//   score[i]    at each live segment's last row the prune score: its count
//               lane ($COUNT, int64), or f32(wv) / f32(max(acnt, 1)) where
//               acnt > 0, else -inf (prune_agg, with IEEE division and
//               round-to-nearest int64 -> f32 conversions, as XLA's); -1 or
//               -inf at every other row (1536-1546);
//   num_groups  the live segments: all segments, less the radix segment
//               when it exists (it sorts last).
//
// Bound: memory.  Per row: the sorted key (4 B) and p (8 B) read, the
// aggregation and weight columns gathered at p (9 B each), gid (4 B) and
// the score written; each segment's L sums written.
//
// What a trace of the former design showed (torch.profiler on the H100;
// PERF.md §6): five device operations a call (a memset of the
// sums, a count of each 4,096-row tile's boundaries, a one-CTA scan of the
// counts, a reduce and a score pass).  The reduce walked its tile 256 rows
// at a time, 16 serial steps each with a block scan, and each row's p and
// then its gathers were one dependent chain of loads, nothing in flight
// across steps; one 64-bit atomic a warp run and lane.
//
// Design: one cooperative launch (its CTAs co-resident, grid-wide
// barriers between the phases), one CTA of TT threads a SM, no memset and
// no atomics.  Warp gw of the grid owns the contiguous row range [gw *
// span, (gw + 1) * span) (span a multiple of 4, the rows split evenly
// over every warp of the card) and walks it in steps of 32 * RL rows, RL
// consecutive rows a lane (one load of the lane's keys and of its p, one
// store of its gids and of its scores, neighbouring lanes on neighbouring
// rows).
//   phase 1  each warp counts the segment starts of its range (the key
//            differs from the row before; row 0); the counts of the
//            ranges and of each CTA go to a scratch; barrier.
//   phase 2  each warp takes its first gid from the counts of the CTAs
//            and warps before it, and zeroes its share of the sums rows
//            past the last segment.  A step's keys and p are loaded two
//            steps ahead, the gathers of its live rows (the weight, the
//            first aggregation's value and validity) one step ahead, each
//            kept as loaded until the step uses it.  A lane's row's gid
//            is the range's count so far plus a warp scan of the lanes'
//            starts.  A lane of the sums is a running prefix P over the
//            range (a warp scan of the lanes' row sums; the count lanes,
//            0 or 1 a row, three to a scan in 21-bit fields; an
//            aggregation's scans interleaved), and a segment's sum is P
//            at its last row less P before its first (unsigned
//            wrap-around is exact): the prefix before the segment open at
//            a lane's first row comes from the nearest earlier lane with
//            a start, or from the step before, held per warp in shared
//            memory.  So the row that ends a segment writes its sums row
//            and its score with plain stores, except the range's first
//            segment when it began in an earlier range (the head): its
//            partial sum waits in shared memory.  Each range's tail (P
//            past its last start, or its whole P) goes to the scratch,
//            and after a CTA barrier each CTA's tail (its ranges' tails
//            from its last start on); barrier.
//   phase 3  a warp whose head ends in its range adds the tails back to
//            the range where the segment starts (the nearest earlier one
//            with a start): its own CTA's ranges', then a CTA's tail for
//            each earlier CTA, so a segment across thousands of ranges
//            takes a few loads; and writes the head's sums row and score.
// Tried and dropped on the H100 (PERF.md §6; device ms at config
// 5's $COUNT): 1,024 threads a SM with 4 rows a lane (0.274) or 2 (0.210;
// 64 registers, spills), a serial walk back over the ranges' tails in
// phase 3 (0.210; a CTA's tail a CTA 0.188), each lane's sum a scan of its
// own (about 0.18), the gathered columns prefetched into L2 in phase 1 (no
// gain), and once the loads were pipelined 4 rows a lane, 1,024 threads
// or 2 CTAs a SM (0.19-0.40, spills).
// Also dropped, timed beside this design in the same calls: the
// single-pass plan of segment_reduce.cu (K8).  CTAs of 512 threads took
// tiles of 2,048 rows from an atomic ticket; a decoupled look-back of the
// tiles' start counts gave the gids, and a second one carried the open
// segment's L sums, so the tile that held a segment's last row wrote its
// sums row and score with plain stores (one cooperative launch, for the
// zeroing after the last tile; no memset: the ticket and status words
// zeroed once and cleared by each launch).  It was bit for bit on every
// case, but took 0.2256-0.2388 at 2 CTAs a SM and 0.2038-0.2042 at 1,
// against 0.1490-0.1647 here.  A tile is a chain of four CTA barriers and
// two look-backs.  With 132-264 tiles in flight each publishes its prefix
// late, so most look-backs read past 32 tiles.  Its gathers wait between
// the barriers (0.128 without them), where a warp here keeps its next
// step's gathers in flight.  Loading the next tile during the look-backs
// did not help (0.2379-0.2404, spills).

#include <cooperative_groups.h>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "desc.cuh"
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TT = 512;                  // threads of the one CTA a SM
constexpr int NW = TT / 32;              // warps (ranges) a CTA
constexpr int RL = 2;                    // rows a lane a step
constexpr int STEP = 32 * RL;            // rows a warp a step
constexpr unsigned FULL = 0xffffffffu;
// a.paths (optional) counts, for the checks: ranges whose first row
// continues a segment (cut by a range edge); heads whose carry read more
// than one earlier range's tail, and more than 32; ranges whose last row
// ends a segment (not the batch's last row); and steps whose first row
// continues a segment begun in an earlier step of the range
enum { P_CUT, P_MULTI, P_DEEP, P_LAST, P_STEP };

}  // namespace

// Mirrored field for field by EnumSegmentsArgs in ops/scan.py (ctypes).  The
// per-aggregation arrays point into the descriptor block (desc.cuh), of
// [naggs] each.
struct EnumSegmentsArgs {
  Desc desc;
  const int* skey;                 // [R] sorted packed key
  const long long* p;              // [R] the sort's indices: original rows
  const long long* const* agg_vals;
  const unsigned char* const* agg_valid;
  const long long* agg_dmin;
  const long long* agg_dmax;
  const long long* agg_bias;
  const long long* w_vals;         // weight column (has_weight)
  const unsigned char* w_valid;
  int* gid;                        // [R]
  unsigned long long* sums;        // [Smax, L]
  void* score;                     // [R] int64 ($COUNT) or f32
  unsigned long long* tails;       // [nranges, L] scratch: a range's tail
  unsigned long long* cta_tails;   // [grid, L] scratch: a CTA's tail
  int* counts;                     // [nranges] scratch: a range's starts
  int* cta_counts;                 // [grid] scratch: a CTA's starts
  int* cta_last;                   // [grid] scratch: its last range with
                                   // a start (-1: none)
  unsigned long long* paths;       // [5] path counts (P_*), or null
  long long* num_groups;           // [1]
  long long R;
  long long span;                  // rows a range (a multiple of 4)
  int radix;                       // the packed key of dead rows
  int Smax;                        // min(R, radix + 1)
  int L;
  int naggs;
  int nranges;                     // ceil(R / span)
  int has_weight;
  int prune_agg;                   // -1: $COUNT, else the agg of the mean
  int pad_;
};

namespace {

// Rows i0..i0+RL-1 of an int32 array (any past R read as 0): one load of
// 4 * RL bytes; LAST: their last read (evict first from L2).
template <bool LAST>
__device__ __forceinline__ void load_rows(const int* __restrict__ src,
                                          int i0, int R, int (&k)[RL]) {
  if (i0 + RL <= R) {
    if constexpr (RL == 4) {
      const int4* q = reinterpret_cast<const int4*>(src + i0);
      const int4 v = LAST ? __ldcs(q) : *q;
      k[0] = v.x, k[1] = v.y, k[2] = v.z, k[3] = v.w;
    } else {
      const int2* q = reinterpret_cast<const int2*>(src + i0);
      const int2 v = LAST ? __ldcs(q) : *q;
      k[0] = v.x, k[1] = v.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < RL; ++j) k[j] = i0 + j < R ? src[i0 + j] : 0;
  }
}

// p of rows i0..i0+RL-1 (below 2^31), as ints, read once (evict first);
// a row past R reads 0.
__device__ __forceinline__ void load_p(const long long* __restrict__ p,
                                       int i0, int R, int (&r)[RL]) {
  if (i0 + RL <= R) {
#pragma unroll
    for (int h = 0; h < RL; h += 2) {
      const longlong2 u =
          __ldcs(reinterpret_cast<const longlong2*>(p + i0 + h));
      r[h] = (int)u.x, r[h + 1] = (int)u.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < RL; ++j) r[j] = i0 + j < R ? (int)p[i0 + j] : 0;
  }
}

// Stores rows i0..i0+RL-1 of out below hi: one store of RL values where
// they all are, streaming (evict first: nothing here reads them again).
template <class T>
__device__ __forceinline__ void store_rows(T* __restrict__ out, int i0,
                                           int hi, const T (&x)[RL]) {
  if (i0 + RL <= hi) {
    if constexpr (sizeof(T) * RL == 16) {
      uint4 v;
      memcpy(&v, x, 16);
      __stcs(reinterpret_cast<uint4*>(out + i0), v);
    } else if constexpr (sizeof(T) * RL == 32) {
      uint4 v[2];
      memcpy(v, x, 32);
      __stcs(reinterpret_cast<uint4*>(out + i0), v[0]);
      __stcs(reinterpret_cast<uint4*>(out + i0) + 1, v[1]);
    } else {
      uint2 v;
      memcpy(&v, x, 8);
      __stcs(reinterpret_cast<uint2*>(out + i0), v);
    }
  } else {
#pragma unroll
    for (int j = 0; j < RL; ++j)
      if (i0 + j < hi) out[i0 + j] = x[j];
  }
}

// The rows of i0..i0+RL-1 below hi that start a segment (bit j: row
// i0+j).  prev: the key of the row before the warp's step (lane 0's
// predecessor).  Every lane must call it.
__device__ __forceinline__ unsigned starts(const int (&k)[RL], int i0,
                                           int hi, int prev, int lane) {
  int up = __shfl_up_sync(FULL, k[RL - 1], 1);
  if (lane == 0) up = prev;
  unsigned bm = 0u;
#pragma unroll
  for (int j = 0; j < RL; ++j) {
    const int i = i0 + j;
    if (i < hi && (i == 0 || k[j] != (j ? k[j - 1] : up))) bm |= 1u << j;
  }
  return bm;
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long x) {
#pragma unroll
  for (int d = 16; d; d >>= 1) x += __shfl_xor_sync(FULL, x, d);
  return x;
}

// The scans of MASK's bits (of 4) of the sums over a step, interleaved:
// x[n][j] is row i0+j's value in scan n, bm the rows that start a segment.
// P[sl[n]] and Pst[sl[n]] (this warp's words in shared memory) hold scan
// n's prefix over the range before the step and the prefix before the
// segment open at the step's first row.  seg[n][j] gets, at a row that
// ends a segment, the segment's sum over the range up to it.  All lanes of
// the warp must call it.
template <unsigned MASK>
__device__ __forceinline__ void scan_steps(
    const unsigned long long (&x)[4][RL], unsigned bm, int lane,
    unsigned long long* P, unsigned long long* Pst, const int (&sl)[4],
    unsigned long long (&seg)[4][RL]) {
  unsigned long long c[4][RL], inc[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    if (!((MASK >> n) & 1u)) continue;
    c[n][0] = x[n][0];
#pragma unroll
    for (int j = 1; j < RL; ++j) c[n][j] = c[n][j - 1] + x[n][j];
    inc[n] = c[n][RL - 1];
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      if (!((MASK >> n) & 1u)) continue;
      const unsigned long long y = __shfl_up_sync(FULL, inc[n], d);
      if (lane >= d) inc[n] += y;
    }
  }
  const unsigned have = __ballot_sync(FULL, bm != 0u);
  const unsigned below = have & ((1u << lane) - 1u);
  unsigned long long nP[4], nPst[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    if (!((MASK >> n) & 1u)) continue;
    const unsigned long long P0 = P[sl[n]], Pst0 = Pst[sl[n]];
    // the prefix before the lane, and before its last start
    const unsigned long long base = P0 + inc[n] - c[n][RL - 1];
    unsigned long long last = 0ull;
#pragma unroll
    for (int j = 0; j < RL; ++j)
      if ((bm >> j) & 1u) last = base + c[n][j] - x[n][j];
    const unsigned long long from =
        __shfl_sync(FULL, last, below ? 31 - __clz(below) : 0);
    unsigned long long cur = below ? from : Pst0;
#pragma unroll
    for (int j = 0; j < RL; ++j) {
      if ((bm >> j) & 1u) cur = base + c[n][j] - x[n][j];
      seg[n][j] = base + c[n][j] - cur;
    }
    nPst[n] = have ? __shfl_sync(FULL, last, 31 - __clz(have)) : Pst0;
    nP[n] = __shfl_sync(FULL, inc[n] + P0, 31);
  }
  __syncwarp();
  if (lane == 0) {
#pragma unroll
    for (int n = 0; n < 4; ++n)
      if ((MASK >> n) & 1u) P[sl[n]] = nP[n], Pst[sl[n]] = nPst[n];
  }
  __syncwarp();
}

// Count lanes (0 or 1 a row) ride three to a scan in 21-bit fields: a
// range's count is at most its span (below 2^21, which the C entry
// checks), so no field carries into the next.
constexpr int FB = 21;
constexpr unsigned long long FM = (1ull << FB) - 1ull;

template <bool HEAD, bool F32, bool HAS_W>
__global__ void __launch_bounds__(TT, 1) segments_kernel(
    const EnumSegmentsArgs a) {
  // per warp: P [L], Pst [L], the head's partial sums [L]
  extern __shared__ unsigned long long s_lanes[];
  __shared__ int s_cnt[NW];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int L = a.L;
  const int gw = blockIdx.x * NW + warp;
  const int R = (int)a.R;
  const int lo = (int)min((long long)gw * a.span, a.R);
  const int hi = (int)min((long long)lo + a.span, a.R);
  const int* __restrict__ skey = a.skey;
  const int prev0 = lo > 0 && lo < hi ? skey[lo - 1] : 0;

  // ---- phase 1: the starts of each range ---------------------------------
  {
    int n = 0, prev = prev0;
    for (int s = lo; s < hi; s += STEP) {
      int k[RL];
      load_rows<false>(skey, s + RL * lane, R, k);
      n += __popc(starts(k, s + RL * lane, hi, prev, lane));
      prev = __shfl_sync(FULL, k[RL - 1], 31);
    }
    n = __reduce_add_sync(FULL, n);
    if (lane == 0) {
      s_cnt[warp] = n;
      if (gw < a.nranges) a.counts[gw] = n;
    }
    __syncthreads();
    if (warp == 0) {
      const int c = __reduce_add_sync(FULL, lane < NW ? s_cnt[lane] : 0);
      if (lane == 0) a.cta_counts[blockIdx.x] = c;
    }
  }
  grid.sync();

  // ---- phase 2: gids, the sums of the segments that end in the range ----
  int before = 0, nseg = 0;  // starts before the range, and in all
  for (int c0 = 0; c0 < (int)gridDim.x; c0 += 32) {
    const int c = c0 + lane;
    const int x = c < (int)gridDim.x ? __ldcg(a.cta_counts + c) : 0;
    before += __reduce_add_sync(FULL, c < (int)blockIdx.x ? x : 0);
    nseg += __reduce_add_sync(FULL, x);
  }
  before += __reduce_add_sync(FULL, lane < warp ? s_cnt[lane] : 0);
  {
    // the sums rows past the last segment are 0
    const long long z1 = (long long)a.Smax * L;
    for (long long w = (long long)nseg * L + (long long)blockIdx.x * TT +
                       threadIdx.x;
         w < z1; w += (long long)gridDim.x * TT)
      a.sums[w] = 0ull;
    if (blockIdx.x == 0 && threadIdx.x == 0)
      a.num_groups[0] = nseg - (skey[R - 1] >= a.radix ? 1 : 0);
  }
  unsigned long long* sP = s_lanes + (size_t)warp * 3 * L;
  unsigned long long* sPst = sP + L;
  unsigned long long* sHead = sP + 2 * L;
  for (int l = lane; l < L; l += 32) sP[l] = sPst[l] = sHead[l] = 0ull;
  __syncwarp();
  // the head: the range's first row continues a segment of earlier ranges
  const bool head_open = lo < hi && lo > 0 && skey[lo] == prev0;
  const int head_g = head_open ? before - 1 : -1;
  int head_end = -1;
  bool head_live = false;
  bool stepped = false;  // a step began inside a segment of this range
  int run = before, prev = prev0;
  const int pa = a.prune_agg;
  // The pipeline: a step's keys and p are loaded two steps ahead, the
  // gathers of its live rows (the first aggregation's value and validity,
  // the weight's) one step ahead, each kept as loaded until the step uses
  // it, so a step waits on no load it started.
  const long long* __restrict__ vals0 =
      a.naggs ? desc_at<HEAD>(a.desc, a.agg_vals, 0) : nullptr;
  const unsigned char* __restrict__ valid0 =
      a.naggs ? desc_at<HEAD>(a.desc, a.agg_valid, 0) : nullptr;
  struct Gathered {
    long long v[RL], w[RL];
    unsigned char vb[RL], wb[RL];
  };
  // a step's rows below hi whose key is live
  auto live_of = [&](const int (&k)[RL], int i0) {
    unsigned m = 0u;
#pragma unroll
    for (int j = 0; j < RL; ++j)
      if (i0 + j < hi && k[j] < a.radix) m |= 1u << j;
    return m;
  };
  auto fetch = [&](const int (&k)[RL], const int (&r)[RL], int i0,
                   Gathered& g) {
    const unsigned lv = live_of(k, i0);
#pragma unroll
    for (int j = 0; j < RL; ++j) {
      g.v[j] = 0ll, g.vb[j] = 0, g.w[j] = 0ll, g.wb[j] = 0;
      if ((lv >> j) & 1u) {
        if (vals0) g.v[j] = vals0[r[j]], g.vb[j] = valid0[r[j]];
        if (HAS_W) g.w[j] = a.w_vals[r[j]], g.wb[j] = a.w_valid[r[j]];
      }
    }
  };
  int k[RL] = {}, k1[RL] = {}, r[RL] = {}, r1[RL] = {};
  Gathered gat;
  if (lo < hi) {
    load_rows<true>(skey, lo + RL * lane, R, k);
    load_p(a.p, lo + RL * lane, R, r);
    if (lo + STEP < hi) {
      load_rows<true>(skey, lo + STEP + RL * lane, R, k1);
      load_p(a.p, lo + STEP + RL * lane, R, r1);
    }
    fetch(k, r, lo + RL * lane, gat);
  }
  for (int s = lo; s < hi; s += STEP) {
    const int i0 = s + RL * lane;
    const bool more = s + STEP < hi;
    int k2[RL] = {}, r2[RL] = {};
    if (s + 2 * STEP < hi) {
      load_rows<true>(skey, i0 + 2 * STEP, R, k2);
      load_p(a.p, i0 + 2 * STEP, R, r2);
    }
    Gathered gat1;
    if (more) fetch(k1, r1, i0 + STEP, gat1);
    int nxt = __shfl_down_sync(FULL, k[0], 1);
    const int first = __shfl_sync(FULL, k1[0], 0);  // the next step's
    if (lane == 31) nxt = more ? first : i0 + RL < R ? skey[i0 + RL] : 0;
    const unsigned bm = starts(k, i0, hi, prev, lane);
    const unsigned live = live_of(k, i0);
    unsigned em = 0u;
#pragma unroll
    for (int j = 0; j < RL; ++j) {
      const int i = i0 + j;
      if (i < hi && (i == R - 1 || (j < RL - 1 ? k[j + 1] : nxt) != k[j]))
        em |= 1u << j;
    }
    prev = __shfl_sync(FULL, k[RL - 1], 31);
    // gids: the range's starts so far, a warp scan of the lanes' starts
    int inc = __popc(bm);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, inc, d);
      if (lane >= d) inc += y;
    }
    const int g0 = run + inc - __popc(bm);
    {
      int g[RL];
#pragma unroll
      for (int j = 0; j < RL; ++j)
        g[j] = g0 + __popc(bm & ((2u << j) - 1u)) - 1;
      store_rows(a.gid, i0, hi, g);
    }
    if (s > lo && !(__shfl_sync(FULL, bm, 0) & 1u)) stepped = true;
    run += __shfl_sync(FULL, inc, 31);
    {
      // the head's last row, if it is in this step
      bool mine = false;
      int hj = 0;
#pragma unroll
      for (int j = 0; j < RL; ++j)
        if (((em >> j) & 1u) && g0 + __popc(bm & ((2u << j) - 1u)) - 1 ==
                                    head_g)
          mine = true, hj = j;
      const unsigned hb = __ballot_sync(FULL, mine);
      if (hb) {
        const int hl = __ffs(hb) - 1;
        head_end = __shfl_sync(FULL, i0 + hj, hl);
        head_live = __shfl_sync(FULL, (live >> hj) & 1u, hl);
      }
    }
    // the rows that end a live segment other than the head: their score
    unsigned scored = em & live;
#pragma unroll
    for (int j = 0; j < RL; ++j)
      if (g0 + __popc(bm & ((2u << j) - 1u)) - 1 == head_g)
        scored &= ~(1u << j);
    unsigned long long w[RL];
#pragma unroll
    for (int j = 0; j < RL; ++j)
      w[j] = !((live >> j) & 1u)        ? 0ull
             : HAS_W && gat.wb[j]       ? (unsigned long long)gat.w[j]
                                        : 1ull;
    long long v[RL];
    unsigned ok = 0u;
    // the first aggregation's values from the pipeline, the others'
    // gathered here
    auto gather = [&](int ai) {
      ok = 0u;
      if (ai == 0) {
#pragma unroll
        for (int j = 0; j < RL; ++j) {
          v[j] = gat.v[j];
          if (gat.vb[j]) ok |= 1u << j;  // 0 at a row that is not live
        }
        return;
      }
      const long long* __restrict__ vals =
          desc_at<HEAD>(a.desc, a.agg_vals, ai);
      const unsigned char* __restrict__ valid =
          desc_at<HEAD>(a.desc, a.agg_valid, ai);
#pragma unroll
      for (int j = 0; j < RL; ++j) {
        const bool lv = (live >> j) & 1u;
        v[j] = lv ? vals[r[j]] : 0ll;
        if (lv && valid[r[j]]) ok |= 1u << j;
      }
    };
    if (a.naggs > 0) gather(0);
    // The scans (slots of the shared state), an aggregation's together:
    // for aggregation ai, scan 0 the counts [exists, keep (no weight
    // column), matched (ai = 0)] in fields (slot 3ai), 1 kw*(v-bias)
    // (3ai + 2), 2 kw (3ai + 1, with a weight column); with the first,
    // scan 3 the weight (3A + 1).  Without an aggregation, the matched
    // count and the weight alone.  Lane 0 (w) is the matched count
    // without a weight column.
    const bool agg = a.naggs > 0;
    for (int ai = 0; ai < (agg ? a.naggs : 1); ++ai) {
      if (ai > 0) gather(ai);
      unsigned keep = 0u;
      unsigned long long bias = 0ull;
      if (agg) {
        const long long dmax = desc_at<HEAD>(a.desc, a.agg_dmax, ai);
        const long long dmin = desc_at<HEAD>(a.desc, a.agg_dmin, ai);
        bias = (unsigned long long)desc_at<HEAD>(a.desc, a.agg_bias, ai);
#pragma unroll
        for (int j = 0; j < RL; ++j) {
          if (!((ok >> j) & 1u)) v[j] = 0ll;
          if (((ok >> j) & 1u) && !(v[j] > dmax || v[j] < dmin))
            keep |= 1u << j;
        }
      }
      unsigned long long x[4][RL], seg[4][RL];
#pragma unroll
      for (int j = 0; j < RL; ++j) {
        const bool kp = (keep >> j) & 1u;
        x[0][j] = (unsigned long long)((ok >> j) & 1u) |
                  (HAS_W ? 0ull : (unsigned long long)kp << FB) |
                  (ai == 0 ? (unsigned long long)((live >> j) & 1u) << (2 * FB)
                           : 0ull);
        x[1][j] = kp ? w[j] * ((unsigned long long)v[j] - bias) : 0ull;
        x[2][j] = kp ? w[j] : 0ull;
        x[3][j] = w[j];
      }
      const int sl[4] = {3 * ai, 3 * ai + 2, 3 * ai + 1, 3 * a.naggs + 1};
      if (!HAS_W) {
        if (agg)
          scan_steps<0x3u>(x, bm, lane, sP, sPst, sl, seg);
        else
          scan_steps<0x1u>(x, bm, lane, sP, sPst, sl, seg);
      } else if (!agg) {
        scan_steps<0x9u>(x, bm, lane, sP, sPst, sl, seg);
      } else if (ai == 0) {
        scan_steps<0xfu>(x, bm, lane, sP, sPst, sl, seg);
      } else {
        scan_steps<0x7u>(x, bm, lane, sP, sPst, sl, seg);
      }
      // the lanes at the rows that end a segment: the segment's sums row,
      // or for the head (gid head_g) its partial in shared memory
      const int l = 2 + 3 * ai;
#pragma unroll
      for (int j = 0; j < RL; ++j)
        if ((em >> j) & 1u) {
          const int g = g0 + __popc(bm & ((2u << j) - 1u)) - 1;
          unsigned long long* out =
              g == head_g ? sHead : a.sums + (size_t)g * L;
          const unsigned long long c = seg[0][j];
          if (agg) {
            out[l] = c & FM;
            out[l + 1] = HAS_W ? seg[2][j] : (c >> FB) & FM;
            out[l + 2] = seg[1][j];
          }
          if (ai == 0) {
            out[1] = c >> (2 * FB);
            out[0] = HAS_W ? seg[3][j] : c >> (2 * FB);
          }
        }
      if (!F32 && ai == 0) {
        // $COUNT: lane 0's sum at a live segment's last row, else -1
        long long sc[RL];
#pragma unroll
        for (int j = 0; j < RL; ++j)
          sc[j] = !((scored >> j) & 1u) ? -1ll
                  : HAS_W               ? (long long)seg[3][j]
                                        : (long long)(seg[0][j] >> (2 * FB));
        store_rows(static_cast<long long*>(a.score), i0, hi, sc);
      }
      if (F32 && ai == pa) {
        // the mean at a live segment's last row: f32(wv) / f32(acnt)
        float sc[RL];
#pragma unroll
        for (int j = 0; j < RL; ++j) {
          const long long ac =
              (long long)(HAS_W ? seg[2][j] : (seg[0][j] >> FB) & FM);
          sc[j] = (scored >> j) & 1u && ac > 0
                      ? __fdiv_rn(__ll2float_rn((long long)seg[1][j]),
                                  __ll2float_rn(ac > 1 ? ac : 1ll))
                      : -CUDART_INF_F;
        }
        store_rows(static_cast<float*>(a.score), i0, hi, sc);
      }
    }
#pragma unroll
    for (int j = 0; j < RL; ++j)
      k[j] = k1[j], k1[j] = k2[j], r[j] = r1[j], r1[j] = r2[j];
    gat = gat1;
  }
  // the range's tail: its sums past its last start (all of them without),
  // lane by lane from the slots
  if (gw < a.nranges) {
    unsigned long long* tail = a.tails + (size_t)gw * L;
    for (int ai = lane; ai < max(a.naggs, 1); ai += 32) {
      const unsigned long long c = sP[3 * ai] - sPst[3 * ai];
      if (a.naggs) {
        tail[2 + 3 * ai] = c & FM;
        tail[3 + 3 * ai] =
            HAS_W ? sP[3 * ai + 1] - sPst[3 * ai + 1] : (c >> FB) & FM;
        tail[4 + 3 * ai] = sP[3 * ai + 2] - sPst[3 * ai + 2];
      }
      if (ai == 0) {
        const int sl = 3 * a.naggs + 1;
        tail[1] = c >> (2 * FB);
        tail[0] = HAS_W ? sP[sl] - sPst[sl] : c >> (2 * FB);
      }
    }
  }
  if (a.paths && lane == 0) {
    if (head_open) atomicAdd(a.paths + P_CUT, 1ull);
    if (stepped) atomicAdd(a.paths + P_STEP, 1ull);
    if (hi > lo && hi < R && skey[hi] != skey[hi - 1])
      atomicAdd(a.paths + P_LAST, 1ull);
  }
  __syncthreads();
  {
    // the CTA's tail: its ranges' tails from its last range with a start
    // on (all of them without), and that range
    const unsigned any = __ballot_sync(FULL, lane < NW && s_cnt[lane] > 0);
    const int wl = any ? 31 - __clz(any) : -1;
    const int gw0 = blockIdx.x * NW;
    for (int l = threadIdx.x; l < L; l += TT) {
      unsigned long long t = 0ull;
      for (int w = max(wl, 0); w < NW && gw0 + w < a.nranges; ++w)
        t += a.tails[(size_t)(gw0 + w) * L + l];
      a.cta_tails[(size_t)blockIdx.x * L + l] = t;
    }
    if (threadIdx.x == 0) a.cta_last[blockIdx.x] = wl;
  }
  grid.sync();

  // ---- phase 3: the heads that end in their range -------------------------
  if (head_end < 0) return;  // warp-uniform
  // the segment starts in the nearest earlier range with a start: in this
  // CTA (w0), or in the nearest earlier CTA with one (cs); its sums there
  // and in every range between are their tails (a CTA's tail for each
  // whole CTA between)
  const unsigned here = __ballot_sync(FULL, lane < warp && s_cnt[lane] > 0);
  const int w0 = here ? 31 - __clz(here) : 0;
  int cs = blockIdx.x, k0 = blockIdx.x * NW + w0;
  if (!here) {
    for (int top = blockIdx.x - 1;; top -= 32) {
      const int c = top - lane;
      const int n = c >= 0 ? __ldcg(a.cta_counts + c) : 1;
      const unsigned m = __ballot_sync(FULL, n > 0);
      if (m) {
        cs = top - (__ffs(m) - 1);
        break;
      }
    }
    k0 = cs * NW + __ldcg(a.cta_last + cs);
  }
  unsigned long long cnt = 0ull, acnt = 0ull, wv = 0ull;
  for (int l = 0; l < L; ++l) {
    unsigned long long t = 0ull;
    // this CTA's ranges before this one, from w0 on
    if (lane >= w0 && lane < warp)
      t = __ldcg(a.tails + (size_t)(blockIdx.x * NW + lane) * L + l);
    for (int c = cs + lane; c < (int)blockIdx.x; c += 32)
      t += __ldcg(a.cta_tails + (size_t)c * L + l);
    t = warp_sum(t) + sHead[l];
    if (lane == 0) a.sums[(size_t)head_g * L + l] = t;
    if (l == 0) cnt = t;
    if (pa >= 0 && l == 3 + 3 * pa) acnt = t;
    if (pa >= 0 && l == 4 + 3 * pa) wv = t;
  }
  if (lane == 0) {
    if (F32) {
      const long long ac = (long long)acnt;
      static_cast<float*>(a.score)[head_end] =
          head_live && ac > 0
              ? __fdiv_rn(__ll2float_rn((long long)wv),
                          __ll2float_rn(ac > 1 ? ac : 1ll))
              : -CUDART_INF_F;
    } else {
      static_cast<long long*>(a.score)[head_end] =
          head_live ? (long long)cnt : -1ll;
    }
    if (a.paths && gw - k0 > 1) atomicAdd(a.paths + P_MULTI, 1ull);
    if (a.paths && gw - k0 > 32) atomicAdd(a.paths + P_DEEP, 1ull);
  }
}

template <bool HEAD, bool F32, bool HAS_W>
cudaError_t launch(const EnumSegmentsArgs& a, int grid, cudaStream_t s) {
  // set once an instance: its shared memory past 48 KB, and the CTAs that
  // can be resident at once (a cooperative launch needs its whole grid)
  static int max_ctas = 0;
  static size_t max_shm = 0;
  const size_t shm = (size_t)NW * 3 * a.L * sizeof(unsigned long long);
  void* kernel = (void*)segments_kernel<HEAD, F32, HAS_W>;
  cudaError_t err;
  if (shm > max_shm) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
    if (err != cudaSuccess) return err;
    int per = 0, dev = 0, sms = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per, kernel, TT, shm)) != cudaSuccess ||
        (err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return err;
    max_ctas = per * sms;
    max_shm = shm;
  }
  if (grid > max_ctas) return cudaErrorCooperativeLaunchTooLarge;
  EnumSegmentsArgs copy = a;
  void* params[] = {&copy};
  return cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(TT), params,
                                     shm, s);
}

}  // namespace

// Copies the descriptor block when it is longer than its head, then runs
// the one cooperative launch of `grid` CTAs (ceil(nranges / 32), at most
// the CTAs that can be resident) on `stream`.  Returns cudaError_t.
extern "C" int enum_segments(const EnumSegmentsArgs* args, int grid,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const EnumSegmentsArgs& a = *args;
  if (a.R < 1 || a.R >= (1ll << 31) - STEP || a.span < 4 || a.span % 4 ||
      a.span > (long long)FM ||
      a.nranges != (int)((a.R + a.span - 1) / a.span) ||
      grid != (a.nranges + NW - 1) / NW || a.L != 2 + 3 * a.naggs ||
      a.Smax < 1 || a.prune_agg >= a.naggs || !a.tails || !a.cta_tails ||
      !a.counts || !a.cta_counts || !a.cta_last ||
      ((uintptr_t)a.skey | (uintptr_t)a.p | (uintptr_t)a.gid |
       (uintptr_t)a.score) % 16)
    return cudaErrorInvalidValue;
  cudaError_t err = desc_upload(a.desc, s);
  if (err != cudaSuccess) return err;
  // the template flags: the descriptor in the parameters, the f32 score,
  // a weight column
  static cudaError_t (*const launches[8])(const EnumSegmentsArgs&, int,
                                         cudaStream_t) = {
      launch<false, false, false>, launch<false, false, true>,
      launch<false, true, false>,  launch<false, true, true>,
      launch<true, false, false>,  launch<true, false, true>,
      launch<true, true, false>,   launch<true, true, true>};
  return launches[(a.desc.dev == nullptr) * 4 + (a.prune_agg >= 0) * 2 +
                  (a.has_weight != 0)](a, grid, s);
}
