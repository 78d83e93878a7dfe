// K12 topk_rows: the indices of the k largest of R scores, exactly as
// jax.lax.top_k(score, k)[1] gives them: by value descending, ties to the
// lower index.  int32, int64 and f32 scores.
//
// Replaces sybil_tpu/ops/scan.py:_topk_rows 1369-1399 (a tiled two-phase
// top_k whose exactness fallback makes it equal the full lax.top_k) and
// the lax.top_k of the sorted strategy's device prune in pack_outputs
// (1896-1898).
//
// Each score maps to an order-preserving unsigned key: int32 and int64
// flip the sign bit; f32 flips the sign bit of a non-negative value and
// every bit of a negative one (-inf is the smallest finite-or-infinite
// key; the scores here hold no NaN).  Row i's composite is the key and
// then ~i in 32 bits (96 bits for int64, 64 for 32-bit scores): the k
// largest composites are the k winners, and no two composites tie, so
// the pick among equal scores is by index by construction, wherever the
// candidates lie in memory.
//
// Bound: memory.  At config 5 (4,194,304 int64 scores, k 1,000) the
// scores read twice are 67 MB, 0.020 ms at 3.35 TB/s; at the device
// prune's 100,000 scores the bytes are nothing and the time is launches
// and grid-wide barriers.
//
// What the former design cost (PERF.md §6): 21 dependent device
// operations a call for int64 (a memset, init_state, 8 x a histogram
// kernel and a one-CTA select kernel, a tile count, a one-CTA scan, a
// ranked write, a one-CTA bitonic sort of 55 stages, the prune's gather):
// every histogram pass read all R scores, though at config 5 passes 2-6
// each picked digit 0 for every live key (K11's counts are small), and at
// the prune the launch chain was the time.
//
// Design: one cooperative launch, its CTAs co-resident, grid-wide
// barriers between the phases (cooperative_groups grid sync); no memset:
// the kernel zeroes its own scratch first.  What one CTA reads of what
// others wrote (the counts, the buffers, the winners) it loads past L1
// (__ldcg).  Radix select over the
// composites, DB = 11 bits a digit from the top, each round two passes
// over the round's source (the scores, matched to the prefix chosen so
// far, or a candidate buffer):
//   H  each CTA counts the digit of the matching elements in a shared
//      histogram (a warp whose 32 elements share a bin adds once), flushed
//      to a global one; after the barrier every CTA picks the same bucket
//      b holding the k_rem-th composite from the global counts;
//   F  elements above b join the winners (a global list, at most k);
//      those in b are the next round's candidates: their AND and OR are
//      reduced (so that the next round starts at their highest differing
//      bit: at config 5 the 33 bits above a count's top bit, common to
//      every count, cost no round), and, while there are at most `cap`
//      of them, they are written to a candidate buffer (a block scan, one
//      atomic a CTA a step), which the later rounds read instead of the
//      scores (it stays in L2); above cap the next round reads the scores
//      again.  When bucket b holds exactly the k_rem still wanted, F
//      takes all of it and the select ends.
// The rounds ping-pong two histograms, two AND/OR words and two buffers,
// each zeroed during the pass before its use, so a round costs two
// barriers.  A thread takes 4 scores a step of a pass over the scores,
// their loads issued together, and tests the prefix and cuts the digit
// with 64- and 32-bit masks (Round's km, kv, im, iv).  Then the winners
// are ordered by rank: a CTA loads the k winners into shared memory and a
// warp ranks one by counting the winners before it (larger key, or equal
// key and lower index), writes out[rank] and, at the device prune,
// gathers its table row.
//
// The device prune (sybil_tpu/ops/scan.py:pack_outputs 1896-1900) takes
// the table's winning rows right after the select: given the keyed table
// [S, Wt], main [rows, W] and ptable [k, Wt], the ranking warp also
// writes table[out[j]] as main's row 1 + j (zero-padded to W) and as
// ptable's row j, so the prune costs one host call and one launch.
//
// The two-valued form (topk_two_valued) ranks 0/1 int32 flags, the mesh
// scan's compaction (sybil_tpu/parallel/mesh.py:_sharded_scan 291,
// lax.top_k(flive.astype(int32), k)): the indices of the rows with flag 1
// in ascending order, then those with flag 0 in ascending order, the
// first k (lax.top_k's order for two values; any non-zero flag counts as
// 1, and the caller passes only 0 and 1).  No select, no state words, no
// memset: each thread holds 16 consecutive flags as bits, a block scan of
// their counts ranks the ones, and a row's place is its rank among the
// ones, or the ones' total plus its rank among the zeros (its index less
// the ones before it).  R <= TV_TILE rows are one CTA and one launch;
// more are two: tv_count writes each tile's ones to an int32 scratch,
// and tv_write's CTAs each sum the earlier tiles' and all tiles' counts
// before ranking their own tile.  Bound: memory, the R flags read once
// and k indices written; at the mesh's sizes (1,024 to 525,312 flags)
// it is launch latency, which one or two launches keep small.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int KMAX = 4096;
constexpr unsigned FULL = 0xffffffffu;

constexpr int TV_THREADS = 1024;
constexpr int TV_PER = 16;                       // flags a thread
constexpr int TV_TILE = TV_THREADS * TV_PER;     // rows a CTA

constexpr int GT = 512;                          // threads a CTA
constexpr int GWARPS = GT / 32;
constexpr int DB = 11;                           // bits a digit
constexpr int NB = 1 << DB;                      // histogram bins
constexpr int SMEM = KMAX * 12;                  // the winners, ranked

using u64 = unsigned long long;
using u128 = unsigned __int128;

// The select's scratch, laid out by scratch_of in one int64 allocation
// of NB + 10 + k + ceil(k / 2) + 3 cap words (ops/scan.py _topk_launch).
struct Scratch {
  unsigned* hist;   // [2, NB]
  unsigned* ctr;    // [4]: winners, buffer 0 fill, buffer 1 fill
  u64* andor;       // [2, 4]: key AND, key OR, ~index AND, ~index OR
  u64* wkey;        // [k] the winners' keys and indices, unordered
  int* widx;        // [k]
  u64* bkey;        // [2, cap] candidate buffers
  int* bidx;        // [2, cap]
};

struct TopkArgs {
  const void* score;
  int* out;                    // [k] indices
  long long* scratch;
  const long long* table;      // the device prune's gather, or null:
  long long* main;             // table [S, Wt], main [rows, W],
  long long* ptable;           // ptable [k, Wt]
  long long R;
  int k;
  int dtype;                   // 0 int32, 1 int64, 2 f32
  int cap;                     // candidates a buffer holds
  int Wt;
  int W;
};

__device__ __forceinline__ Scratch scratch_of(const TopkArgs& a) {
  Scratch s;
  long long* w = a.scratch;
  s.hist = reinterpret_cast<unsigned*>(w);
  w += NB;
  s.ctr = reinterpret_cast<unsigned*>(w);
  w += 2;
  s.andor = reinterpret_cast<u64*>(w);
  w += 8;
  s.wkey = reinterpret_cast<u64*>(w);
  w += a.k;
  s.widx = reinterpret_cast<int*>(w);
  w += (a.k + 1) / 2;
  s.bkey = reinterpret_cast<u64*>(w);
  w += 2ll * a.cap;
  s.bidx = reinterpret_cast<int*>(w);
  return s;
}

__device__ __forceinline__ u64 okey(const void* score, int dtype,
                                    long long i) {
  if (dtype == 0)
    return (unsigned)static_cast<const int*>(score)[i] ^ 0x80000000u;
  if (dtype == 1)
    return (u64)static_cast<const long long*>(score)[i] ^
           0x8000000000000000ull;
  const unsigned b = static_cast<const unsigned*>(score)[i];
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Whether (ka, ia) ranks before (kb, ib): the larger key, or the lower
// index of equal keys.
__device__ __forceinline__ bool before(u64 ka, int ia, u64 kb, int ib) {
  return ka > kb || (ka == kb && ia < ib);
}

// A round's select state, the same in every CTA (shared memory).
struct Round {
  u128 pre;     // the composite bits >= shift chosen so far
  u64 km, kv;   // the prefix as masks: a composite matches it when
  unsigned im, iv;   // key & km == kv and ~index & im == iv
  int shift;
  int lo;       // the digit is bits [lo, shift)
  int src;      // -1: the scores; 0 or 1: that candidate buffer
  long long n;  // the source's elements
  int k_rem;    // winners still wanted from the prefix's elements
  int b;        // the chosen bucket, its count, whether it ends it
  int cnt;
  int done;
};

__device__ __forceinline__ void set_masks(Round& r) {
  const u128 hi = ~(((u128)1 << r.shift) - 1);
  const u128 val = r.pre << r.shift;
  r.km = (u64)(hi >> 32);
  r.kv = (u64)(val >> 32);
  r.im = (unsigned)hi;
  r.iv = (unsigned)val;
}

__device__ __forceinline__ bool matches(const Round& r, u64 key,
                                        unsigned nidx) {
  return (key & r.km) == r.kv && (nidx & r.im) == r.iv;
}

// Bits [lo, lo + 11) of the composite, masked.
__device__ __forceinline__ unsigned digit_of(u64 key, unsigned nidx, int lo,
                                             unsigned mask) {
  return (lo >= 32 ? (unsigned)(key >> (lo - 32))
                   : (unsigned)((key << (32 - lo)) | (nidx >> lo))) & mask;
}

// Element e of the source (clamped to the last one: the loads of a step
// are issued together, before any is tested).
__device__ __forceinline__ void load(const TopkArgs& a, const Scratch& s,
                                     int src, long long e, long long n,
                                     u64& key, int& idx) {
  e = e < n ? e : n - 1;
  if (src < 0) {
    key = okey(a.score, a.dtype, e);
    idx = (int)e;
  } else {
    key = __ldcg(s.bkey + (size_t)src * a.cap + e);
    idx = __ldcg(s.bidx + (size_t)src * a.cap + e);
  }
}

// H: the digit's counts over the source's matching elements, U elements
// a thread a step (their loads in flight together).
template <int U>
__device__ void hist_pass(const TopkArgs& a, const Scratch& s,
                          const Round& r, unsigned* s_hist,
                          unsigned* ghist) {
  for (int i = threadIdx.x; i < NB; i += GT) s_hist[i] = 0u;
  __syncthreads();
  const unsigned mask = (1u << (r.shift - r.lo)) - 1u;
  const int lane = threadIdx.x & 31;
  for (long long base = (long long)blockIdx.x * GT * U; base < r.n;
       base += (long long)gridDim.x * GT * U) {
    u64 key[U];
    int idx[U];
#pragma unroll
    for (int m = 0; m < U; ++m)
      load(a, s, r.src, base + m * GT + threadIdx.x, r.n, key[m], idx[m]);
#pragma unroll
    for (int m = 0; m < U; ++m) {
      unsigned v = FULL;
      const unsigned ni = FULL - (unsigned)idx[m];
      if (base + m * GT + threadIdx.x < r.n && matches(r, key[m], ni))
        v = digit_of(key[m], ni, r.lo, mask);
      // a warp whose elements share one bin adds once
      const unsigned v0 = __shfl_sync(FULL, v, 0);
      if (__all_sync(FULL, v == v0)) {
        if (lane == 0 && v0 != FULL) atomicAdd(&s_hist[v0], 32u);
      } else if (v != FULL) {
        atomicAdd(&s_hist[v], 1u);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < NB; i += GT)
    if (s_hist[i]) atomicAdd(&ghist[i], s_hist[i]);
}

// The bucket holding the k_rem-th matching composite, from the top.
__device__ void choose(const unsigned* ghist, Round& r) {
  constexpr int PB = NB / GT;
  const int kr = r.k_rem;
  unsigned c[PB];
  int sum = 0;
#pragma unroll
  for (int j = 0; j < PB; ++j) {
    c[j] = __ldcg(ghist + NB - 1 - (threadIdx.x * PB + j));
    sum += (int)c[j];
  }
  int total;
  const int above = block_scan<GT>(sum, &total);
  if (above < kr && kr <= above + sum) {
    int acc = above;
#pragma unroll
    for (int j = 0; j < PB; ++j) {
      if (acc + (int)c[j] >= kr) {
        r.b = NB - 1 - (threadIdx.x * PB + j);
        r.k_rem = kr - acc;
        r.cnt = (int)c[j];
        r.done = r.cnt == r.k_rem;
        break;
      }
      acc += (int)c[j];
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void append_winner(const Scratch& s, u64 key,
                                              int idx) {
  const unsigned w = atomicAdd(&s.ctr[0], 1u);
  s.wkey[w] = key;
  s.widx[w] = idx;
}

// F: the source's matching elements above bucket b (all of b's when the
// select ends there) join the winners; b's are the next candidates,
// written to buffer dst when dst >= 0, their AND and OR into ao.  U
// elements a thread a step, loaded together.
template <int U>
__device__ void filter_pass(const TopkArgs& a, const Scratch& s,
                            const Round& r, int dst, u64* ao) {
  __shared__ int s_base;
  __shared__ u64 s_red[GWARPS][3];
  const unsigned mask = (1u << (r.shift - r.lo)) - 1u;
  const unsigned b = (unsigned)r.b;
  u64 kand = ~0ull, kor = 0ull;
  unsigned iand = FULL, ior = 0u;
  bool any = false;
  for (long long base = (long long)blockIdx.x * GT * U; base < r.n;
       base += (long long)gridDim.x * GT * U) {
    u64 key[U];
    int idx[U];
#pragma unroll
    for (int m = 0; m < U; ++m)
      load(a, s, r.src, base + m * GT + threadIdx.x, r.n, key[m], idx[m]);
    unsigned cand = 0u;
#pragma unroll
    for (int m = 0; m < U; ++m) {
      const unsigned ni = FULL - (unsigned)idx[m];
      if (base + m * GT + threadIdx.x >= r.n || !matches(r, key[m], ni))
        continue;
      const unsigned d = digit_of(key[m], ni, r.lo, mask);
      if (d > b || (r.done && d == b)) {
        append_winner(s, key[m], idx[m]);
      } else if (d == b) {
        cand |= 1u << m;
        kand &= key[m];
        kor |= key[m];
        iand &= FULL - (unsigned)idx[m];
        ior |= FULL - (unsigned)idx[m];
        any = true;
      }
    }
    if (dst < 0) continue;
    // the step's candidates: one block scan of the threads' counts, one
    // atomic a CTA, each thread's candidates on consecutive words
    int total;
    int pos = block_scan<GT>(__popc(cand), &total);
    if (total == 0) continue;
    if (threadIdx.x == 0)
      s_base = (int)atomicAdd(&s.ctr[1 + dst], (unsigned)total);
    __syncthreads();
    pos += s_base;
#pragma unroll
    for (int m = 0; m < U; ++m) {
      if (!((cand >> m) & 1u)) continue;
      s.bkey[(size_t)dst * a.cap + pos] = key[m];
      s.bidx[(size_t)dst * a.cap + pos] = idx[m];
      ++pos;
    }
    __syncthreads();
  }
  // the candidates' AND and OR: a warp's by shuffles, then the CTA's
  const unsigned kal = __reduce_and_sync(FULL, (unsigned)kand);
  const unsigned kah = __reduce_and_sync(FULL, (unsigned)(kand >> 32));
  const unsigned kol = __reduce_or_sync(FULL, (unsigned)kor);
  const unsigned koh = __reduce_or_sync(FULL, (unsigned)(kor >> 32));
  iand = __reduce_and_sync(FULL, iand);
  ior = __reduce_or_sync(FULL, ior);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    s_red[warp][0] = ((u64)kah << 32) | kal;
    s_red[warp][1] = ((u64)koh << 32) | kol;
    s_red[warp][2] = ((u64)iand << 32) | ior;
  }
  const int anyc = __syncthreads_or(any);
  if (threadIdx.x == 0 && anyc) {
    u64 ka = ~0ull, ko = 0ull;
    unsigned ia = FULL, io = 0u;
    for (int w = 0; w < GWARPS; ++w) {
      ka &= s_red[w][0];
      ko |= s_red[w][1];
      ia &= (unsigned)(s_red[w][2] >> 32);
      io |= (unsigned)s_red[w][2];
    }
    atomicAnd(&ao[0], ka);
    atomicOr(&ao[1], ko);
    atomicAnd(&ao[2], (u64)ia);
    atomicOr(&ao[3], (u64)io);
  }
}

__device__ __forceinline__ int top_bit(u128 x) {
  const u64 hi = (u64)(x >> 64);
  return hi ? 127 - __clzll((long long)hi) : 63 - __clzll((long long)(u64)x);
}

// After F: the chosen digit joins the prefix; the bits below it that
// every candidate shares join it too (ao: their AND and OR).
__device__ void next_round(Round& r, int dst, const u64* ao) {
  r.pre = (r.pre << (r.shift - r.lo)) | (u128)(unsigned)r.b;
  r.shift = r.lo;
  const u128 cand_and =
      ((u128)__ldcg(ao) << 32) | (u128)(unsigned)__ldcg(ao + 2);
  const u128 cand_or =
      ((u128)__ldcg(ao + 1) << 32) | (u128)(unsigned)__ldcg(ao + 3);
  const u128 below = ((u128)1 << r.shift) - 1;
  const u128 diff = (cand_and ^ cand_or) & below;
  // two or more candidates differ somewhere below the prefix
  const int ns = top_bit(diff) + 1;
  r.pre = (r.pre << (r.shift - ns)) |
          ((cand_and >> ns) & (((u128)1 << (r.shift - ns)) - 1));
  r.shift = ns;
  r.lo = ns > DB ? ns - DB : 0;
  r.src = dst;
  r.n = dst < 0 ? r.n : r.cnt;
  set_masks(r);
}

__global__ void __launch_bounds__(GT, 2) select_kernel(const TopkArgs a) {
  extern __shared__ u64 s_dyn[];
  __shared__ Round r;
  const Scratch s = scratch_of(a);
  cg::grid_group grid = cg::this_grid();
  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i < 2 * NB; i += GT) s.hist[i] = 0u;
    if (threadIdx.x < 4) s.ctr[threadIdx.x] = 0u;
    if (threadIdx.x < 8) s.andor[threadIdx.x] = (threadIdx.x & 1) ? 0ull
                                                                  : ~0ull;
  }
  if (threadIdx.x == 0) {
    r.pre = 0;
    r.shift = (a.dtype == 1 ? 64 : 32) + 32;
    r.lo = r.shift - DB;
    r.src = -1;
    r.n = a.R;
    r.k_rem = a.k;
    set_masks(r);
  }
  grid.sync();
  for (int round = 0;; ++round) {
    unsigned* ghist = s.hist + (round & 1) * NB;
    if (r.src < 0)
      hist_pass<4>(a, s, r, reinterpret_cast<unsigned*>(s_dyn), ghist);
    else
      hist_pass<1>(a, s, r, reinterpret_cast<unsigned*>(s_dyn), ghist);
    grid.sync();
    choose(ghist, r);
    // the next round's histogram, AND/OR words and buffer count, zeroed
    // while no CTA reads or writes them
    const int nx = (round + 1) & 1;
    const int dst =
        r.done || r.cnt > a.cap ? -1 : (r.src < 0 ? 0 : 1 - r.src);
    if (blockIdx.x == gridDim.x - 1) {
      for (int i = threadIdx.x; i < NB; i += GT) s.hist[nx * NB + i] = 0u;
      if (threadIdx.x < 4)
        s.andor[nx * 4 + threadIdx.x] = (threadIdx.x & 1) ? 0ull : ~0ull;
      if (threadIdx.x == 0 && dst >= 0) s.ctr[1 + (1 - dst)] = 0u;
    }
    u64* ao = s.andor + (round & 1) * 4;
    if (r.src < 0)
      filter_pass<4>(a, s, r, dst, ao);
    else
      filter_pass<1>(a, s, r, dst, ao);
    grid.sync();
    if (r.done) break;
    __syncthreads();
    if (threadIdx.x == 0) next_round(r, dst, ao);
    __syncthreads();
  }

  // the k winners ordered: warp w of the grid ranks winners w, w + warps..
  const int warps = gridDim.x * GWARPS;
  const int first = blockIdx.x * GWARPS;
  if (first >= a.k) return;
  u64* s_key = s_dyn;
  int* s_idx = reinterpret_cast<int*>(s_dyn + a.k);
  for (int i = threadIdx.x; i < a.k; i += GT) {
    s_key[i] = __ldcg(s.wkey + i);
    s_idx[i] = __ldcg(s.widx + i);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int j = first + (threadIdx.x >> 5); j < a.k; j += warps) {
    const u64 kj = s_key[j];
    const int ij = s_idx[j];
    int n = 0;
    for (int m = lane; m < a.k; m += 32)
      n += before(s_key[m], s_idx[m], kj, ij);
    const int rank = __reduce_add_sync(FULL, n);
    if (lane == 0) a.out[rank] = ij;
    if (!a.table) continue;
    const long long* src = a.table + (size_t)ij * a.Wt;
    long long* dstm = a.main + (size_t)(1 + rank) * a.W;
    for (int c = lane; c < a.W; c += 32) {
      const long long v = c < a.Wt ? src[c] : 0;
      dstm[c] = v;
      if (c < a.Wt) a.ptable[(size_t)rank * a.Wt + c] = v;
    }
  }
}

// This thread's TV_PER consecutive flags of the tile at lo, as bits.
__device__ __forceinline__ unsigned tv_bits(const int* f, long long lo,
                                            long long R) {
  const long long base = lo + (long long)threadIdx.x * TV_PER;
  unsigned b = 0u;
#pragma unroll
  for (int j = 0; j < TV_PER; ++j)
    if (base + j < R && f[base + j] != 0) b |= 1u << j;
  return b;
}

__global__ void __launch_bounds__(TV_THREADS) tv_count(const int* f,
                                                       long long R,
                                                       int* counts) {
  int total;
  block_scan<TV_THREADS>(
      __popc(tv_bits(f, (long long)blockIdx.x * TV_TILE, R)), &total);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

template <bool TILED>
__global__ void __launch_bounds__(TV_THREADS) tv_write(const int* f,
                                                       long long R, int k,
                                                       const int* counts,
                                                       int ntiles, int* out) {
  const long long lo = (long long)blockIdx.x * TV_TILE;
  const unsigned b = tv_bits(f, lo, R);
  int tile_ones;
  const int pre = block_scan<TV_THREADS>(__popc(b), &tile_ones);
  long long before = 0, ones = tile_ones;
  if (TILED) {
    int e = 0, t = 0;
    for (int i = threadIdx.x; i < ntiles; i += TV_THREADS) {
      const int c = counts[i];
      t += c;
      if (i < (int)blockIdx.x) e += c;
    }
    int te, tt;
    block_scan<TV_THREADS>(e, &te);
    block_scan<TV_THREADS>(t, &tt);
    before = te;
    ones = tt;
  }
  long long o = before + pre;   // the ones before this thread's first row
  const long long base = lo + (long long)threadIdx.x * TV_PER;
  for (int j = 0; j < TV_PER && base + j < R; ++j) {
    const long long i = base + j;
    if ((b >> j) & 1u) {
      if (o < k) out[o] = (int)i;
      ++o;
    } else {
      const long long z = ones + (i - o);
      if (z < k) out[z] = (int)i;
    }
  }
}

}  // namespace

// The two-valued form on `stream`: one launch for R <= TV_TILE, else
// tv_count and tv_write over ntiles = ceil(R / TV_TILE) tiles with
// `counts` [ntiles] as scratch.  Returns cudaError_t.
extern "C" int topk_two_valued(const int* flags, int* out, int* counts,
                               long long R, int k, int ntiles, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R < 1 || R >= (1ll << 31) || k < 1 || k > R ||
      ntiles != (int)((R + TV_TILE - 1) / TV_TILE) || (ntiles > 1 && !counts))
    return cudaErrorInvalidValue;
  if (ntiles == 1) {
    tv_write<false><<<1, TV_THREADS, 0, s>>>(flags, R, k, nullptr, 1, out);
    return cudaGetLastError();
  }
  tv_count<<<ntiles, TV_THREADS, 0, s>>>(flags, R, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tv_write<true><<<ntiles, TV_THREADS, 0, s>>>(flags, R, k, counts, ntiles,
                                              out);
  return cudaGetLastError();
}

// The general form on `stream`: one cooperative launch of the select,
// the ranking and, with a table (the device prune), the gather of the
// winners into main's prefix rows and ptable.  scratch: an int64 buffer
// of NB + 10 + k + ceil(k / 2) + 3 cap words (no zeroing needed); cap in
// [1, R]: the candidates a buffer holds.  Returns cudaError_t.
extern "C" int topk_rows(const void* score, int* out, long long* scratch,
                         long long R, int k, int dtype, int cap,
                         const long long* table, long long* main,
                         long long* ptable, int Wt, int W, void* stream) {
  if (R < 1 || R >= (1ll << 31) || k < 1 || k > KMAX || k > R ||
      dtype < 0 || dtype > 2 || cap < 1 || cap > R || !scratch ||
      (table && (!main || !ptable || Wt < 1 || W < Wt)))
    return cudaErrorInvalidValue;
  // the CTAs that can be resident at once: a cooperative launch needs
  // every CTA of its grid resident
  static int max_ctas = 0;
  if (max_ctas == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    int per = 0, dev = 0, sms = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per, select_kernel, GT, SMEM)) != cudaSuccess ||
        (err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return err;
    if (per < 1) return cudaErrorInvalidConfiguration;
    max_ctas = per * sms;
  }
  // a CTA per 2,048 scores (a thread's four elements a step of the
  // first round), and enough warps to rank a winner each
  long long want = (R + 4 * GT - 1) / (4 * GT);
  if (want < (k + GWARPS - 1) / GWARPS) want = (k + GWARPS - 1) / GWARPS;
  const int grid = (int)(want < max_ctas ? want : max_ctas);
  TopkArgs a{score, out, scratch, table, main, ptable, R, k, dtype, cap,
             table ? Wt : 0, table ? W : 0};
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel(
      (void*)select_kernel, dim3(grid), dim3(GT), args,
      SMEM, static_cast<cudaStream_t>(stream));
}
