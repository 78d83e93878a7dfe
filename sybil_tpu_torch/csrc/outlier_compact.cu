// K5 outlier_compact: the outlier rows of one histogram aggregation in
// the packed download buffer.
//
// Replaces sybil_tpu/ops/scan.py:_mask_positions (the first kmax set
// rows of a mask, in row order, by cumsum + searchsorted) and the
// outlier section of pack_outputs: row j of the section is
// [key_0 .. key_{K-1}, value, live] padded with zeros to W words, for
// the j-th set row of the mask.  The keys are the reference's
// sorted_gkeys row: in a query-cache group scan (vg_span > 0) the
// cache-group key (r >> log2C) / vg_span first (cg_key, 405-411: the
// row's block position over the group span, no column read), then in a
// rollup the time key trunc_div(t, tb) * tb (Go's division, int32
// arithmetic under time_i32, from the time lane as it lies), then each
// group key (MISSING = -1 where the key column is missing); a scan with
// none has one zero key.  Under the sorted
// strategy the mask and values are in sorted order and a row's keys are
// its row of K8's kmat [R, K] (the reference's sorted_gkeys there); a
// multi-process dense mesh scan's outlier rows come compacted with their
// keys as kmat.  When fewer than kmax rows are set, the reference
// gathers row R-1 for each remaining entry (searchsorted returns R,
// clipped to R-1), so padding rows hold row R-1's keys and value with
// live = 0; this kernel writes the same words.
//
// Bound: memory, one read of the 1 B mask per row; the section itself
// is at most kmax * W words.
//
// What a trace of the former design showed (torch.profiler on the H100;
// PERF.md §6): three launches, 34-35 us of device work a call with no
// row set: a count of each 4,096-row tile (one byte a thread a load),
// a one-CTA scan of the counts, and a write pass whose CTAs ran a block
// scan every 256 rows whether or not a row was set (26.6 us).
//
// Design: one launch, no memset.  The grid's CTAs take an atomic ticket
// each: the TILE-row tiles in order, then NHELP padding helpers.  A tile
// reads its mask 16 bytes at a time (64 rows a thread, lookback.cuh's
// mask_bits) and publishes its set-row count in its status word; a tile
// with no set row is done.  A tile with set rows finds the rows set
// before it as the sum of its predecessors' counts (warp 0, 32 x LB words
// a round, every load of a round in flight at once; by the ticket every
// predecessor has started, and each publishes without waiting), stopping
// once the sum reaches kmax, when the tile writes nothing; the others
// rank their set rows with one block scan and write their rows word by
// word, so the stores of a row run are coalesced.  A helper sums every
// tile's count (the total) and writes its share of the padding rows
// [total, kmax) from a copy of row R-1 in shared memory.  No tile waits
// for another's inclusive prefix, as the chained look-back of K10's pair
// sections does: with no row set, only the helpers read the counts.  The
// ticket and the status words live in a scratch of the wrapper's, one per
// device and stream, that no call clears: the ticket counts on across
// calls (the wrapper passes the value its call's first ticket draws), and
// a status word holds the call's epoch (its number on the stream) above
// its count, so the words of earlier calls read as unpublished.

#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "desc.cuh"
#include "lookback.cuh"
#include "time_key.cuh"

namespace {

using lookback::FULL;
using lookback::ROWS_T;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = THREADS * ROWS_T;        // mask rows a CTA: 16,384
constexpr int NHELP = 8;                      // padding helpers
// status words a lane a round: 512 tiles (8,388,608 rows) a round
constexpr int LB = 16;
constexpr int PAD_WORDS = 512;                // padding row kept in smem
// the scratch words: the ticket, then a status word a tile
constexpr int S_TICKET = 0;
constexpr int S_STATUS = 1;
constexpr unsigned long long COUNT_BITS = 0xffffffffull;

}  // namespace

// Mirrored field for field by OutlierCompactArgs in ops/scan.py (ctypes).
// key_vals and key_valid point into the descriptor block (desc.cuh), of
// [nkeys] each.
struct OutlierCompactArgs {
  Desc desc;
  const unsigned char* mask;   // [R]
  const long long* vals;       // [R]
  const long long* const* key_vals;
  const unsigned char* const* key_valid;
  const long long* t_vals;     // time column (has_time)
  const long long* kmat;       // [R, kmat_K] sorted keys, or null
  long long* out;              // [kmax, W] rows of the download buffer
  unsigned long long* scratch; // [S_STATUS + ntiles], kept across calls
  long long R;
  long long tb;                // time bucket (> 0)
  long long base;              // the call's first ticket
  int kmax;
  int W;
  int nkeys;                   // group columns; none and no time = one zero key
  int ntiles;
  int has_time;                // the time key follows the cg key, if any
  int time_i32;
  int kmat_K;
  int log2C;                   // rows per block, log2
  int vg_span;                 // > 0: key 0 is the cache-group key
  unsigned epoch;              // the call's number on the stream, from 1
  int grid;                    // ntiles + NHELP CTAs
};

namespace {

// Word c of the section's row for mask row r, live 1 (a set row) or 0 (a
// padding row).
__device__ __forceinline__ long long row_word(const OutlierCompactArgs& a,
                                              long long r, int c,
                                              long long live) {
  const int cg = a.vg_span > 0;
  const int lead = cg + a.has_time;
  const int nk = a.nkeys + lead;
  const int K = a.kmat ? a.kmat_K : (nk > 0 ? nk : 1);
  if (c < K) {
    if (a.kmat) return a.kmat[r * K + c];
    if (nk == 0) return 0ll;
    // vg_span is a power of two
    if (c < cg) return r >> (a.log2C + __ffs(a.vg_span) - 1);
    if (c < lead) return time_key(a.t_vals[r], a.tb, a.time_i32);
    const int k = c - lead;
    return desc_at(a.desc, a.key_valid, k)[r]
               ? desc_at(a.desc, a.key_vals, k)[r] : -1ll;
  }
  if (c == K) return a.vals[r];
  return c == K + 1 ? live : 0ll;
}

// The counts that tiles [0, hi) published in this call (epoch), summed
// by a warp (every lane gets the sum), the nearest tile first, waiting for
// those not yet published; it stops once the sum reaches cap.
__device__ unsigned long long counts_before(const unsigned long long* st,
                                            int hi, long long cap,
                                            unsigned epoch) {
  const int lane = threadIdx.x & 31;
  const unsigned long long none = (unsigned long long)epoch << 32;
  unsigned long long sum = 0ull;
  for (int top = hi - 1; top >= 0 && (long long)sum < cap;
       top -= 32 * LB) {
    unsigned long long w[LB];
    bool unset = false;
#pragma unroll
    for (int k = 0; k < LB; ++k) {
      const int j = top - LB * lane - k;
      w[k] = j >= 0 ? lookback::ld_relaxed(st + j) : none;
      unset |= (w[k] >> 32) != epoch;
    }
    while (__any_sync(FULL, unset)) {
      unset = false;
#pragma unroll
      for (int k = 0; k < LB; ++k) {
        if ((w[k] >> 32) != epoch)
          w[k] = lookback::ld_relaxed(st + top - LB * lane - k);
        unset |= (w[k] >> 32) != epoch;
      }
    }
    unsigned long long c = 0ull;
#pragma unroll
    for (int k = 0; k < LB; ++k) c += w[k] & COUNT_BITS;
    for (int d = 16; d; d >>= 1) c += __shfl_xor_sync(FULL, c, d);
    sum += c;
  }
  return sum;
}

// A compaction CTA: tile `tile` of the mask.
__device__ void tile_part(const OutlierCompactArgs& a, int tile) {
  __shared__ int s_count[WARPS];
  __shared__ unsigned long long s_excl;
  __shared__ unsigned short s_rows[TILE];   // the tile's set rows, ranked
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long lo = (long long)tile * TILE;
  const unsigned long long bits =
      lookback::mask_bits(a.mask, lo + (long long)threadIdx.x * ROWS_T, a.R);
  const int mine = __popcll(bits);
  const int wsum = __reduce_add_sync(FULL, mine);
  if (lane == 0) s_count[warp] = wsum;
  __syncthreads();
  if (warp == 0) {
    unsigned long long* st = a.scratch + S_STATUS;
    int count = lane < WARPS ? s_count[lane] : 0;
    count = __reduce_add_sync(FULL, count);
    if (lane == 0)
      lookback::st_release(st + tile, ((unsigned long long)a.epoch << 32) |
                                          (unsigned)count);
    const unsigned long long excl =
        count ? counts_before(st, tile, a.kmax, a.epoch) : 0ull;
    if (lane == 0) {
      s_excl = excl;
      s_count[0] = count;
    }
  }
  __syncthreads();
  const long long excl = (long long)s_excl;
  const int count = s_count[0];
  if (count == 0 || excl >= a.kmax) return;
  // the tile's set rows below kmax, ranked, to shared memory; then the
  // CTA writes their rows word by word
  int total;
  int k = block_scan<THREADS>(mine, &total);
  const int n = (int)(a.kmax - excl < count ? a.kmax - excl : count);
  for (unsigned long long b = bits; b && k < n; b &= b - 1, ++k)
    s_rows[k] = (unsigned short)(threadIdx.x * ROWS_T +
                                 __ffsll((long long)b) - 1);
  __syncthreads();
  long long* o = a.out + excl * a.W;
  int c = threadIdx.x % a.W;
  const int adv = THREADS % a.W;
  for (int i = threadIdx.x; i < n * a.W; i += THREADS) {
    o[i] = row_word(a, lo + s_rows[i / a.W], c, 1ll);
    c += adv;
    if (c >= a.W) c -= a.W;
  }
}

// A padding helper (slice `slice` of NHELP): sums every tile's count,
// the total, then writes its share of the padding rows [total, kmax),
// copies of row R-1 with live 0.
__device__ void pad_part(const OutlierCompactArgs& a, int slice) {
  __shared__ long long s_total;
  __shared__ long long s_pad[PAD_WORDS];
  if (threadIdx.x < 32) {
    const unsigned long long total =
        counts_before(a.scratch + S_STATUS, a.ntiles, a.kmax, a.epoch);
    if (threadIdx.x == 0) s_total = (long long)total;
  }
  __syncthreads();
  const long long total = s_total;
  if (total >= a.kmax) return;
  const long long share = (a.kmax - total + NHELP - 1) / NHELP;
  const long long lo = total + slice * share;
  const long long hi = lo + share < a.kmax ? lo + share : a.kmax;
  if (lo >= hi) return;
  long long* dst = a.out + lo * a.W;
  const long long npad = hi - lo;
  if (a.W <= PAD_WORDS) {
    for (int c = threadIdx.x; c < a.W; c += THREADS)
      s_pad[c] = row_word(a, a.R - 1, c, 0ll);
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
        dst[j * a.W + c] = row_word(a, a.R - 1, c, 0ll);
  }
}

// The grid: ntiles compaction CTAs, then NHELP padding helpers, each
// given its role by an atomic ticket (the hardware need not start CTAs
// in index order; the ticket's order is the order they started in).
__global__ void __launch_bounds__(THREADS) outlier_kernel(
    const OutlierCompactArgs a) {
  __shared__ int s_ticket;
  if (threadIdx.x == 0)
    s_ticket = (int)(atomicAdd(a.scratch + S_TICKET, 1ull) -
                     (unsigned long long)a.base);
  __syncthreads();
  const int t = s_ticket;
  if (t < a.ntiles)
    tile_part(a, t);
  else
    pad_part(a, t - a.ntiles);
}

}  // namespace

// Copies the descriptor block, then runs the one launch on `stream`.
// Returns cudaError_t.
extern "C" int outlier_compact(const OutlierCompactArgs* args, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const OutlierCompactArgs& a = *args;
  if (a.vg_span < 0 || (a.vg_span & (a.vg_span - 1)) || a.R < 1 ||
      a.R >= (1ll << 31) || a.kmax < 0 || a.kmax > a.R || a.W < 2 ||
      a.ntiles != (int)((a.R + TILE - 1) / TILE) || a.scratch == nullptr ||
      a.epoch == 0u || a.grid != a.ntiles + NHELP)
    return cudaErrorInvalidValue;
  const cudaError_t err = desc_upload(a.desc, s);
  if (err != cudaSuccess) return err;
  outlier_kernel<<<a.grid, THREADS, 0, s>>>(a);
  return cudaGetLastError();
}
