// K11 enum_segments: the groups of the enumerated scan strategy, from the
// rows sorted by their packed key.
//
// Replaces sybil_tpu/ops/scan.py:_scan_enum 1484-1546.  The reference sums
// each group in row space without a scatter (bit-packed carriers through
// the sort, their cumsum minus a cummax-propagated segment base, or a
// gather and cumsum of int64 lanes), because large scatters are serial
// loops on a TPU.  Only its outputs have to match, and Hopper has native
// 64-bit atomics, so this kernel sums each segment directly:
//   gid[i]      the segment of sorted row i (segments are runs of equal
//               packed keys);
//   sums[s, L]  per live segment s (key below the radix: the radix segment
//               holds the unmatched and spilled rows) the exact sums of the
//               lanes [w, 1, (exists, kw, kw*(v-bias)) x A] of
//               _agg_row_data, read from the columns at the original row
//               p[i]; unsigned 64-bit, wrapping like the reference's int64
//               sums.  Every lane is summed, whatever the reference's carry
//               plan skips: the plan's claims (a lane equal to the row
//               count) hold exactly when the bind proved them;
//   score[i]    at each live segment's last row the prune score: its count
//               lane ($COUNT, int64), or f32(wv) / f32(max(acnt, 1)) where
//               acnt > 0, else -inf (prune_agg, with IEEE division and
//               round-to-nearest int64 -> f32 conversions, as XLA's); -1 or
//               -inf at every other row (1536-1546);
//   num_groups  the live segments: all segments, less the radix segment
//               when it exists (it sorts last).
//
// Bound: memory.  Per row: the sorted key (4 B, twice), p (8 B), the
// aggregation and weight columns gathered at p (9 B each), gid (4 B) and
// the score written.  Design, four launches (K8's, segment_reduce.cu):
//   1. count:  each CTA counts the boundaries of its TILE-row tile;
//   2. scan:   one CTA turns the counts into exclusive offsets and writes
//              num_groups;
//   3. reduce: each CTA walks its tile 256 rows at a time: a block scan of
//              the boundaries gives each row's gid; each row writes its
//              sentinel score and a live segment's last row its row index
//              to segend; the lanes are summed per warp run of equal gids
//              (the rows of a segment are contiguous) with shuffles, one
//              64-bit atomic per run and lane;
//   4. score:  one thread per live segment reads its sums and writes the
//              score at its last row.

#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "desc.cuh"
#include <math_constants.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 4096;
constexpr int SCAN_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;

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
  int* segend;                     // [Smax] scratch: last row of a segment
  int* offsets;                    // [ntiles + 1] scratch
  long long* num_groups;           // [1]
  long long R;
  int radix;                       // the packed key of dead rows
  int Smax;                        // min(R, radix + 1)
  int L;
  int naggs;
  int ntiles;
  int has_weight;
  int prune_agg;                   // -1: $COUNT, else the agg of the mean
  int pad_;
};

namespace {

__device__ __forceinline__ bool boundary(const EnumSegmentsArgs& a,
                                         long long i) {
  return i == 0 || a.skey[i] != a.skey[i - 1];
}

__global__ void __launch_bounds__(THREADS) count_tiles(
    const EnumSegmentsArgs a) {
  const long long lo = (long long)blockIdx.x * TILE;
  int n = 0;
  for (int t = threadIdx.x; t < TILE; t += THREADS) {
    const long long i = lo + t;
    if (i < a.R && boundary(a, i)) ++n;
  }
  n = __reduce_add_sync(FULL, n);
  __shared__ int s_n;
  if (threadIdx.x == 0) s_n = 0;
  __syncthreads();
  if ((threadIdx.x & 31) == 0 && n) atomicAdd(&s_n, n);
  __syncthreads();
  if (threadIdx.x == 0) a.offsets[blockIdx.x] = s_n;
}

__global__ void __launch_bounds__(SCAN_THREADS) scan_tiles(
    const EnumSegmentsArgs a) {
  int carry = 0;
  for (int base = 0; base < a.ntiles; base += SCAN_THREADS) {
    const int t = base + threadIdx.x;
    const int x = t < a.ntiles ? a.offsets[t] : 0;
    int total;
    const int pre = block_scan<SCAN_THREADS>(x, &total);
    if (t < a.ntiles) a.offsets[t] = carry + pre;
    carry += total;
  }
  if (threadIdx.x == 0) {
    a.offsets[a.ntiles] = carry;
    // the radix segment (unmatched and spilled rows) sorts last
    a.num_groups[0] = carry - (a.skey[a.R - 1] >= a.radix ? 1 : 0);
  }
}

// Warp-run sum: lanes [lane, end] hold the rows of one run; after the
// call the run's first lane holds the run's total.
__device__ __forceinline__ unsigned long long run_sum(unsigned long long x,
                                                      int lane, int end) {
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long y = __shfl_down_sync(FULL, x, d);
    if (lane + d <= end) x += y;
  }
  return x;
}

__global__ void __launch_bounds__(THREADS) reduce_kernel(
    const EnumSegmentsArgs a) {
  const long long lo = (long long)blockIdx.x * TILE;
  const int lane = threadIdx.x & 31;
  const int L = a.L;
  int run = a.offsets[blockIdx.x];  // boundaries before this row block
  for (int t0 = 0; t0 < TILE && lo + t0 < a.R; t0 += THREADS) {
    const long long i = lo + t0 + threadIdx.x;
    const bool in = i < a.R;
    const int b = in && boundary(a, i);
    int total;
    const int pre = block_scan<THREADS>(b, &total);
    const int gid = run + pre + b - 1;
    run += total;
    bool live = false;
    if (in) {
      const int key = a.skey[i];
      live = key < a.radix;
      a.gid[i] = gid;
      if (a.prune_agg >= 0)
        static_cast<float*>(a.score)[i] = -CUDART_INF_F;
      else
        static_cast<long long*>(a.score)[i] = -1ll;
      const bool end = i == a.R - 1 || a.skey[i + 1] != key;
      if (live && end) a.segend[gid] = (int)i;
    }
    const int cg = live ? gid : a.Smax;
    // this warp's runs of equal cg
    const int prev = __shfl_up_sync(FULL, cg, 1);
    const unsigned heads = __ballot_sync(FULL, lane == 0 || prev != cg);
    const unsigned after = lane == 31 ? 0u : heads & (FULL << (lane + 1));
    const int end = after ? __ffs(after) - 2 : 31;
    const bool add = ((heads >> lane) & 1u) && cg < a.Smax;
    unsigned long long* row = a.sums + (size_t)cg * L;
    const long long r = live ? a.p[i] : 0;
    unsigned long long w = 0ull;
    if (live)
      w = a.has_weight && a.w_valid[r] ? (unsigned long long)a.w_vals[r] : 1ull;
    unsigned long long x = run_sum(w, lane, end);
    if (add && x) atomicAdd(row, x);
    x = run_sum(live ? 1ull : 0ull, lane, end);
    if (add && x) atomicAdd(row + 1, x);
    for (int ai = 0; ai < a.naggs; ++ai) {
      const bool valid = live && desc_at(a.desc, a.agg_valid, ai)[r];
      const long long v = valid ? desc_at(a.desc, a.agg_vals, ai)[r] : 0ll;
      const bool keep = valid && !(v > desc_at(a.desc, a.agg_dmax, ai) ||
                                   v < desc_at(a.desc, a.agg_dmin, ai));
      x = run_sum(valid ? 1ull : 0ull, lane, end);
      if (add && x) atomicAdd(row + 2 + 3 * ai, x);
      x = run_sum(keep ? w : 0ull, lane, end);
      if (add && x) atomicAdd(row + 3 + 3 * ai, x);
      const unsigned long long bias =
          (unsigned long long)desc_at(a.desc, a.agg_bias, ai);
      x = run_sum(keep ? w * ((unsigned long long)v - bias) : 0ull, lane,
                  end);
      if (add && x) atomicAdd(row + 4 + 3 * ai, x);
    }
  }
}

__global__ void __launch_bounds__(THREADS) score_kernel(
    const EnumSegmentsArgs a) {
  const long long n = a.num_groups[0];
  for (long long s = (long long)blockIdx.x * THREADS + threadIdx.x; s < n;
       s += (long long)gridDim.x * THREADS) {
    const unsigned long long* row = a.sums + (size_t)s * a.L;
    const int i = a.segend[s];
    if (a.prune_agg >= 0) {
      const long long acnt = (long long)row[3 + 3 * a.prune_agg];
      const long long wv = (long long)row[4 + 3 * a.prune_agg];
      static_cast<float*>(a.score)[i] =
          acnt > 0 ? __fdiv_rn(__ll2float_rn(wv),
                               __ll2float_rn(acnt > 1 ? acnt : 1ll))
                   : -CUDART_INF_F;
    } else {
      static_cast<long long*>(a.score)[i] = (long long)row[0];
    }
  }
}

}  // namespace

// Copies the descriptor block and zeroes the sums on `stream`, then runs
// the four launches; `grid` sizes
// the score pass.  Returns cudaError_t.
extern "C" int enum_segments(const EnumSegmentsArgs* args, int grid,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const EnumSegmentsArgs& a = *args;
  if (a.R < 1 || a.R >= (1ll << 31) ||
      a.ntiles != (int)((a.R + TILE - 1) / TILE) ||
      a.L != 2 + 3 * a.naggs || a.Smax < 1 ||
      a.prune_agg >= a.naggs)
    return cudaErrorInvalidValue;
  cudaError_t err = desc_upload(a.desc, s);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(
      a.sums, 0, (size_t)a.Smax * a.L * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return err;
  count_tiles<<<a.ntiles, THREADS, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_tiles<<<1, SCAN_THREADS, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  reduce_kernel<<<a.ntiles, THREADS, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  score_kernel<<<grid, THREADS, 0, s>>>(a);
  return cudaGetLastError();
}
