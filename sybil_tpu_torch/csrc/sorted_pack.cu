// K10 sorted_pack: the keyed group table and the packed download buffer of
// the sorted scan strategy.
//
// Replaces sybil_tpu/ops/scan.py:pack_outputs for a non-dense scan:
//   table    [S, K+2+5A] (1865-1872): each slot's keys, count, samples,
//            and per aggregation exists (0/1: its lane sum > 0), count,
//            wv, min, max (+2^62 / -2^62 for an avg aggregation); it stays
//            on the device for the engine's escalation;
//   meta     row 0 (1902-1965): [num_groups, spill, nout per hist agg,
//            npairs = 0, overflow = 0, pruned = 0, 0, 0, nhistpairs per
//            hist agg], zero-padded to W;
//   prefix   rows 1..P: the table's first P rows, zero-padded to W;
//   pairs    per histogram aggregation (1979-1991), Hcap rows [keys,
//            bucket, Σw, live] of the first Hcap rows of hp_mask in row
//            order; when fewer are set the rest repeat row R-1 with live
//            = 0, as _mask_positions' clipped searchsorted does.
// K5 writes the outlier rows between the prefix and the pair sections;
// this kernel leaves them alone.
//
// Bound: memory.  The table is S x (K+2+5A) words (100,000 slots by
// default), written once and its prefix copied; the pair sections read
// one byte of hp_mask per row and write Hcap x W words.  Design: one
// grid-stride launch for the table, the prefix and the meta row; then, for
// all histogram aggregations at once (gridDim.y), K5's compaction: count
// the set rows per TILE-row tile, scan the counts (one CTA each), rank
// and write the first Hcap rows, then the padding rows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 4096;
constexpr int SCAN_THREADS = 1024;
constexpr int MAXA = 32;
constexpr long long BIG = 1ll << 62;
constexpr unsigned FULL = 0xffffffffu;

}  // namespace

// Mirrored field for field by SortedPackArgs in ops/scan.py (ctypes).
struct SortedPackArgs {
  const unsigned long long* sums;       // [S+1, L]
  const long long* mins;                // [S, H]
  const long long* maxs;                // [S, H]
  const long long* keys_tbl;            // [S, K]
  const long long* num_groups;          // [1]
  const long long* spill;               // [1]
  const long long* nout[MAXA];          // [1] per hist agg, or null
  const unsigned char* hp_mask[MAXA];   // [R] per hist agg
  const long long* hp_keys[MAXA];       // [R, K]
  const long long* hp_bv[MAXA];         // [R]
  const long long* hp_w[MAXA];          // [R]
  const long long* npairs[MAXA];        // [1]
  long long hp_row[MAXA];               // first row of each pair section
  long long* table;                     // [S, K+2+5A]
  long long* main;                      // [rows, W]
  int* offsets;                         // [H, ntiles + 1] scratch
  long long R;
  int agg_mm[MAXA];                     // hist index of each agg, -1 = none
  int S;
  int P;                                // table rows in main
  int K;
  int A;
  int L;
  int H;
  int W;
  int Hcap;
  int ntiles;
  int pad_;
};

namespace {

__global__ void __launch_bounds__(THREADS) table_kernel(
    const SortedPackArgs a) {
  const int Wt = a.K + 2 + 5 * a.A;
  const long long n = (long long)a.S * a.W;
  for (long long idx = (long long)blockIdx.x * THREADS + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * THREADS) {
    const long long g = idx / a.W;
    const int c = (int)(idx - g * a.W);
    long long v = 0;
    if (c < Wt) {
      const unsigned long long* s = a.sums + g * a.L;
      if (c < a.K) {
        v = a.keys_tbl[g * a.K + c];
      } else if (c < a.K + 2) {
        v = (long long)s[c - a.K];
      } else {
        const int ai = (c - a.K - 2) / 5, f = (c - a.K - 2) % 5;
        const int mm = a.agg_mm[ai];
        switch (f) {
          case 0: v = (long long)s[2 + 3 * ai] > 0; break;
          case 1: v = (long long)s[3 + 3 * ai]; break;
          case 2: v = (long long)s[4 + 3 * ai]; break;
          case 3: v = mm >= 0 ? a.mins[g * a.H + mm] : BIG; break;
          default: v = mm >= 0 ? a.maxs[g * a.H + mm] : -BIG; break;
        }
      }
      a.table[g * Wt + c] = v;
    }
    if (g < a.P) a.main[(1 + g) * a.W + c] = v;
  }
  if (blockIdx.x == 0 && threadIdx.x < a.W) {
    const int c = threadIdx.x;
    long long v = 0;
    if (c == 0) {
      v = a.num_groups[0];
    } else if (c == 1) {
      v = a.spill[0];
    } else if (c < 2 + a.H) {
      v = a.nout[c - 2] ? a.nout[c - 2][0] : 0ll;
    } else if (c >= 7 + a.H && c < 7 + 2 * a.H) {
      v = a.npairs[c - 7 - a.H][0];
    }
    a.main[c] = v;
  }
}

__global__ void __launch_bounds__(THREADS) count_tiles(
    const SortedPackArgs a) {
  const unsigned char* mask = a.hp_mask[blockIdx.y];
  const long long lo = (long long)blockIdx.x * TILE;
  int n = 0;
  for (int t = threadIdx.x; t < TILE; t += THREADS) {
    const long long i = lo + t;
    if (i < a.R && mask[i]) ++n;
  }
  n = __reduce_add_sync(FULL, n);
  __shared__ int s_n;
  if (threadIdx.x == 0) s_n = 0;
  __syncthreads();
  if ((threadIdx.x & 31) == 0 && n) atomicAdd(&s_n, n);
  __syncthreads();
  if (threadIdx.x == 0)
    a.offsets[(size_t)blockIdx.y * (a.ntiles + 1) + blockIdx.x] = s_n;
}

// Block-wide exclusive scan of one int per thread (outlier_compact.cu's).
template <int NT>
__device__ int block_scan(int x, int* total) {
  __shared__ int s_warp[NT / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < NT / 32 ? s_warp[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, w, d);
      if (lane >= d) w += y;
    }
    if (lane < NT / 32) s_warp[lane] = w;
  }
  __syncthreads();
  const int before = warp ? s_warp[warp - 1] : 0;
  *total = s_warp[NT / 32 - 1];
  __syncthreads();
  return before + inc - x;
}

__global__ void __launch_bounds__(SCAN_THREADS) scan_tiles(
    const SortedPackArgs a) {
  int* off = a.offsets + (size_t)blockIdx.x * (a.ntiles + 1);
  int carry = 0;
  for (int base = 0; base < a.ntiles; base += SCAN_THREADS) {
    const int t = base + threadIdx.x;
    const int x = t < a.ntiles ? off[t] : 0;
    int total;
    const int pre = block_scan<SCAN_THREADS>(x, &total);
    if (t < a.ntiles) off[t] = carry + pre;
    carry += total;
  }
  if (threadIdx.x == 0) off[a.ntiles] = carry;
}

__device__ void write_pair(const SortedPackArgs& a, int h, long long j,
                           long long r, long long live) {
  long long* o = a.main + (a.hp_row[h] + j) * a.W;
  const long long* keys = a.hp_keys[h] + r * a.K;
  for (int k = 0; k < a.K; ++k) o[k] = keys[k];
  o[a.K] = a.hp_bv[h][r];
  o[a.K + 1] = a.hp_w[h][r];
  o[a.K + 2] = live;
  for (int k = a.K + 3; k < a.W; ++k) o[k] = 0;
}

__global__ void __launch_bounds__(THREADS) write_pairs(
    const SortedPackArgs a) {
  const int h = blockIdx.y;
  const unsigned char* mask = a.hp_mask[h];
  const int* off = a.offsets + (size_t)h * (a.ntiles + 1);
  const long long lo = (long long)blockIdx.x * TILE;
  int rank = off[blockIdx.x];
  const int total = off[a.ntiles];
  if (rank < a.Hcap) {
    for (int t = 0; t < TILE && rank < a.Hcap; t += THREADS) {
      const long long r = lo + t + threadIdx.x;
      const bool set = r < a.R && mask[r];
      int n;
      const int pre = block_scan<THREADS>(set ? 1 : 0, &n);
      if (set && rank + pre < a.Hcap) write_pair(a, h, rank + pre, r, 1);
      rank += n;
    }
  }
  for (long long j = (long long)blockIdx.x * THREADS + threadIdx.x;
       j < a.Hcap; j += (long long)gridDim.x * THREADS)
    if (j >= total) write_pair(a, h, j, a.R - 1, 0);
}

}  // namespace

// Runs the table launch, then the pair compaction for every histogram
// aggregation, on `stream`.  Returns cudaError_t.
extern "C" int sorted_pack(const SortedPackArgs* args, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const SortedPackArgs& a = *args;
  if (a.A > MAXA || a.H > MAXA || a.W < 7 + 2 * a.H || a.P > a.S ||
      a.ntiles != (int)((a.R + TILE - 1) / TILE))
    return cudaErrorInvalidValue;
  const long long n = (long long)a.S * a.W;
  const int grid = (int)((n + THREADS - 1) / THREADS < 1024
                             ? (n + THREADS - 1) / THREADS : 1024);
  table_kernel<<<grid > 0 ? grid : 1, THREADS, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.H == 0 || a.Hcap == 0) return err;
  count_tiles<<<dim3(a.ntiles, a.H), THREADS, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_tiles<<<a.H, SCAN_THREADS, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  write_pairs<<<dim3(a.ntiles, a.H), THREADS, 0, s>>>(a);
  return cudaGetLastError();
}
