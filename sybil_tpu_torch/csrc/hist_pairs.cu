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
//   pairkey  = gid * nv + bucket where hcontrib, else (S+1) * nv;
//   w        = the row's weight (1 without a weight column) where
//              hcontrib, else 0;
//   outliers = hcontrib rows whose bucket overflowed: mask, value (else
//              0) and count, in sorted order (K5 compacts them with kmat).
//
// hist_pairs replaces _scan_sorted 1256-1266 after the sort (spk, si2):
//   hp_mask  = the first row of each pair-key segment below the sentinel;
//   hp_bv    = spk % nv there, else 0;
//   hp_w     = the segment's weight sum at its first row (the reference's
//              segment_sum broadcast and masked), else 0;
//   hp_keys  = kmat[si2] for every row (the packed section's padding rows
//              read row R-1 of it);
//   npairs   = the number of segments below the sentinel.
//
// Bound: memory.  hist_prep gathers the value and weight columns at the
// sorted rows and writes 16 B (25 B with outliers) per row; hist_pairs
// reads spk and si2, gathers w and kmat at si2 and writes 25 + 8K B per
// row.  Design of hist_pairs, four launches: count the segment starts per
// TILE-row tile; scan the counts (one CTA); per tile, number each row's
// segment with a block scan, record each segment's first row, write
// hp_mask, hp_bv, hp_keys and a zero hp_w; then sum each segment's
// weights into hp_w at its first row, one 64-bit atomic per warp run of
// equal segments (rows of a segment are contiguous), exact mod 2^64.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 4096;
constexpr int SCAN_THREADS = 1024;
constexpr int MAXSUB = 64;
constexpr unsigned FULL = 0xffffffffu;

}  // namespace

// Mirrored field for field by HistPairsArgs in ops/scan.py (ctypes).
struct HistPairsArgs {
  const int* sidxm;              // [R] K8: sorted row index | matched bit
  const int* gid;                // [R] K8: gid of each sorted row
  const long long* vals;         // [R] the aggregation's column
  const unsigned char* valid;
  const long long* w_vals;       // weight column or null
  const unsigned char* w_valid;
  long long* pairkey;            // [R] hist_prep out
  long long* w;                  // [R] hist_prep out
  unsigned char* out_mask;       // [R] or null (no outlier tracking)
  long long* out_val;            // [R] or null
  unsigned long long* nout;      // [1] or null
  const long long* spk;          // [R] sorted pair keys (hist_pairs in)
  const long long* si2;          // [R] their sort indices
  const long long* kmat;         // [R, K] K8's sorted keys
  unsigned char* hp_mask;        // [R]
  long long* hp_bv;              // [R]
  long long* hp_w;               // [R]
  long long* hp_keys;            // [R, K]
  unsigned long long* npairs;    // [1]
  int* seg;                      // [R] scratch: segment of each row
  int* segstart;                 // [R] scratch: first row of each segment
  int* offsets;                  // [ntiles + 1] scratch
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
  int has_weight;
  int ntiles;
  int pad_;
};

namespace {

__global__ void __launch_bounds__(THREADS) prep_kernel(const HistPairsArgs a) {
  __shared__ unsigned long long s_nout;
  if (threadIdx.x == 0) s_nout = 0ull;
  __syncthreads();
  unsigned long long my_nout = 0ull;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < a.R;
       i += (long long)gridDim.x * THREADS) {
    const int m = a.sidxm[i];
    const long long r = m & 0x7fffffff;
    const int g = a.gid[i];
    bool hc = m < 0 && g < a.S && a.valid[r];
    long long v = 0;
    bool is_out = false;
    long long bv = 0;
    if (hc) {
      v = a.vals[r];
      hc = !(v > a.dmax || v < a.dmin);
    }
    if (hc) {
      if (a.nsub == 0) {
        const long long raw =
            (long long)((unsigned long long)v - (unsigned long long)a.hist_min)
            / a.bucket_size;
        is_out = raw >= a.nv;
        bv = raw < 0 ? 0 : (raw > a.nv - 1 ? a.nv - 1 : raw);
      } else {
        bool assigned = false;
        for (int s = 0; s < a.nsub; ++s) {
          if (v < a.sub_min[s] || v > a.sub_max[s]) continue;
          const long long raw =
              (long long)((unsigned long long)v
                          - (unsigned long long)a.sub_min[s]) / a.sub_bs[s];
          const long long snv = a.sub_nv[s];
          is_out = raw >= snv;
          bv = (raw < 0 ? 0 : (raw > snv - 1 ? snv - 1 : raw)) + a.sub_off[s];
          assigned = true;
          break;
        }
        hc = assigned;
      }
    }
    a.pairkey[i] = hc ? (long long)g * a.nv + bv : a.sent_pk;
    long long w = 0;
    if (hc) w = a.has_weight && a.w_valid[r] ? a.w_vals[r] : 1ll;
    a.w[i] = w;
    if (a.out_mask) {
      const bool o = hc && is_out;
      a.out_mask[i] = o;
      a.out_val[i] = o ? v : 0ll;
      my_nout += o;
    }
  }
  if (my_nout) atomicAdd(&s_nout, my_nout);
  __syncthreads();
  if (threadIdx.x == 0 && a.nout && s_nout) atomicAdd(a.nout, s_nout);
}

__device__ __forceinline__ bool seg_start(const HistPairsArgs& a,
                                          long long i) {
  return i == 0 || a.spk[i] != a.spk[i - 1];
}

__global__ void __launch_bounds__(THREADS) count_tiles(const HistPairsArgs a) {
  const long long lo = (long long)blockIdx.x * TILE;
  int n = 0;
  for (int t = threadIdx.x; t < TILE; t += THREADS) {
    const long long i = lo + t;
    if (i < a.R && seg_start(a, i)) ++n;
  }
  n = __reduce_add_sync(FULL, n);
  __shared__ int s_n;
  if (threadIdx.x == 0) s_n = 0;
  __syncthreads();
  if ((threadIdx.x & 31) == 0 && n) atomicAdd(&s_n, n);
  __syncthreads();
  if (threadIdx.x == 0) a.offsets[blockIdx.x] = s_n;
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
    const HistPairsArgs a) {
  int carry = 0;
  for (int base = 0; base < a.ntiles; base += SCAN_THREADS) {
    const int t = base + threadIdx.x;
    const int x = t < a.ntiles ? a.offsets[t] : 0;
    int total;
    const int pre = block_scan<SCAN_THREADS>(x, &total);
    if (t < a.ntiles) a.offsets[t] = carry + pre;
    carry += total;
  }
  if (threadIdx.x == 0) a.offsets[a.ntiles] = carry;
}

__global__ void __launch_bounds__(THREADS) segment_kernel(
    const HistPairsArgs a) {
  const long long lo = (long long)blockIdx.x * TILE;
  const int K = a.K;
  int run = a.offsets[blockIdx.x];
  unsigned long long my_pairs = 0ull;
  for (int t0 = 0; t0 < TILE && lo + t0 < a.R; t0 += THREADS) {
    const long long i = lo + t0 + threadIdx.x;
    const bool in = i < a.R;
    const int b = in && seg_start(a, i);
    int total;
    const int pre = block_scan<THREADS>(b, &total);
    const int s = run + pre + b - 1;
    run += total;
    if (!in) continue;
    a.seg[i] = s;
    const long long key = a.spk[i];
    const bool valid = b && key < a.sent_pk;
    if (b) a.segstart[s] = (int)i;
    a.hp_mask[i] = valid;
    a.hp_bv[i] = valid ? key % a.nv : 0ll;
    a.hp_w[i] = 0ll;
    my_pairs += valid;
    const long long j = a.si2[i];
    for (int k = 0; k < K; ++k)
      a.hp_keys[(size_t)i * K + k] = a.kmat[(size_t)j * K + k];
  }
  my_pairs = __reduce_add_sync(FULL, (unsigned)my_pairs);
  if ((threadIdx.x & 31) == 0 && my_pairs) atomicAdd(a.npairs, my_pairs);
}

__global__ void __launch_bounds__(THREADS) weight_kernel(
    const HistPairsArgs a) {
  const int lane = threadIdx.x & 31;
  // every lane runs the same trip count: the shuffles need the full warp
  const long long span = (long long)gridDim.x * THREADS;
  for (long long i0 = (long long)blockIdx.x * THREADS; i0 < a.R;
       i0 += span) {
    const long long i = i0 + threadIdx.x;
    const bool in = i < a.R;
    const int s = in ? a.seg[i] : -1;
    unsigned long long x = 0ull;
    if (in && a.spk[i] < a.sent_pk) x = (unsigned long long)a.w[a.si2[i]];
    const int prev = __shfl_up_sync(FULL, s, 1);
    const unsigned heads = __ballot_sync(FULL, lane == 0 || prev != s);
    const unsigned after = lane == 31 ? 0u : heads & (FULL << (lane + 1));
    const int end = after ? __ffs(after) - 2 : 31;
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned long long y = __shfl_down_sync(FULL, x, d);
      if (lane + d <= end) x += y;
    }
    if (((heads >> lane) & 1u) && x)
      atomicAdd(reinterpret_cast<unsigned long long*>(a.hp_w) + a.segstart[s],
                x);
  }
}

}  // namespace

// The first entry: zeroes the outlier count, then one grid-stride pass.
// Returns cudaError_t.
extern "C" int hist_prep(const HistPairsArgs* args, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (args->R >= (1ll << 31) || args->nsub > MAXSUB)
    return cudaErrorInvalidValue;
  if (args->nout) {
    cudaError_t err =
        cudaMemsetAsync(args->nout, 0, sizeof(unsigned long long), s);
    if (err != cudaSuccess) return err;
  }
  prep_kernel<<<grid, THREADS, 0, s>>>(*args);
  return cudaGetLastError();
}

// The second entry: zeroes npairs, then the four launches; `grid` sizes
// the grid-stride weight pass.  Returns cudaError_t.
extern "C" int hist_pairs(const HistPairsArgs* args, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const HistPairsArgs& a = *args;
  if (a.R >= (1ll << 31) || a.ntiles != (int)((a.R + TILE - 1) / TILE) ||
      a.nv <= 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(a.npairs, 0, sizeof(unsigned long long),
                                    s);
  if (err != cudaSuccess) return err;
  count_tiles<<<a.ntiles, THREADS, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_tiles<<<1, SCAN_THREADS, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  segment_kernel<<<a.ntiles, THREADS, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  weight_kernel<<<grid, THREADS, 0, s>>>(a);
  return cudaGetLastError();
}
