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
// its row of K8's kmat [R, K] (the reference's sorted_gkeys there).  When
// fewer than kmax rows are set, the reference
// gathers row R-1 for each remaining entry (searchsorted returns R,
// clipped to R-1), so padding rows hold row R-1's keys and value with
// live = 0; this kernel writes the same words.
//
// Bound: memory, one read of the 1 B mask per row; the section itself
// is at most kmax * W words.  Design, three launches on one stream:
//   1. count: each CTA counts the set rows of its TILE-row tile;
//   2. scan:  one CTA turns the tile counts into exclusive offsets and
//             the total;
//   3. write: each CTA whose offset is below kmax ranks its set rows in
//             row order (a warp ballot and a block scan per 256 rows)
//             and writes those with rank < kmax; then all CTAs together
//             write the padding rows [total, kmax).

#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "desc.cuh"
#include "time_key.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 4096;
constexpr int SCAN_THREADS = 1024;

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
  int* offsets;                // [ntiles + 1] scratch: counts, then offsets
  long long R;
  long long tb;                // time bucket (> 0)
  int kmax;
  int W;
  int nkeys;                   // group columns; none and no time = one zero key
  int ntiles;
  int has_time;                // the time key follows the cg key, if any
  int time_i32;
  int kmat_K;
  int log2C;                   // rows per block, log2
  int vg_span;                 // > 0: key 0 is the cache-group key
};

namespace {

__device__ __forceinline__ void write_row(const OutlierCompactArgs& a,
                                          long long j, long long r,
                                          long long live) {
  long long* o = a.out + j * a.W;
  const int cg = a.vg_span > 0;
  const int lead = cg + a.has_time;
  const int nk = a.nkeys + lead;
  int K = nk > 0 ? nk : 1;
  if (a.kmat) {
    K = a.kmat_K;
    for (int k = 0; k < K; ++k) o[k] = a.kmat[r * K + k];
  } else {
    // vg_span is a power of two
    if (cg) o[0] = r >> (a.log2C + __ffs(a.vg_span) - 1);
    if (a.has_time) o[cg] = time_key(a.t_vals[r], a.tb, a.time_i32);
    for (int k = 0; k < a.nkeys; ++k)
      o[lead + k] = desc_at(a.desc, a.key_valid, k)[r]
                        ? desc_at(a.desc, a.key_vals, k)[r] : -1ll;
    if (nk == 0) o[0] = 0;
  }
  o[K] = a.vals[r];
  o[K + 1] = live;
  for (int k = K + 2; k < a.W; ++k) o[k] = 0;
}

__global__ void __launch_bounds__(THREADS) count_tiles(
    const OutlierCompactArgs a) {
  const long long lo = (long long)blockIdx.x * TILE;
  int n = 0;
  for (int i = threadIdx.x; i < TILE; i += THREADS) {
    const long long r = lo + i;
    if (r < a.R && a.mask[r]) ++n;
  }
  __shared__ int s_n;
  if (threadIdx.x == 0) s_n = 0;
  __syncthreads();
  if (n) atomicAdd(&s_n, n);
  __syncthreads();
  if (threadIdx.x == 0) a.offsets[blockIdx.x] = s_n;
}

__global__ void __launch_bounds__(SCAN_THREADS) scan_tiles(
    const OutlierCompactArgs a) {
  int carry = 0;
  for (int base = 0; base < a.ntiles; base += SCAN_THREADS) {
    const int i = base + threadIdx.x;
    const int x = i < a.ntiles ? a.offsets[i] : 0;
    int total;
    const int pre = block_scan<SCAN_THREADS>(x, &total);
    if (i < a.ntiles) a.offsets[i] = carry + pre;
    carry += total;
  }
  if (threadIdx.x == 0) a.offsets[a.ntiles] = carry;
}

__global__ void __launch_bounds__(THREADS) write_rows(
    const OutlierCompactArgs a) {
  const long long lo = (long long)blockIdx.x * TILE;
  int rank = a.offsets[blockIdx.x];
  const int total = a.offsets[a.ntiles];
  if (rank < a.kmax) {
    for (int i = 0; i < TILE && rank < a.kmax; i += THREADS) {
      const long long r = lo + i + threadIdx.x;
      const bool set = r < a.R && a.mask[r];
      int n;
      const int pre = block_scan<THREADS>(set ? 1 : 0, &n);
      if (set && rank + pre < a.kmax) write_row(a, rank + pre, r, 1);
      rank += n;
    }
  }
  // padding entries gather row R-1, as the reference's clipped
  // searchsorted does
  for (long long j = (long long)blockIdx.x * THREADS + threadIdx.x;
       j < a.kmax; j += (long long)gridDim.x * THREADS)
    if (j >= total) write_row(a, j, a.R - 1, 0);
}

}  // namespace

// Copies the descriptor block, then runs the three steps on `stream`.
// Returns cudaError_t.
extern "C" int outlier_compact(const OutlierCompactArgs* args, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (args->vg_span < 0 || (args->vg_span & (args->vg_span - 1)))
    return cudaErrorInvalidValue;
  cudaError_t err = desc_upload(args->desc, s);
  if (err != cudaSuccess) return err;
  count_tiles<<<args->ntiles, THREADS, 0, s>>>(*args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_tiles<<<1, SCAN_THREADS, 0, s>>>(*args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  write_rows<<<args->ntiles, THREADS, 0, s>>>(*args);
  return cudaGetLastError();
}
