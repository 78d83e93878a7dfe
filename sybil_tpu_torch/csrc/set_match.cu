// K14 set_match: one set filter's row bitmasks over a batch's set-column
// CSR.
//
// Replaces the set-CSR branch of sybil_tpu/ops/scan.py:_front_end
// (376-381):
//   hit = zeros(R+1).at[row_ids].add(svals == fv)[:R] > 0
//   has = zeros(R+1).at[row_ids].add(1)[:R] > 0
// as two bitmasks of uint32 words [ceil(R/32)], bit r % 32 of word r / 32
// for row r: `has` (the row holds any entry) and `hit` (some entry of the
// row equals fv).  K2 and K7 read them for the filter's in (has & hit)
// and nin (has & ~hit) ops.  Inputs: the batch CSR as the loader pads it,
// prow int32 [M] (row ids in [0, R), ascending: the blocks concatenated
// in order, rows ascending inside each) and pval int64 [M], of which the
// first n entries are real; the pads (prow == R) are never read.  fv is
// the filter's constant, read from the device array filter_vals (a
// never-ingested literal binds to -1, which no entry holds: `in` then
// matches nothing and `nin` every row with any entry).
//
// Bound: memory, n * 12 B read and 2 * R / 8 B written.  One thread per
// entry, grid-stride over whole warps: each entry sets one bit of its
// row's word.  Since the CSR is sorted by row, a warp's 32 entries fall
// into one or a few words; a segmented OR over the warp's runs of equal
// words (five shuffles) leaves each run's OR in its first lane, which
// alone issues the atomicOr: about one atomic per word per warp instead
// of one per entry.  The OR is idempotent, so duplicate values in a row,
// and any entry order, give the same words.  The other design, a thread
// per word with a lower_bound for its first row and a walk over its
// entries, needs neither atomics nor the memset, but its loads are
// strided by the entries per word (about 42 here), so each warp load
// touches 32 lines: this one reads prow and pval coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) set_match_kernel(
    const int* __restrict__ prow, const long long* __restrict__ pval,
    long long n, const long long* __restrict__ filter_vals, int fi,
    unsigned* __restrict__ has, unsigned* __restrict__ hit, long long R) {
  const long long fv = filter_vals[fi];
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * THREADS;
  // every lane of a warp runs the same number of steps (the shuffles
  // take the full mask): the bound is n rounded up to a warp
  const long long end = (n + 31) & ~31ll;
  for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x; e < end;
       e += stride) {
    long long word = -1;
    unsigned hbit = 0u, mbit = 0u;
    if (e < n) {
      const long long r = prow[e];
      if (r >= 0 && r < R) {
        word = r >> 5;
        hbit = 1u << (r & 31);
        mbit = pval[e] == fv ? hbit : 0u;
      }
    }
    // segmented suffix OR over runs of equal words: after the steps, the
    // first lane of a run holds the OR of its run (lanes of other runs
    // with the same word may add their bits too, harmlessly)
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const long long w2 = __shfl_down_sync(0xffffffffu, word, off);
      const unsigned h2 = __shfl_down_sync(0xffffffffu, hbit, off);
      const unsigned m2 = __shfl_down_sync(0xffffffffu, mbit, off);
      if (lane + off < 32 && w2 == word) {
        hbit |= h2;
        mbit |= m2;
      }
    }
    const long long prev = __shfl_up_sync(0xffffffffu, word, 1);
    if (word >= 0 && (lane == 0 || prev != word)) {
      atomicOr(has + word, hbit);
      if (mbit) atomicOr(hit + word, mbit);
    }
  }
}

}  // namespace

// Zeroes has and hit ([ceil(R/32)] words each) on `stream`, then sets
// their bits from the first n CSR entries against filter_vals[fi].
// Returns cudaError_t.
extern "C" int set_match(const int* prow, const long long* pval, long long n,
                         const long long* filter_vals, int fi, unsigned* has,
                         unsigned* hit, long long R, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 0 || R <= 0 || fi < 0) return cudaErrorInvalidValue;
  const size_t words = (size_t)((R + 31) / 32);
  cudaError_t err = cudaMemsetAsync(has, 0, words * sizeof(unsigned), s);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(hit, 0, words * sizeof(unsigned), s);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaSuccess;
  set_match_kernel<<<grid, THREADS, 0, s>>>(prow, pval, n, filter_vals, fi,
                                            has, hit, R);
  return cudaGetLastError();
}
