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
// key; the scores here hold no NaN).  Then:
//   1. radix select of the k-th largest key T, 8 bits a pass from the top
//      (4 passes for 32-bit keys, 8 for int64): each pass a grid-wide
//      histogram of the current digit over the keys that match the digits
//      chosen so far (per-CTA shared counts, one global atomic per bin),
//      and one small CTA that picks the digit holding the k_rem-th key and
//      keeps the state (prefix, k_rem) on the device;
//   2. compaction: every key above T (k - k_rem of them), then the first
//      k_rem keys equal to T in index order, by a tile count, a one-CTA
//      scan and a ranked write (outlier_compact.cu's shape);
//   3. a one-CTA bitonic sort of the k winners in shared memory by (key
//      descending, index ascending).
// No library sort or top-k is called.
//
// Bound: memory.  The passes read the R scores once each (up to 9 reads
// of 4 or 8 B a row); the rest touches k rows.  The engine asks for
// k <= 1000, the one-CTA sort takes k <= 4096.
//
// Two-valued scores (the mesh scan's 0/1 live flags, mesh.py:291-294):
// every key above T then equals every other, so the compaction already
// writes the winners in (key descending, index ascending) order.  With
// `two_valued` set the compaction writes straight into `out`, the sort is
// skipped, and k is bounded by R alone.

#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 4096;
constexpr int SCAN_THREADS = 1024;
constexpr int SORT_THREADS = 1024;
constexpr int KMAX = 4096;
constexpr unsigned FULL = 0xffffffffu;

struct TopkArgs {
  const void* score;
  int* out;                    // [k] indices
  unsigned long long* state;   // [2] prefix, k_rem
  unsigned int* hist;          // [256]
  int* offsets;                // [2, ntiles + 1]: keys above T, equal to T
  int* cand;                   // [k]
  long long R;
  int k;
  int dtype;                   // 0 int32, 1 int64, 2 f32
  int ntiles;
};

__device__ __forceinline__ unsigned long long okey(const TopkArgs& a,
                                                   long long i) {
  if (a.dtype == 0)
    return (unsigned)static_cast<const int*>(a.score)[i] ^ 0x80000000u;
  if (a.dtype == 1)
    return (unsigned long long)static_cast<const long long*>(a.score)[i] ^
           0x8000000000000000ull;
  const unsigned b = static_cast<const unsigned*>(a.score)[i];
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__global__ void init_state(TopkArgs a) {
  a.state[0] = 0ull;
  a.state[1] = (unsigned long long)a.k;
}

// Histogram of the digit at `shift` over the keys whose bits above it
// equal the prefix chosen so far.
__global__ void __launch_bounds__(THREADS) hist_kernel(TopkArgs a, int shift,
                                                       int nbits) {
  __shared__ unsigned s_hist[256];
  s_hist[threadIdx.x] = 0u;
  __syncthreads();
  const int top = shift + 8;
  const unsigned long long hi =
      top >= nbits ? 0ull : ~0ull << top;
  const unsigned long long prefix = a.state[0] & hi;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < a.R;
       i += (long long)gridDim.x * THREADS) {
    const unsigned long long u = okey(a, i);
    if ((u & hi) == prefix) atomicAdd(&s_hist[(u >> shift) & 255u], 1u);
  }
  __syncthreads();
  if (s_hist[threadIdx.x]) atomicAdd(&a.hist[threadIdx.x], s_hist[threadIdx.x]);
}

// Picks the digit that holds the k_rem-th largest matching key, from the
// top bin down, and clears the histogram for the next pass.
__global__ void __launch_bounds__(256) select_kernel(TopkArgs a, int shift) {
  __shared__ unsigned s_hist[256];
  s_hist[threadIdx.x] = a.hist[threadIdx.x];
  __syncthreads();
  a.hist[threadIdx.x] = 0u;
  if (threadIdx.x == 0) {
    unsigned long long k_rem = a.state[1];
    int d = 255;
    for (; d > 0; --d) {
      const unsigned long long c = s_hist[d];
      if (c >= k_rem) break;
      k_rem -= c;
    }
    a.state[0] |= (unsigned long long)d << shift;
    a.state[1] = k_rem;
  }
}

__global__ void __launch_bounds__(THREADS) count_tiles(TopkArgs a) {
  const unsigned long long T = a.state[0];
  const long long lo = (long long)blockIdx.x * TILE;
  int ngt = 0, neq = 0;
  for (int t = threadIdx.x; t < TILE; t += THREADS) {
    const long long i = lo + t;
    if (i < a.R) {
      const unsigned long long u = okey(a, i);
      ngt += u > T;
      neq += u == T;
    }
  }
  ngt = __reduce_add_sync(FULL, ngt);
  neq = __reduce_add_sync(FULL, neq);
  __shared__ int s_gt, s_eq;
  if (threadIdx.x == 0) s_gt = s_eq = 0;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    if (ngt) atomicAdd(&s_gt, ngt);
    if (neq) atomicAdd(&s_eq, neq);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a.offsets[blockIdx.x] = s_gt;
    a.offsets[a.ntiles + 1 + blockIdx.x] = s_eq;
  }
}

// One CTA per offsets row (blockIdx.x 0: keys above T, 1: keys equal).
__global__ void __launch_bounds__(SCAN_THREADS) scan_tiles(TopkArgs a) {
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

__global__ void __launch_bounds__(THREADS) write_candidates(TopkArgs a) {
  const unsigned long long T = a.state[0];
  const int k_rem = (int)a.state[1];
  const int ngt = a.k - k_rem;
  const long long lo = (long long)blockIdx.x * TILE;
  int rank_gt = a.offsets[blockIdx.x];
  int rank_eq = a.offsets[a.ntiles + 1 + blockIdx.x];
  for (int t0 = 0; t0 < TILE && lo + t0 < a.R; t0 += THREADS) {
    const long long i = lo + t0 + threadIdx.x;
    unsigned long long u = 0ull;
    if (i < a.R) u = okey(a, i);
    const bool gt = i < a.R && u > T;
    const bool eq = i < a.R && u == T;
    int ngt_blk, neq_blk;
    const int pgt = block_scan<THREADS>(gt ? 1 : 0, &ngt_blk);
    const int peq = block_scan<THREADS>(eq ? 1 : 0, &neq_blk);
    if (gt && rank_gt + pgt < ngt) a.cand[rank_gt + pgt] = (int)i;
    if (eq && rank_eq + peq < k_rem) a.cand[ngt + rank_eq + peq] = (int)i;
    rank_gt += ngt_blk;
    rank_eq += neq_blk;
  }
}

// (key, index) pairs in shared memory, sorted so that larger keys come
// first and equal keys by index.
__device__ __forceinline__ bool before(unsigned long long ka, int ia,
                                       unsigned long long kb, int ib) {
  return ka > kb || (ka == kb && ia < ib);
}

__global__ void __launch_bounds__(SORT_THREADS) sort_kernel(TopkArgs a,
                                                            int n) {
  extern __shared__ unsigned long long s_key[];
  int* s_idx = reinterpret_cast<int*>(s_key + n);
  for (int j = threadIdx.x; j < n; j += SORT_THREADS) {
    if (j < a.k) {
      const int i = a.cand[j];
      s_key[j] = okey(a, i);
      s_idx[j] = i;
    } else {          // padding sorts after every real pair
      s_key[j] = 0ull;
      s_idx[j] = 0x7fffffff;
    }
  }
  __syncthreads();
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int j = threadIdx.x; j < n; j += SORT_THREADS) {
        const int l = j ^ stride;
        if (l > j) {
          const bool up = (j & size) == 0;
          const bool swap = up ? before(s_key[l], s_idx[l], s_key[j], s_idx[j])
                               : before(s_key[j], s_idx[j], s_key[l], s_idx[l]);
          if (swap) {
            const unsigned long long tk = s_key[j];
            s_key[j] = s_key[l];
            s_key[l] = tk;
            const int ti = s_idx[j];
            s_idx[j] = s_idx[l];
            s_idx[l] = ti;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int j = threadIdx.x; j < a.k; j += SORT_THREADS) a.out[j] = s_idx[j];
}

}  // namespace

// Runs the select passes, the compaction and (unless two_valued) the sort
// on `stream`; `grid` sizes the histogram passes.  Returns cudaError_t.
extern "C" int topk_rows(const void* score, int* out,
                         unsigned long long* state, unsigned int* hist,
                         int* offsets, int* cand, long long R, int k,
                         int dtype, int ntiles, int two_valued, int grid,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R < 1 || R >= (1ll << 31) || k < 1 || (k > KMAX && !two_valued) ||
      k > R || dtype < 0 || dtype > 2 ||
      ntiles != (int)((R + TILE - 1) / TILE) || (two_valued && cand != out))
    return cudaErrorInvalidValue;
  const TopkArgs a{score, out, state, hist, offsets, cand, R, k, dtype,
                   ntiles};
  cudaError_t err = cudaMemsetAsync(hist, 0, 256 * sizeof(unsigned), s);
  if (err != cudaSuccess) return err;
  init_state<<<1, 1, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int nbits = dtype == 1 ? 64 : 32;
  for (int shift = nbits - 8; shift >= 0; shift -= 8) {
    hist_kernel<<<grid, THREADS, 0, s>>>(a, shift, nbits);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    select_kernel<<<1, 256, 0, s>>>(a, shift);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  count_tiles<<<ntiles, THREADS, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_tiles<<<2, SCAN_THREADS, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  write_candidates<<<ntiles, THREADS, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess || two_valued) return err;
  int n = 1;
  while (n < k) n <<= 1;
  sort_kernel<<<1, SORT_THREADS, (size_t)n * (8 + 4), s>>>(a, n);
  return cudaGetLastError();
}
