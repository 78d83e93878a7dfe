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
// The device prune (sybil_tpu/ops/scan.py:pack_outputs 1896-1900) takes
// the table's winning rows right after the select: given the keyed table
// [S, Wt], main [rows, W] and ptable [k, Wt], the entry also writes
// table[out[j]] as main's row 1 + j (zero-padded to W) and as ptable's
// row j, on the same stream, so the prune costs one host call.  This
// gather (K10's prune_gather, which was a launch of its own in
// sorted_pack.cu) moves k * Wt words: a warp a winner row, its index
// read once, the lanes on the row's consecutive words, no division.  A
// form that gathered inside the sort's one CTA, where the winners are in
// shared memory, ran slower than this launch (PERF.md §6).
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

constexpr int TV_THREADS = 1024;
constexpr int TV_PER = 16;                       // flags a thread
constexpr int TV_TILE = TV_THREADS * TV_PER;     // rows a CTA

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

// The device prune's gather: table [S, Wt], main [rows, W], ptable [k, Wt].
struct Gather {
  const long long* table;
  long long* main;
  long long* ptable;
  int Wt;
  int W;
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

// The device prune's gather: winner j (table row out[j]) as main's row
// 1 + j and ptable's row j, a warp a row.
__global__ void __launch_bounds__(256) gather_kernel(const int* out, int k,
                                                     Gather g) {
  const int j = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (j >= k) return;
  const long long* src = g.table + (size_t)out[j] * g.Wt;
  long long* dst = g.main + (size_t)(1 + j) * g.W;
  for (int c = threadIdx.x & 31; c < g.W; c += 32) {
    const long long v = c < g.Wt ? src[c] : 0;
    dst[c] = v;
    if (c < g.Wt) g.ptable[(size_t)j * g.Wt + c] = v;
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

// Runs the select passes, the compaction and the sort on `stream`; `grid`
// sizes the histogram passes.  With a table (the device prune), then the
// gather of the winners into main's prefix rows and ptable, one launch
// after the sort.  Returns cudaError_t.
extern "C" int topk_rows(const void* score, int* out,
                         unsigned long long* state, unsigned int* hist,
                         int* offsets, int* cand, long long R, int k,
                         int dtype, int ntiles, int grid,
                         const long long* table, long long* main,
                         long long* ptable, int Wt, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R < 1 || R >= (1ll << 31) || k < 1 || k > KMAX || k > R ||
      dtype < 0 || dtype > 2 || ntiles != (int)((R + TILE - 1) / TILE) ||
      (table && (!main || !ptable || Wt < 1 || W < Wt)))
    return cudaErrorInvalidValue;
  const Gather g{table, main, ptable, Wt, W};
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
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  int n = 1;
  while (n < k) n <<= 1;
  sort_kernel<<<1, SORT_THREADS, (size_t)n * (8 + 4), s>>>(a, n);
  if ((err = cudaGetLastError()) != cudaSuccess || !table) return err;
  gather_kernel<<<(k + 7) / 8, 256, 0, s>>>(out, k, g);
  return cudaGetLastError();
}
