// K4 dense_hist: per-(slot, bucket) histogram counts of one histogram
// aggregation over R = B*C rows, and its outlier mask.
//
// Replaces sybil_tpu/ops/scan.py:_hist_bucket (basic bucket ids, or the
// multihist's sub-ranges top range first, with a value that overflows its
// sub's bucket array folded into that sub's last bucket AND flagged),
// _hist_matmul and _hist_scatter (exact per-(slot, bucket) sums of the
// row weight, or of 1 without a weight column, over the compact reduce
// space) and _outlier_outputs (the mask of kept, in-range rows whose
// bucket overflowed, their values, and their count).
//
// Inputs: the reduce-space gid of every row from K2 (dead = Sc-1, which
// only unmatched rows take), the aggregation's values and validity, and
// the weight column.  A row contributes when it is kept (matched,
// populated, inside the discard bounds) and falls in a bucket range.
// Bucket ids use C++ signed division, which truncates toward zero like
// the reference's _trunc_div (Go's `/`); the basic layout never has a
// zero bucket size, and the multihist divides only by its subs' sizes.
// With d = v - min (64-bit, wrapping) and span = nv * bucket size: d < 0
// is bucket 0, d >= span overflows into bucket nv-1, and only the rows in
// between divide, by 32-bit unsigned division when the span fits 32 bits
// (64-bit division is a long software sequence) and not at all when the
// bucket size is 1.
//
// Bound: memory.  Per row it reads a 4 B gid, 9 B of value and validity
// and 9 B of weight when there is a weight column, and writes 9 B of
// outlier mask and value when outliers are tracked.  The TPU forms (a
// bf16 one-hot matmul, 4-bit limb scatters) work around slow TPU
// scatters; here the counts are exact unsigned 64-bit sums (wrapping mod
// 2^64 like the reference's int64 sums).
//
// What a trace of the former design showed (PERF.md §6, K4's and K13's
// redesign): a grid-stride loop of 256-thread CTAs, one row a thread a
// step, whose every counted row made a 64-bit shared atomicAdd (a CAS
// spin loop, ATOMS.CAST.SPIN.64, on sm_90a), each CTA zeroing and
// flushing its whole [Sc, nv] table; two memsets and the kernel a call.
//
// Design (K2's tile, dense_scan.cu): one CTA of TT threads a SM.  A warp
// takes tiles of 32 x TU rows by a grid stride (rows lane + 32u, so every
// load and store is coalesced) and loads a tile's gids, values, validity
// and weights together; then each row finds its bucket, writes its
// outlier words and adds itself.  The weight column is a template
// parameter.  The table, by size (the wrapper's choice, ops/scan.py
// dense_hist_path; both give the same counts):
//   shared  one table a CTA in shared memory, of the Sc-1 live slots (the
//           dead slot never counts) in narrow words: a count is one
//           32-bit word (fewer than 2^31 rows), a weight sum two (lo, hi)
//           added by native 32-bit atomics with the carry taken from the
//           old low word, so nothing spins; the CTA adds its table's
//           non-zero entries to the global counts once;
//   global  the global counts directly, a warp's rows on one (gid,
//           bucket) combined first (__match_any_sync; a count by
//           popcount, a weight sum by shuffles), since the 64-bit global
//           adds of a few hot buckets pile onto the same words.
// The outlier count follows the counts in one buffer, so one memset
// zeroes both.  Tried and dropped on the H100 (the same PERF.md entry): a
// table a warp where the CTA's 32 fit, as K2 has (config 3 0.0437-0.0439
// ms against 0.0427 for one a CTA), 2 and 8 rows a lane (8 spills), the
// next tile's loads in flight during this one's adds (-loghist
// 0.0810-0.0820 against 0.0747-0.0760), streaming stores of the outlier
// words.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TT = 1024;     // threads of the one CTA a SM
constexpr int TU = 4;        // rows a lane a tile: 32 x TU rows a warp
constexpr int MAXSUB = 64;
constexpr unsigned FULL = 0xffffffffu;

}  // namespace

// Mirrored field for field by DenseHistArgs in ops/scan.py (ctypes).
struct DenseHistArgs {
  const int* gid;               // [R] from K2
  const long long* vals;        // [R]
  const unsigned char* valid;   // [R]
  const long long* w_vals;      // [R] or null
  const unsigned char* w_valid;
  unsigned long long* counts;   // [Sc * nv], then the outlier count
  unsigned char* out_mask;      // [R] or null (no outlier tracking)
  long long* out_val;           // [R] or null
  unsigned long long* paths;    // [3] CTAs of each table mode, or null
  long long sub_min[MAXSUB];
  long long sub_max[MAXSUB];
  long long sub_bs[MAXSUB];
  unsigned long long sub_span[MAXSUB];  // sub_nv * sub_bs, at most 2^63
  long long sub_nv[MAXSUB];
  long long sub_off[MAXSUB];
  long long R;
  long long hist_min;
  long long bucket_size;
  unsigned long long span;      // nv * bucket_size, at most 2^63
  long long dmin;
  long long dmax;
  int nv;
  int nsub;                     // 0 = basic layout
  int Sc;
  int has_weight;
};

namespace {

// The bucket of d = v - min among nv buckets of size bs (span = nv * bs,
// at most 2^63): 0 below, nv-1 and *out past the span.
__device__ __forceinline__ long long bucket_of(long long d, long long bs,
                                               long long nv,
                                               unsigned long long span,
                                               bool* out) {
  *out = false;
  if (d < 0) return 0;
  if ((unsigned long long)d >= span) {
    *out = true;
    return nv - 1;
  }
  if (bs == 1) return d;
  if (span <= 0xffffffffull) return (unsigned)d / (unsigned)bs;
  return d / bs;
}

// x summed over the lanes of `peers` (this lane's group), a pairwise tree
// in the order of the lanes; the result is valid at the group's lowest
// lane.  Every lane of the warp calls it.
__device__ __forceinline__ unsigned long long sum_peers(unsigned peers,
                                                        unsigned long long x) {
  const int lane = threadIdx.x & 31;
  int rel = __popc(peers & ((1u << lane) - 1u));
  unsigned rest = peers & (0xfffffffeu << lane);
  while (__any_sync(FULL, rest)) {
    const int next = __ffs(rest);
    const unsigned long long t = __shfl_sync(FULL, x, next ? next - 1 : lane);
    if (next) x += t;
    rest &= ~__ballot_sync(FULL, rel & 1);
    rel >>= 1;
  }
  return x;
}

// A 64-bit add to two 32-bit shared words (lo, hi), the carry taken from
// the old low word: two native atomics, no spin.
__device__ __forceinline__ void add64(unsigned* p, unsigned long long x) {
  const unsigned lo = (unsigned)x;
  unsigned hi = (unsigned)(x >> 32);
  if (lo) {
    const unsigned old = atomicAdd(p, lo);
    hi += (unsigned)(old + lo < old);
  }
  if (hi) atomicAdd(p + 1, hi);
}

// The table a row adds to (the C entry's `mode`): the CTA's shared
// table, or the global counts.
enum { M_SHARED, M_GLOBAL };

// A tile's rows as loaded: gid (dead past R), value, validity and, with a
// weight column (W), the row weight (1 where the weight is missing).
template <bool W>
struct Rows {
  int g[TU];
  long long v[TU];
  bool ok[TU];
  long long w[W ? TU : 1];
};

template <bool W>
__device__ __forceinline__ void load_rows(const DenseHistArgs& a, long long r,
                                          Rows<W>& t) {
  long long wx[TU];
  bool wok[TU];
#pragma unroll
  for (int u = 0; u < TU; ++u) {
    const long long ru = r + 32 * u;
    const bool in = ru < a.R;
    t.g[u] = in ? a.gid[ru] : a.Sc - 1;
    t.v[u] = in ? a.vals[ru] : 0;
    t.ok[u] = in ? a.valid[ru] != 0 : false;
    if (W) {
      wx[u] = in ? a.w_vals[ru] : 1;
      wok[u] = in ? a.w_valid[ru] != 0 : false;
    }
  }
  if (W) {
#pragma unroll
    for (int u = 0; u < TU; ++u) t.w[u] = wok[u] ? wx[u] : 1;
  }
}

// The entry g * nv + bucket of a row (-1 when it does not count) and
// whether its bucket overflowed (*out).
__device__ __forceinline__ int entry_of(const DenseHistArgs& a, int g,
                                        long long v, bool ok, bool* out) {
  bool contrib = g != a.Sc - 1 && ok && !(v > a.dmax || v < a.dmin);
  long long bv = 0;
  *out = false;
  if (a.nsub == 0) {
    bv = bucket_of((long long)((unsigned long long)v -
                               (unsigned long long)a.hist_min),
                   a.bucket_size, a.nv, a.span, out);
  } else {
    bool assigned = false;
    for (int i = 0; i < a.nsub; ++i) {
      if (v < a.sub_min[i] || v > a.sub_max[i]) continue;
      bv = bucket_of((long long)((unsigned long long)v -
                                 (unsigned long long)a.sub_min[i]),
                     a.sub_bs[i], a.sub_nv[i], a.sub_span[i], out) +
           a.sub_off[i];
      assigned = true;
      break;
    }
    contrib = contrib && assigned;
  }
  *out = *out && contrib;
  return contrib ? g * a.nv + (int)bv : -1;
}

template <int MODE, bool W>
__global__ void __launch_bounds__(TT, 1) hist_tiles(const DenseHistArgs a) {
  extern __shared__ __align__(16) unsigned tab[];     // [live * wpe]
  __shared__ unsigned s_nout;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wpe = W ? 2 : 1;                           // words an entry
  const int live = MODE == M_SHARED ? (a.Sc - 1) * a.nv : 0;
  for (int i = threadIdx.x; i < live * wpe; i += TT) tab[i] = 0u;
  if (threadIdx.x == 0) s_nout = 0u;
  __syncthreads();
  const bool track = a.out_mask != nullptr;
  unsigned my_nout = 0u;

  const long long step = (long long)gridDim.x * TT * TU;
  for (long long r0 = ((long long)blockIdx.x * (TT / 32) + warp) * (32 * TU);
       r0 < a.R; r0 += step) {
    Rows<W> cur;
    load_rows<W>(a, r0 + lane, cur);
#pragma unroll
    for (int u = 0; u < TU; ++u) {
      const long long ru = r0 + lane + 32 * u;
      bool o;
      const int e = entry_of(a, cur.g[u], cur.v[u], cur.ok[u], &o);
      if (track) {
        if (ru < a.R) {
          a.out_mask[ru] = o;
          a.out_val[ru] = o ? cur.v[u] : 0ll;
        }
        my_nout += o;
      }
      const unsigned long long w = W ? (unsigned long long)cur.w[u] : 1ull;
      if (MODE == M_GLOBAL) {
        const unsigned lm = __ballot_sync(FULL, e >= 0);
        if (!lm) continue;
        // a row that adds nothing is a group of its own and takes no part
        // in the match
        unsigned peers = 1u << lane;
        if (e >= 0) peers = __match_any_sync(lm, e);
        const unsigned long long sum =
            W ? sum_peers(peers, e >= 0 ? w : 0ull)
              : (unsigned long long)__popc(peers);
        if (e >= 0 && lane == __ffs(peers) - 1 && sum)
          atomicAdd(a.counts + e, sum);
      } else if (e >= 0) {
        if (W)
          add64(tab + 2 * e, w);
        else
          atomicAdd(tab + e, 1u);
      }
    }
  }
  if (track) {
    my_nout = __reduce_add_sync(FULL, my_nout);
    if (lane == 0 && my_nout) atomicAdd(&s_nout, my_nout);
  }
  __syncthreads();
  // the shared table's non-zero entries to the global counts
  for (int i = threadIdx.x; i < live; i += TT) {
    const unsigned* p = tab + (size_t)i * wpe;
    const unsigned long long x =
        W ? ((unsigned long long)p[0] | ((unsigned long long)p[1] << 32))
          : (unsigned long long)p[0];
    if (x) atomicAdd(a.counts + i, x);
  }
  if (threadIdx.x == 0) {
    if (s_nout)
      atomicAdd(a.counts + (size_t)a.Sc * a.nv, (unsigned long long)s_nout);
    if (a.paths) atomicAdd(a.paths + MODE, 1ull);
  }
}

template <int MODE, bool W>
cudaError_t launch(const DenseHistArgs& a, int grid, size_t shm,
                   cudaStream_t s) {
  if (MODE != M_GLOBAL) {
    const cudaError_t err = cudaFuncSetAttribute(
        hist_tiles<MODE, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shm);
    if (err != cudaSuccess) return err;
  }
  hist_tiles<MODE, W><<<grid, TT, shm, s>>>(a);
  return cudaGetLastError();
}

template <bool W>
cudaError_t launch_mode(const DenseHistArgs& a, int mode, int grid,
                        size_t shm, cudaStream_t s) {
  switch (mode) {
    case M_SHARED: return launch<M_SHARED, W>(a, grid, shm, s);
    case M_GLOBAL: return launch<M_GLOBAL, W>(a, grid, 0, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Zeroes the counts (and the outlier count after them, when tracked) with
// one memset on `stream`, then one launch of `grid` CTAs of TT threads:
// mode 0 a shared table a CTA, 1 the global counts.  Takes fewer than
// 2^31 rows and Sc * nv below 2^31.  Returns cudaError_t.
extern "C" int dense_hist(const DenseHistArgs* args, int mode, int grid,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DenseHistArgs& a = *args;
  const long long n = (long long)a.Sc * a.nv;
  if (a.R >= (1ll << 31) || a.Sc < 1 || a.nv < 1 || n >= (1ll << 31) ||
      a.nsub < 0 || a.nsub > MAXSUB || grid < 1 ||
      (a.out_mask != nullptr) != (a.out_val != nullptr))
    return cudaErrorInvalidValue;
  const bool track = a.out_mask != nullptr;
  cudaError_t err = cudaMemsetAsync(
      a.counts, 0, (size_t)(n + (track ? 1 : 0)) * sizeof(long long), s);
  if (err != cudaSuccess) return err;
  const size_t shm = (size_t)(a.Sc - 1) * a.nv * (a.has_weight ? 2 : 1) *
                     sizeof(unsigned);
  return a.has_weight ? launch_mode<true>(a, mode, grid, shm, s)
                      : launch_mode<false>(a, mode, grid, shm, s);
}
