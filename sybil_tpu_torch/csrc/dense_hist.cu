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
//
// Bound: memory.  Per row it reads a 4 B gid, 9 B of value and validity
// and 9 B of weight when there is a weight column, and writes 9 B of
// outlier mask and value when outliers are tracked.  The TPU forms (a
// bf16 one-hot matmul, 4-bit limb scatters) work around slow TPU
// scatters; Hopper has 64-bit shared and global atomics, so the counts
// are exact unsigned 64-bit adds (wrapping mod 2^64 like the reference's
// int64 sums).  Design: a grid-stride loop, one row per thread per step;
// each CTA keeps a private [Sc, nv] table in shared memory when it fits
// and merges its non-zero entries into the global table once, otherwise
// the loop adds to the global table directly.  The outlier count is a
// per-thread count, summed per CTA in shared memory, then one global add.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAXSUB = 64;

}  // namespace

// Mirrored field for field by DenseHistArgs in ops/scan.py (ctypes).
struct DenseHistArgs {
  const int* gid;               // [R] from K2
  const long long* vals;        // [R]
  const unsigned char* valid;   // [R]
  const long long* w_vals;      // [R] or null
  const unsigned char* w_valid;
  unsigned long long* counts;   // [Sc, nv]
  unsigned char* out_mask;      // [R] or null (no outlier tracking)
  long long* out_val;           // [R] or null
  unsigned long long* nout;     // [1] or null
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
  int nv;
  int nsub;                     // 0 = basic layout
  int Sc;
  int has_weight;
};

namespace {

template <bool SHARED>
__global__ void __launch_bounds__(THREADS) dense_hist_kernel(
    const DenseHistArgs a) {
  extern __shared__ __align__(16) unsigned long long s_tab[];
  __shared__ unsigned long long s_nout;
  const int tabn = a.Sc * a.nv;
  if (SHARED) {
    for (int i = threadIdx.x; i < tabn; i += THREADS) s_tab[i] = 0ull;
  }
  if (threadIdx.x == 0) s_nout = 0ull;
  __syncthreads();
  unsigned long long* tab = SHARED ? s_tab : a.counts;
  unsigned long long my_nout = 0ull;
  const int dead = a.Sc - 1;

  for (long long r = (long long)blockIdx.x * THREADS + threadIdx.x;
       r < a.R; r += (long long)gridDim.x * THREADS) {
    const int g = a.gid[r];
    bool contrib = g != dead && a.valid[r];
    const long long v = a.vals[r];
    contrib = contrib && !(v > a.dmax || v < a.dmin);
    bool is_out = false;
    int bv = 0;
    if (contrib) {
      if (a.nsub == 0) {
        const long long raw =
            (long long)((unsigned long long)v - (unsigned long long)a.hist_min)
            / a.bucket_size;
        is_out = raw >= a.nv;
        bv = (int)(raw < 0 ? 0 : (raw > a.nv - 1 ? a.nv - 1 : raw));
      } else {
        bool assigned = false;
        for (int i = 0; i < a.nsub; ++i) {
          if (v < a.sub_min[i] || v > a.sub_max[i]) continue;
          const long long raw =
              (long long)((unsigned long long)v
                          - (unsigned long long)a.sub_min[i]) / a.sub_bs[i];
          const long long snv = a.sub_nv[i];
          is_out = raw >= snv;
          bv = (int)((raw < 0 ? 0 : (raw > snv - 1 ? snv - 1 : raw))
                     + a.sub_off[i]);
          assigned = true;
          break;
        }
        contrib = assigned;
      }
    }
    if (contrib) {
      unsigned long long w = 1ull;
      if (a.has_weight && a.w_valid[r]) w = (unsigned long long)a.w_vals[r];
      if (w) atomicAdd(tab + (size_t)g * a.nv + bv, w);
    }
    if (a.out_mask) {
      const bool o = contrib && is_out;
      a.out_mask[r] = o;
      a.out_val[r] = o ? v : 0ll;
      my_nout += o;
    }
  }
  if (my_nout) atomicAdd(&s_nout, my_nout);
  __syncthreads();
  if (SHARED) {
    for (int i = threadIdx.x; i < tabn; i += THREADS)
      if (s_tab[i]) atomicAdd(a.counts + i, s_tab[i]);
  }
  if (threadIdx.x == 0 && a.nout && s_nout) atomicAdd(a.nout, s_nout);
}

}  // namespace

// Zeroes the counts (and the outlier count) on `stream`, then launches
// the shared-memory (use_shared != 0) or the global-atomic form.
// Returns cudaError_t.
extern "C" int dense_hist(const DenseHistArgs* args, int use_shared, int grid,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t tab_bytes =
      (size_t)args->Sc * args->nv * sizeof(unsigned long long);
  cudaError_t err = cudaMemsetAsync(args->counts, 0, tab_bytes, s);
  if (err != cudaSuccess) return err;
  if (args->nout) {
    err = cudaMemsetAsync(args->nout, 0, sizeof(unsigned long long), s);
    if (err != cudaSuccess) return err;
  }
  if (use_shared) {
    err = cudaFuncSetAttribute(dense_hist_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)tab_bytes);
    if (err != cudaSuccess) return err;
    dense_hist_kernel<true><<<grid, THREADS, tab_bytes, s>>>(*args);
  } else {
    dense_hist_kernel<false><<<grid, THREADS, 0, s>>>(*args);
  }
  return cudaGetLastError();
}
