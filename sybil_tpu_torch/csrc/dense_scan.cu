// K2 dense_scan: one fused pass of the dense group-by over R = B*C rows.
//
// Replaces, for scans without filters or a time key, sybil_tpu/ops/
// scan.py:_front_end (row-in-range, key lanes, weight), _dense_gid
// (mixed-radix gid, MISSING = digit 0, clip, spill count, dead slot),
// _agg_row_data (lanes [w, 1, (exists, kw, kw*(v-bias)) x A], never
// materialised here) and the plain form of _dense_reduce (exact int64
// per-slot sums mod 2^64), over the compact [g+1] reduce space of
// _scan_dense.
//
// Bound: memory.  Each row is read once: 8 B value + 1 B validity per
// referenced column (18 B/row for group-by host, avg ping).  The sums
// are tiny.  Design: a grid-stride loop, one row per thread per step,
// neighbouring threads on neighbouring rows.  Rows outside nrec add
// nothing (every lane is masked by `matched`, and spills only count
// matched rows), so they are skipped.  When the [Sc, L] table of
// unsigned 64-bit sums fits shared memory, each CTA accumulates a
// private copy with shared atomics and adds it to the global table
// once; otherwise (up to 8192 slots x many lanes) the same loop adds to
// global memory directly.  All lane arithmetic is unsigned 64-bit, so
// products and sums wrap mod 2^64 exactly as the reference's int64 lanes
// do.  The reference's byte-limb encoding (lane_limbs8) is a TPU matmul
// device and does not apply: the sums here are exact at full width.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAXK = 16;
constexpr int MAXA = 32;

}  // namespace

// Mirrored field for field by DenseScanArgs in ops/scan.py (ctypes).
struct DenseScanArgs {
  const long long* key_vals[MAXK];
  const unsigned char* key_valid[MAXK];
  long long key_min[MAXK];
  long long key_card[MAXK];
  const long long* agg_vals[MAXA];
  const unsigned char* agg_valid[MAXA];
  long long agg_dmin[MAXA];
  long long agg_dmax[MAXA];
  long long agg_bias[MAXA];
  const long long* w_vals;
  const unsigned char* w_valid;
  const int* nrec;            // [B] valid records per block
  unsigned long long* sums;   // [Sc, L]
  unsigned long long* spill;  // [1]
  long long R;
  int log2C;
  int nkeys;
  int naggs;
  int slots;
  int Sc;
  int L;
  int has_weight;
  int pad_;
};

namespace {

template <bool SHARED>
__global__ void __launch_bounds__(THREADS) dense_scan_kernel(
    const DenseScanArgs a) {
  extern __shared__ __align__(16) unsigned long long s_tab[];
  __shared__ unsigned long long s_spill;
  const int tabn = a.Sc * a.L;
  if (SHARED) {
    for (int i = threadIdx.x; i < tabn; i += THREADS) s_tab[i] = 0ull;
  }
  if (threadIdx.x == 0) s_spill = 0ull;
  __syncthreads();
  unsigned long long* tab = SHARED ? s_tab : a.sums;
  unsigned long long my_spill = 0ull;
  const long long cmask = (1ll << a.log2C) - 1;

  for (long long r = (long long)blockIdx.x * THREADS + threadIdx.x;
       r < a.R; r += (long long)gridDim.x * THREADS) {
    if ((r & cmask) >= a.nrec[r >> a.log2C]) continue;  // not matched
    int gid = 0;
    bool spilled = false;
    for (int i = 0; i < a.nkeys; ++i) {
      const long long k = a.key_valid[i][r] ? a.key_vals[i][r] : -1ll;
      const long long mn = a.key_min[i];
      const long long card = a.key_card[i];
      long long digit = 0;
      if (k != -1ll) {
        digit = (long long)((unsigned long long)k - (unsigned long long)mn
                            + 1ull);
        const long long hi =
            (long long)((unsigned long long)mn + (unsigned long long)card);
        spilled |= (k < mn) | (k >= hi);
      }
      digit = digit < 0 ? 0 : (digit > card ? card : digit);
      gid = gid * (int)(card + 1) + (int)digit;
    }
    my_spill += spilled;
    unsigned long long w = 1ull;
    if (a.has_weight && a.w_valid[r]) w = (unsigned long long)a.w_vals[r];
    unsigned long long* row = tab + (size_t)gid * a.L;
    if (w) atomicAdd(row, w);
    atomicAdd(row + 1, 1ull);
    for (int ai = 0; ai < a.naggs; ++ai) {
      if (!a.agg_valid[ai][r]) continue;
      const long long v = a.agg_vals[ai][r];
      atomicAdd(row + 2 + 3 * ai, 1ull);
      if (v > a.agg_dmax[ai] || v < a.agg_dmin[ai] || !w) continue;
      atomicAdd(row + 3 + 3 * ai, w);
      const unsigned long long kwv =
          w * ((unsigned long long)v - (unsigned long long)a.agg_bias[ai]);
      if (kwv) atomicAdd(row + 4 + 3 * ai, kwv);
    }
  }
  if (my_spill) atomicAdd(&s_spill, my_spill);
  __syncthreads();
  if (SHARED) {
    for (int i = threadIdx.x; i < tabn; i += THREADS)
      if (s_tab[i]) atomicAdd(a.sums + i, s_tab[i]);
  }
  if (threadIdx.x == 0 && s_spill) atomicAdd(a.spill, s_spill);
}

}  // namespace

// Zeroes sums and spill on `stream`, then launches the shared-memory
// (use_shared != 0) or the global-atomic form.  Returns cudaError_t.
extern "C" int dense_scan(const DenseScanArgs* args, int use_shared,
                          int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t tab_bytes =
      (size_t)args->Sc * args->L * sizeof(unsigned long long);
  cudaError_t err = cudaMemsetAsync(args->sums, 0, tab_bytes, s);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(args->spill, 0, sizeof(unsigned long long), s);
  if (err != cudaSuccess) return err;
  if (use_shared) {
    err = cudaFuncSetAttribute(dense_scan_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)tab_bytes);
    if (err != cudaSuccess) return err;
    dense_scan_kernel<true><<<grid, THREADS, tab_bytes, s>>>(*args);
  } else {
    dense_scan_kernel<false><<<grid, THREADS, 0, s>>>(*args);
  }
  return cudaGetLastError();
}
