// K2 dense_scan: one fused pass of the dense group-by over R = B*C rows.
//
// Replaces, for scans without a time key, sybil_tpu/ops/scan.py:
// _front_end (row-in-range, the int/str/regex filters, key lanes,
// weight), _dense_gid (mixed-radix gid, MISSING = digit 0, clip, spill
// count, dead slot), _agg_row_data (lanes [w, 1, (exists, kw,
// kw*(v-bias)) x A], never materialised here) and _dense_reduce (exact
// int64 per-slot sums mod 2^64, and the per-slot min/max of the kept
// values of every histogram aggregation), over the compact [g+1] reduce
// space of _scan_dense.  When the scan has a histogram aggregation it
// also writes each row's reduce-space gid (dead rows = Sc-1) for K4.
//
// Filters: a row is matched when it is inside its block's record count
// and passes every filter.  A filter never passes on a missing value;
// int and str compares read the constant from the device array
// filter_vals (str literals are dict ids, -1 for a never-ingested one);
// re/nre read the regex bitset at clamp(v, 0, len-1); any other op never
// matches (filter.go's default).
//
// Bound: memory.  Each row is read once: 8 B value + 1 B validity per
// referenced column, plus 4 B of gid written when K4 follows.  The sums
// are tiny.  Design: a grid-stride loop, one row per thread per step,
// neighbouring threads on neighbouring rows.  Unmatched rows add nothing
// (every lane is masked by `matched`, and spills only count matched
// rows), so they are skipped.  When the [Sc, L] table of unsigned 64-bit
// sums plus the [Sc, H] min and max tables fit shared memory, each CTA
// accumulates private copies with shared atomics and merges them into
// the global tables once; otherwise the same loop updates global memory
// directly.  All lane arithmetic is unsigned 64-bit, so products and
// sums wrap mod 2^64 exactly as the reference's int64 lanes do.  Min and
// max are signed 64-bit atomics; a thread reads the current bound first
// and skips the atomic when its value cannot change it (bounds only
// move one way, so a stale read only costs an extra atomic).  Empty
// slots keep the reference's sentinels, +2^62 and -2^62.  The
// reference's byte-limb encoding (lane_limbs8) and its f32 min/max are
// TPU devices and do not apply: both give the same int64 results.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAXK = 16;
constexpr int MAXA = 32;
constexpr int MAXF = 16;
constexpr long long BIG = 1ll << 62;

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
  const long long* f_vals[MAXF];
  const unsigned char* f_valid[MAXF];
  const unsigned char* f_bits[MAXF];  // regex bitsets (re/nre) or null
  long long f_bits_len[MAXF];
  const long long* filter_vals;       // [F] filter constants, on device
  const long long* w_vals;
  const unsigned char* w_valid;
  const int* nrec;            // [B] valid records per block
  unsigned long long* sums;   // [Sc, L]
  unsigned long long* spill;  // [1]
  long long* mins;            // [Sc, H] (H = histogram aggregations)
  long long* maxs;            // [Sc, H]
  int* gid_out;               // [R] reduce-space gid, or null
  long long R;
  int f_op[MAXF];             // 0 gt, 1 lt, 2 eq, 3 neq, 4 re, 5 nre, 6 never
  int agg_mm[MAXA];           // min/max column of each agg, -1 = none
  int log2C;
  int nkeys;
  int naggs;
  int nfilters;
  int slots;
  int Sc;
  int L;
  int H;
  int has_weight;
  int pad_;
};

namespace {

__device__ __forceinline__ bool passes(const DenseScanArgs& a, int i,
                                       long long r, long long fv) {
  if (!a.f_valid[i][r]) return false;
  const long long v = a.f_vals[i][r];
  switch (a.f_op[i]) {
    case 0: return v > fv;
    case 1: return v < fv;
    case 2: return v == fv;
    case 3: return v != fv;
    case 4:
    case 5: {
      const long long n = a.f_bits_len[i];
      const long long j = v < 0 ? 0 : (v > n - 1 ? n - 1 : v);
      const bool hit = a.f_bits[i][j] != 0;
      return a.f_op[i] == 4 ? hit : !hit;
    }
    default: return false;
  }
}

template <bool SHARED>
__global__ void __launch_bounds__(THREADS) dense_scan_kernel(
    const DenseScanArgs a) {
  extern __shared__ __align__(16) unsigned long long s_tab[];
  __shared__ unsigned long long s_spill;
  __shared__ long long s_fv[MAXF];
  const int tabn = a.Sc * a.L;
  const int mmn = a.Sc * a.H;
  long long* s_min = reinterpret_cast<long long*>(s_tab + tabn);
  long long* s_max = s_min + mmn;
  if (SHARED) {
    for (int i = threadIdx.x; i < tabn; i += THREADS) s_tab[i] = 0ull;
    for (int i = threadIdx.x; i < mmn; i += THREADS) {
      s_min[i] = BIG;
      s_max[i] = -BIG;
    }
  }
  if (threadIdx.x < a.nfilters) s_fv[threadIdx.x] = a.filter_vals[threadIdx.x];
  if (threadIdx.x == 0) s_spill = 0ull;
  __syncthreads();
  unsigned long long* tab = SHARED ? s_tab : a.sums;
  long long* mins = SHARED ? s_min : a.mins;
  long long* maxs = SHARED ? s_max : a.maxs;
  unsigned long long my_spill = 0ull;
  const long long cmask = (1ll << a.log2C) - 1;

  for (long long r = (long long)blockIdx.x * THREADS + threadIdx.x;
       r < a.R; r += (long long)gridDim.x * THREADS) {
    bool matched = (r & cmask) < a.nrec[r >> a.log2C];
    for (int i = 0; matched && i < a.nfilters; ++i)
      matched = passes(a, i, r, s_fv[i]);
    if (!matched) {
      if (a.gid_out) a.gid_out[r] = a.Sc - 1;
      continue;
    }
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
    // a matched row's gid is below g <= Sc-1, the dead row
    if (a.gid_out) a.gid_out[r] = gid;
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
      if (v > a.agg_dmax[ai] || v < a.agg_dmin[ai]) continue;  // not kept
      const int mm = a.agg_mm[ai];
      if (mm >= 0) {
        long long* pmn = mins + (size_t)gid * a.H + mm;
        long long* pmx = maxs + (size_t)gid * a.H + mm;
        if (v < *(volatile long long*)pmn) atomicMin(pmn, v);
        if (v > *(volatile long long*)pmx) atomicMax(pmx, v);
      }
      if (!w) continue;
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
    for (int i = threadIdx.x; i < mmn; i += THREADS) {
      if (s_min[i] != BIG) atomicMin(a.mins + i, s_min[i]);
      if (s_max[i] != -BIG) atomicMax(a.maxs + i, s_max[i]);
    }
  }
  if (threadIdx.x == 0 && s_spill) atomicAdd(a.spill, s_spill);
}

__global__ void fill_bounds(long long* mins, long long* maxs, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    mins[i] = BIG;
    maxs[i] = -BIG;
  }
}

}  // namespace

// Zeroes sums and spill and sets the min/max tables to their sentinels
// on `stream`, then launches the shared-memory (use_shared != 0) or the
// global-atomic form.  Returns cudaError_t.
extern "C" int dense_scan(const DenseScanArgs* args, int use_shared,
                          int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t tab_bytes =
      (size_t)args->Sc * args->L * sizeof(unsigned long long);
  const size_t mm_bytes = (size_t)args->Sc * args->H * 2 * sizeof(long long);
  cudaError_t err = cudaMemsetAsync(args->sums, 0, tab_bytes, s);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(args->spill, 0, sizeof(unsigned long long), s);
  if (err != cudaSuccess) return err;
  const int mmn = args->Sc * args->H;
  if (mmn > 0) {
    fill_bounds<<<(mmn + THREADS - 1) / THREADS, THREADS, 0, s>>>(
        args->mins, args->maxs, mmn);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (use_shared) {
    const size_t shm = tab_bytes + mm_bytes;
    err = cudaFuncSetAttribute(dense_scan_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)shm);
    if (err != cudaSuccess) return err;
    dense_scan_kernel<true><<<grid, THREADS, shm, s>>>(*args);
  } else {
    dense_scan_kernel<false><<<grid, THREADS, 0, s>>>(*args);
  }
  return cudaGetLastError();
}
