// K2 dense_scan: one fused pass of the dense group-by over R = B*C rows.
//
// Replaces sybil_tpu/ops/scan.py: _front_end (row-in-range, the
// int/str/regex filters, the time key, key lanes, weight), _dense_gid
// (mixed-radix gid, MISSING = digit 0, the time digit, clip, spill
// count, dead slot), _agg_row_data (lanes [w, 1, (exists, kw,
// kw*(v-bias)) x A], never materialised here) and _dense_reduce (exact
// int64 per-slot sums mod 2^64, and the per-slot min/max of the kept
// values of every histogram aggregation), plain over the reduce space
// of _scan_dense or in its windowed form.  When the scan has a
// histogram aggregation it also writes each row's reduce-space gid
// (dead rows = Sc-1) for K4.
//
// Filters: a row is matched when it is inside its block's record count
// and passes every filter.  A filter never passes on a missing value;
// int and str compares read the constant from the device array
// filter_vals (str literals are dict ids, -1 for a never-ingested one);
// re/nre read the regex bitset at clamp(v, 0, len-1); a set filter
// (_front_end's set-CSR branch, 376-381) reads K14's two row bitmasks,
// `has` and `hit`: in passes on has & hit, nin on has & ~hit (a set
// column has no validity lane, so the op is read first); any other op
// never matches (filter.go's default).
//
// The matched mask (a samples query, want_matched_mask; _scan_dense
// 1062-1063): one byte a row of [0, R), the front end's `matched` (in
// range, every filter, the time column present under a rollup), written
// before a row is dropped, so a matched row whose key spilled into the
// dead slot is still 1.  MASK is a template parameter, like TIME.
//
// Cache-group key (a query-cache group scan, vg_span > 0; _front_end's
// cg_key, 405-411, 424-428): key 0 is each row's block position over the
// group span, (r >> log2C) / vg_span, made here from the row index with
// no column read (the reference's iota: no key column is uploaded).  The
// span is a power of two (the cache's 16 blocks), so the division is one
// shift by a loop-invariant count.  Its
// digit is cg - min + 1 like any key's, never MISSING.  Under a time
// rollup it leads the time key (vg_first), so a chunk of rows, which
// lies in one block, still spans one narrow band of gids and the
// windowed form applies unchanged.  CG is a template parameter, like
// TIME: the scans without it run the code they ran before.
//
// Time key (a rollup): a row without the time column is unmatched.  The
// key's digit is q - min + 1 with q = trunc_div(t, tb), Go's division
// (the reference's _trunc_div: floor of |t| / tb, negated for t < 0);
// the row spills when q falls outside [min, min + card).  When the bind
// proved the column and the bucket fit int32 (time_i32), q and the
// digit are int32 arithmetic like the reference's, which is also the
// fast form here: 64-bit division is a long software sequence.
//
// Bound: memory.  Each row is read once: 8 B value + 1 B validity per
// referenced column, plus 4 B of gid written when K4 follows.  The sums
// are tiny.  All lane arithmetic is unsigned 64-bit, so products and
// sums wrap mod 2^64 exactly as the reference's int64 lanes do.  Min and
// max are signed 64-bit atomics; a thread reads the current bound first
// and skips the atomic when its value cannot change it (bounds only
// move one way, so a stale read only costs an extra atomic).  Empty
// slots keep the reference's sentinels, +2^62 and -2^62.  Unmatched
// rows add nothing (every lane is masked by `matched`, and spills only
// count matched rows), so they are skipped.  The reference's byte-limb
// encoding (lane_limbs8), f32 min/max and one-hot matmuls are TPU
// devices and do not apply: all give the same int64 results.  Three
// forms, the same words:
//   shared   a grid-stride loop, one row per thread per step; each CTA
//            accumulates private copies of the [Sc, L] sums and [Sc, H]
//            min/max tables in shared memory and merges them into the
//            global tables once (tables up to 200 KB);
//   global   the same loop updating the global tables directly;
//   windowed a rollup's table is often larger than a CTA's shared
//            memory (config 4: 6,784 slots x 5 lanes = 271 KB), but a
//            chunk of rows spans a narrow band of it, since digestion
//            time-sorts rows and the time key is the most significant
//            digit.  Each CTA takes whole chunks of `chunk` rows: it
//            computes every row's gid into shared memory and the
//            chunk's live-gid span [lo, hi] with a block reduce, then
//            sweeps the span in bands of `band` slots (the reference's
//            while_loop over [window, ch] bands): zero a shared [band,
//            L + 2H] table, add the chunk's rows whose gid falls in the
//            band, flush its non-empty entries to the global tables
//            with 64-bit atomics.  A time-sorted chunk needs one band;
//            a chunk of an unsorted table sweeps as many as its span
//            needs.  Each row's lanes are read once, in its band.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "desc.cuh"
#include "filters.cuh"

namespace {

constexpr int THREADS = 256;
constexpr long long BIG = 1ll << 62;
constexpr int FV_SMEM = 16;  // filter constants staged in shared memory

}  // namespace

// Mirrored field for field by DenseScanArgs in ops/scan.py (ctypes).  The
// per-key, per-aggregation and per-filter arrays point into the
// descriptor block (desc.cuh), so the counts of keys, aggregations and
// filters have no fixed cap.
struct DenseScanArgs {
  Desc desc;
  const long long* const* key_vals;   // [nkeys] [cg?, time?, *groups];
                                      // cg's and time's unused
  const unsigned char* const* key_valid;
  const long long* key_min;           // [nkeys]
  const long long* key_card;
  const long long* const* agg_vals;   // [naggs]
  const unsigned char* const* agg_valid;
  const long long* agg_dmin;
  const long long* agg_dmax;
  const long long* agg_bias;
  const long long* agg_mm;            // min/max column of each agg, -1 = none
  const long long* const* f_vals;     // [nfilters]; set ops: K14's hit
  const unsigned char* const* f_valid;  // set ops: K14's has
  const unsigned char* const* f_bits; // regex bitsets (re/nre) or null
  const long long* f_bits_len;
  // 0 gt, 1 lt, 2 eq, 3 neq, 4 re, 5 nre, 6 never, 7 set in, 8 set nin
  const long long* f_op;
  const long long* filter_vals;       // [nfilters] filter constants
  const long long* w_vals;
  const unsigned char* w_valid;
  const long long* t_vals;            // time column (has_time)
  const unsigned char* t_valid;
  const int* nrec;            // [B] valid records per block
  unsigned long long* sums;   // [Sc, L]
  unsigned long long* spill;  // [1]
  long long* mins;            // [Sc, H] (H = histogram aggregations)
  long long* maxs;            // [Sc, H]
  int* gid_out;               // [R] reduce-space gid, or null
  unsigned char* mask;        // [R] matched rows (MASK), or null
  long long R;
  long long tb;               // time bucket (> 0)
  int log2C;
  int nkeys;                  // key digits, the time key included
  int naggs;
  int nfilters;
  int slots;
  int Sc;
  int L;
  int H;
  int has_weight;
  int has_time;               // the time key follows the cg key, if any
  int time_i32;
  int band;                   // windowed form: band width in slots
  int chunk;                  // windowed form: rows per chunk
  int vg_span;                // > 0: key 0 is the cache-group key
};

namespace {

// The reference's _trunc_div for d > 0, in the width of T: q = |x| // d
// (floor division; |x| wraps at T's minimum as jnp.abs does), then
// x >= 0 ? q : -q, wrapping.
template <typename T, typename U>
__device__ __forceinline__ T go_trunc_div(T x, T d) {
  const T ax = x < 0 ? static_cast<T>(U(0) - static_cast<U>(x)) : x;
  T q = ax / d;
  if (ax < 0 && q * d != ax) --q;  // floor for the one negative |x|
  return x >= 0 ? q : static_cast<T>(U(0) - static_cast<U>(q));
}

// Row r's match and reduce-space gid (s_fv: the first FV_SMEM filter
// constants).  Returns false for an unmatched row (gid and spill
// untouched).  CG (key 0 is the cache-group key) and TIME (the time key
// comes next) are template parameters and their digits are peeled off
// the key loop: a branch on the time key inside the loop made K2 a third
// slower or more on scans without one (sybil_tpu_torch/k2_ab.py on the
// H100).  So is HEAD, where the descriptor block lies (desc.cuh).
template <bool CG, bool TIME, bool HEAD>
__device__ __forceinline__ bool row_gid(const DenseScanArgs& a, long long r,
                                        const long long* s_fv, int* gid_out,
                                        bool* spill_out) {
  const long long cmask = (1ll << a.log2C) - 1;
  bool matched = (r & cmask) < a.nrec[r >> a.log2C];
  // the staged constants first, the rest (past FV_SMEM) from global
  const int nfs = min(a.nfilters, FV_SMEM);
  for (int i = 0; matched && i < nfs; ++i)
    matched = passes<HEAD>(a, i, r, s_fv[i]);
  for (int i = FV_SMEM; matched && i < a.nfilters; ++i)
    matched = passes<HEAD>(a, i, r, a.filter_vals[i]);
  if (TIME && matched) matched = a.t_valid[r] != 0;
  if (!matched) return false;
  int gid = 0;
  bool spilled = false;
  int first = 0;
  if (CG) {
    const long long k = r >> (a.log2C + __ffs(a.vg_span) - 1);
    const long long mn = desc_at<HEAD>(a.desc, a.key_min, 0);
    const long long card = desc_at<HEAD>(a.desc, a.key_card, 0);
    const long long digit =
        (long long)((unsigned long long)k - (unsigned long long)mn + 1ull);
    spilled = (k < mn) |
              (k >= (long long)((unsigned long long)mn +
                                (unsigned long long)card));
    gid = (int)(digit < 0 ? 0 : (digit > card ? card : digit));
    first = 1;
  }
  if (TIME) {
    const long long mn = desc_at<HEAD>(a.desc, a.key_min, first);
    const long long card = desc_at<HEAD>(a.desc, a.key_card, first);
    const long long t = a.t_vals[r];
    long long q, digit;
    if (a.time_i32) {
      const int q32 = go_trunc_div<int, unsigned>(static_cast<int>(t),
                                                  static_cast<int>(a.tb));
      q = q32;
      // int32 like the reference's digit q - mn + 1
      digit = static_cast<int>(static_cast<unsigned>(q32) -
                               static_cast<unsigned>(mn) + 1u);
    } else {
      q = go_trunc_div<long long, unsigned long long>(t, a.tb);
      digit = (long long)((unsigned long long)q - (unsigned long long)mn +
                          1ull);
    }
    spilled |= (q < mn) | (q >= mn + card);
    gid = gid * (int)(card + 1) +
          (int)(digit < 0 ? 0 : (digit > card ? card : digit));
    ++first;
  }
  for (int i = first; i < a.nkeys; ++i) {
    const long long k = desc_at<HEAD>(a.desc, a.key_valid, i)[r]
                            ? desc_at<HEAD>(a.desc, a.key_vals, i)[r] : -1ll;
    const long long mn = desc_at<HEAD>(a.desc, a.key_min, i);
    const long long card = desc_at<HEAD>(a.desc, a.key_card, i);
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
  *gid_out = gid;
  *spill_out = spilled;
  return true;
}

// Adds matched row r's lanes to `row` ([L] sums) and its kept values to
// `mn`/`mx` ([H] min and max) of its slot.
template <bool HEAD>
__device__ __forceinline__ void accumulate(const DenseScanArgs& a,
                                           long long r,
                                           unsigned long long* row,
                                           long long* mn, long long* mx) {
  unsigned long long w = 1ull;
  if (a.has_weight && a.w_valid[r]) w = (unsigned long long)a.w_vals[r];
  if (w) atomicAdd(row, w);
  atomicAdd(row + 1, 1ull);
  for (int ai = 0; ai < a.naggs; ++ai) {
    if (!desc_at<HEAD>(a.desc, a.agg_valid, ai)[r]) continue;
    const long long v = desc_at<HEAD>(a.desc, a.agg_vals, ai)[r];
    atomicAdd(row + 2 + 3 * ai, 1ull);
    if (v > desc_at<HEAD>(a.desc, a.agg_dmax, ai) ||
        v < desc_at<HEAD>(a.desc, a.agg_dmin, ai))
      continue;  // not kept
    const int mm = (int)desc_at<HEAD>(a.desc, a.agg_mm, ai);
    if (mm >= 0) {
      if (v < *(volatile long long*)(mn + mm)) atomicMin(mn + mm, v);
      if (v > *(volatile long long*)(mx + mm)) atomicMax(mx + mm, v);
    }
    if (!w) continue;
    atomicAdd(row + 3 + 3 * ai, w);
    const unsigned long long kwv =
        w * ((unsigned long long)v -
             (unsigned long long)desc_at<HEAD>(a.desc, a.agg_bias, ai));
    if (kwv) atomicAdd(row + 4 + 3 * ai, kwv);
  }
}

// At most 32 registers a thread, so the 8 CTAs a SM that the wrapper's
// grid assumes fit: left free, the descriptor offsets hoisted out of the
// row loop took 48, 5 CTAs fit, and K2 ran 19% (config 1's shape) and
// 63% (config 3's) slower, a second wave included (k2_ab.py on the H100).
template <bool SHARED, bool CG, bool TIME, bool HEAD, bool MASK>
__global__ void __launch_bounds__(THREADS, 8) dense_scan_kernel(
    const DenseScanArgs a) {
  extern __shared__ __align__(16) unsigned long long s_tab[];
  __shared__ unsigned long long s_spill;
  __shared__ long long s_fv[FV_SMEM];
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
  if (threadIdx.x < min(a.nfilters, FV_SMEM))
    s_fv[threadIdx.x] = a.filter_vals[threadIdx.x];
  if (threadIdx.x == 0) s_spill = 0ull;
  __syncthreads();
  unsigned long long* tab = SHARED ? s_tab : a.sums;
  long long* mins = SHARED ? s_min : a.mins;
  long long* maxs = SHARED ? s_max : a.maxs;
  unsigned long long my_spill = 0ull;

  for (long long r = (long long)blockIdx.x * THREADS + threadIdx.x;
       r < a.R; r += (long long)gridDim.x * THREADS) {
    int gid;
    bool spilled;
    const bool matched =
        row_gid<CG, TIME, HEAD>(a, r, s_fv, &gid, &spilled);
    if (MASK) a.mask[r] = matched;
    if (!matched) {
      if (a.gid_out) a.gid_out[r] = a.Sc - 1;
      continue;
    }
    if (a.gid_out) a.gid_out[r] = gid;
    my_spill += spilled;
    accumulate<HEAD>(a, r, tab + (size_t)gid * a.L,
                     mins + (size_t)gid * a.H, maxs + (size_t)gid * a.H);
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

template <bool CG, bool TIME, bool HEAD, bool MASK>
__global__ void __launch_bounds__(THREADS) dense_scan_windowed(
    const DenseScanArgs a) {
  extern __shared__ __align__(16) unsigned long long s_band[];
  __shared__ unsigned long long s_spill;
  __shared__ long long s_fv[FV_SMEM];
  __shared__ int s_lo, s_hi;
  const int band = a.band, chunk = a.chunk, L = a.L, H = a.H;
  const int dead = a.Sc - 1;
  long long* s_min = reinterpret_cast<long long*>(s_band + band * L);
  long long* s_max = s_min + band * H;
  int* s_gid = reinterpret_cast<int*>(s_max + band * H);
  if (threadIdx.x < min(a.nfilters, FV_SMEM))
    s_fv[threadIdx.x] = a.filter_vals[threadIdx.x];
  if (threadIdx.x == 0) s_spill = 0ull;
  unsigned long long my_spill = 0ull;
  const long long nchunks = a.R / chunk;

  for (long long c = blockIdx.x; c < nchunks; c += gridDim.x) {
    const long long r0 = c * chunk;
    if (threadIdx.x == 0) {
      s_lo = INT_MAX;
      s_hi = -1;
    }
    __syncthreads();  // also: s_fv loaded, the last chunk's flush done
    int lo = INT_MAX, hi = -1;
    for (int i = threadIdx.x; i < chunk; i += THREADS) {
      int gid;
      bool spilled;
      const bool matched =
          row_gid<CG, TIME, HEAD>(a, r0 + i, s_fv, &gid, &spilled);
      if (MASK) a.mask[r0 + i] = matched;
      if (matched) {
        my_spill += spilled;
        lo = min(lo, gid);
        hi = max(hi, gid);
      } else {
        gid = dead;
      }
      s_gid[i] = gid;
      if (a.gid_out) a.gid_out[r0 + i] = gid;
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if ((threadIdx.x & 31) == 0) {
      atomicMin(&s_lo, lo);
      atomicMax(&s_hi, hi);
    }
    __syncthreads();
    const int clo = s_lo, chi = s_hi;  // no live row: clo > chi, no band
    for (int b0 = clo; b0 <= chi; b0 += band) {
      for (int i = threadIdx.x; i < band * L; i += THREADS) s_band[i] = 0ull;
      for (int i = threadIdx.x; i < band * H; i += THREADS) {
        s_min[i] = BIG;
        s_max[i] = -BIG;
      }
      __syncthreads();
      for (int i = threadIdx.x; i < chunk; i += THREADS) {
        const int g = s_gid[i];
        if (g < b0 || g >= b0 + band || g == dead) continue;
        const int o = g - b0;
        accumulate<HEAD>(a, r0 + i, s_band + (size_t)o * L,
                         s_min + (size_t)o * H, s_max + (size_t)o * H);
      }
      __syncthreads();
      const int nrows = min(band, a.Sc - b0);
      unsigned long long* g_sums = a.sums + (size_t)b0 * L;
      for (int i = threadIdx.x; i < nrows * L; i += THREADS)
        if (s_band[i]) atomicAdd(g_sums + i, s_band[i]);
      for (int i = threadIdx.x; i < nrows * H; i += THREADS) {
        if (s_min[i] != BIG) atomicMin(a.mins + (size_t)b0 * H + i, s_min[i]);
        if (s_max[i] != -BIG) atomicMax(a.maxs + (size_t)b0 * H + i, s_max[i]);
      }
      __syncthreads();  // the band is free again
    }
    __syncthreads();  // every thread has read s_lo and s_hi
  }
  if (my_spill) atomicAdd(&s_spill, my_spill);
  __syncthreads();
  if (threadIdx.x == 0 && s_spill) atomicAdd(a.spill, s_spill);
}

__global__ void fill_bounds(long long* mins, long long* maxs, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    mins[i] = BIG;
    maxs[i] = -BIG;
  }
}

template <bool CG, bool TIME, bool HEAD, bool MASK>
cudaError_t launch_form(const DenseScanArgs* args, int form, int grid,
                        size_t tab_bytes, size_t mm_bytes, cudaStream_t s) {
  cudaError_t err;
  if (form == 2) {
    if (args->band <= 0 || args->chunk <= 0 || args->R % args->chunk)
      return cudaErrorInvalidValue;
    const size_t shm = (size_t)args->band * (args->L + 2 * args->H) * 8 +
                       (size_t)args->chunk * sizeof(int);
    err = cudaFuncSetAttribute(dense_scan_windowed<CG, TIME, HEAD, MASK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)shm);
    if (err != cudaSuccess) return err;
    dense_scan_windowed<CG, TIME, HEAD, MASK><<<grid, THREADS, shm, s>>>(
        *args);
  } else if (form == 1) {
    const size_t shm = tab_bytes + mm_bytes;
    err = cudaFuncSetAttribute(
        dense_scan_kernel<true, CG, TIME, HEAD, MASK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
    if (err != cudaSuccess) return err;
    dense_scan_kernel<true, CG, TIME, HEAD, MASK><<<grid, THREADS, shm, s>>>(
        *args);
  } else if (form == 0) {
    dense_scan_kernel<false, CG, TIME, HEAD, MASK><<<grid, THREADS, 0, s>>>(
        *args);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <bool CG, bool TIME, bool HEAD>
cudaError_t launch_mask(const DenseScanArgs* args, int form, int grid,
                        size_t tab_bytes, size_t mm_bytes, cudaStream_t s) {
  return args->mask
             ? launch_form<CG, TIME, HEAD, true>(args, form, grid, tab_bytes,
                                                 mm_bytes, s)
             : launch_form<CG, TIME, HEAD, false>(args, form, grid,
                                                  tab_bytes, mm_bytes, s);
}

template <bool CG>
cudaError_t launch_cg(const DenseScanArgs* args, int form, int grid,
                      size_t tab_bytes, size_t mm_bytes, cudaStream_t s) {
  const bool head = args->desc.n <= DESC_HEAD;
  if (args->has_time)
    return head ? launch_mask<CG, true, true>(args, form, grid, tab_bytes,
                                              mm_bytes, s)
                : launch_mask<CG, true, false>(args, form, grid, tab_bytes,
                                               mm_bytes, s);
  return head ? launch_mask<CG, false, true>(args, form, grid, tab_bytes,
                                             mm_bytes, s)
              : launch_mask<CG, false, false>(args, form, grid, tab_bytes,
                                              mm_bytes, s);
}

}  // namespace

// Copies the descriptor block, zeroes sums and spill and sets the
// min/max tables to their sentinels on `stream`, then launches one form:
// 0 global atomics, 1 per-CTA shared tables, 2 windowed bands (band,
// chunk set; chunk divides R); each writes the matched mask when `mask`
// is set, and makes key 0 the cache-group key when vg_span > 0 (a power
// of two; with at least one key).  Returns cudaError_t.
extern "C" int dense_scan(const DenseScanArgs* args, int form, int grid,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t tab_bytes =
      (size_t)args->Sc * args->L * sizeof(unsigned long long);
  const size_t mm_bytes = (size_t)args->Sc * args->H * 2 * sizeof(long long);
  cudaError_t err = desc_upload(args->desc, s);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(args->sums, 0, tab_bytes, s);
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
  if (args->vg_span < 0 || (args->vg_span & (args->vg_span - 1)) ||
      (args->vg_span > 0 && args->nkeys < 1))
    return cudaErrorInvalidValue;
  return args->vg_span > 0
             ? launch_cg<true>(args, form, grid, tab_bytes, mm_bytes, s)
             : launch_cg<false>(args, form, grid, tab_bytes, mm_bytes, s);
}
