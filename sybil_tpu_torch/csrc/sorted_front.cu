// K7 sorted_front: the front end of the sorted scan strategy over R = B*C
// rows, and sort_permute, the step between its stable sorts.
//
// sorted_front replaces sybil_tpu/ops/scan.py: _front_end (row-in-range,
// the int/str/regex filters, the time key, the key lanes [cg?, time?,
// *groups] with MISSING = -1, one zero lane without any) and the sort operands
// of _scan_sorted (1076-1104, 1117-1118):
//   idxm[r]   r with the matched flag in its sign bit (the reference's
//             sort payload);
//   packed    (sort_pack) the mixed-radix key: digit 0 for MISSING, else
//             key - min + 1; a matched row whose digit leaves [0, card]
//             counts in `spill`; unmatched and spilled rows take the
//             sentinel, the radix product.  int32 when the product is
//             below 2^31 - 1, else int64;
//   unpacked  the K key lanes [K + D, R], then the D distinct lanes
//             (dkeys 435-438: the value, MISSING = -1 where it is
//             missing), SENTINEL (int64 max) in every lane of an
//             unmatched row.
// The cache-group key of a query-cache group scan (vg_span > 0; cg_key,
// 405-411, 424-428) is lane 0: the row's block position over the group
// span, (r >> log2C) / vg_span (a power of two: one shift), made from
// the row index with no column read, never MISSING; a group scan's config has no sort_pack, so it is
// an unpacked int64 lane sorted like any other.  CG is a template
// parameter, as in K2.
// Filters and the time key are K2's (dense_scan.cu), copied: a filter
// never passes on a missing value; re/nre read the regex bitset at
// clamp(v, 0, len-1); a set filter reads K14's bitmasks (in: has & hit,
// nin: has & ~hit; the op is read first, a set column has no validity
// lane); an unknown op never matches; a row without the time column is
// unmatched; the time key is trunc_div(t, tb) * tb with Go's division, in
// int32 arithmetic under time_i32 like the reference's.  For a samples
// query the sorted form also writes the matched mask, one byte a row
// (_scan_sorted 1273-1274; MASK, a template parameter); the enum form
// never does (enum_radix declines samples).
//
// In its enum form (a template parameter, chosen when the engine runs the
// enumerated strategy) it replaces the front end of _scan_enum
// (1420-1435, 1596-1597): the same packed key, always int32 there since
// the radix is at most 2^21, the spill count, and the whole-scan totals
// totals[0] = sum of the matched rows' weights (1 where the weight column
// is missing or absent) and totals[1] = matched rows, exact and wrapping
// mod 2^64 like the reference's int64 sums; idxm is not written.
//
// sort_permute replaces the operand permutation inside the reference's
// multi-key lax.sort (1119): the port sorts the key lanes one stable
// torch.sort at a time, least significant first, so between two sorts
// it composes the running permutation with the last sort's indices
// (base[p], or p) and gathers the next key lane through it.
//
// Bound: memory.  sorted_front reads 9 B per referenced column per row
// and writes 4 B of idxm plus the 4 or 8 B packed key, or 8 B per key
// lane (the enum form: the 4 B key, and the weight column read); one
// grid-stride pass, the spill count and the totals summed per CTA and
// added once.  sort_permute reads p and gathers 8 B twice per row.

#include <cstdint>
#include <cuda_runtime.h>

#include "desc.cuh"
#include "filters.cuh"

namespace {

constexpr int THREADS = 256;
constexpr long long SENTINEL = 0x7fffffffffffffffll;
constexpr int FV_SMEM = 16;  // filter constants staged in shared memory

}  // namespace

// Mirrored field for field by SortedFrontArgs in ops/scan.py (ctypes).  The
// per-key, per-distinct-column and per-filter arrays point into the
// descriptor block (desc.cuh): no fixed cap on their counts.
struct SortedFrontArgs {
  Desc desc;
  const long long* const* key_vals;   // [ngroups] group columns
  const unsigned char* const* key_valid;
  const long long* pack_min;          // [nkeys] per key lane (packed)
  const long long* pack_card;
  const long long* const* d_vals;     // [ndist] distinct columns
  const unsigned char* const* d_valid;
  const long long* const* f_vals;     // [nfilters]; set ops: K14's hit
  const unsigned char* const* f_valid;  // set ops: K14's has
  const unsigned char* const* f_bits; // regex bitsets (re/nre) or null
  const long long* f_bits_len;
  // 0 gt, 1 lt, 2 eq, 3 neq, 4 re, 5 nre, 6 never, 7 set in, 8 set nin
  const long long* f_op;
  const long long* filter_vals;       // [nfilters] filter constants
  const long long* t_vals;            // time column (has_time)
  const unsigned char* t_valid;
  const int* nrec;                    // [B] valid records per block
  void* key_out;             // int32/int64 [R] packed, int64 [K + D, R]
  int* idxm;                          // [R] (not in the enum form)
  unsigned long long* spill;          // [1]
  unsigned long long* totals;         // [2] enum form: sum w, matched rows
  const long long* w_vals;            // weight column (has_weight)
  const unsigned char* w_valid;
  unsigned char* mask;                // [R] matched rows (MASK), or null
  long long R;
  long long tb;                       // time bucket (> 0)
  long long sent;                     // packed sentinel
  int log2C;
  int nkeys;                          // key lanes, >= 1
  int ngroups;                        // group columns
  int nfilters;
  int has_time;                       // the time key follows the cg lane
  int time_i32;
  int packed;                         // 0 unpacked, 1 int32, 2 int64 key
  int has_weight;
  int ndist;                          // distinct lanes (unpacked only)
  int vg_span;                        // > 0: lane 0 is the cache-group key
};

namespace {

// The reference's _trunc_div for d > 0 (as in dense_scan.cu).
template <typename T, typename U>
__device__ __forceinline__ T go_trunc_div(T x, T d) {
  const T ax = x < 0 ? static_cast<T>(U(0) - static_cast<U>(x)) : x;
  T q = ax / d;
  if (ax < 0 && q * d != ax) --q;
  return x >= 0 ? q : static_cast<T>(U(0) - static_cast<U>(q));
}

__device__ __forceinline__ long long time_lane(const SortedFrontArgs& a,
                                               long long t) {
  if (a.time_i32) {
    const int tb = static_cast<int>(a.tb);
    const int q = go_trunc_div<int, unsigned>(static_cast<int>(t), tb);
    return static_cast<int>(static_cast<unsigned>(q) *
                            static_cast<unsigned>(tb));
  }
  const long long q = go_trunc_div<long long, unsigned long long>(t, a.tb);
  return (long long)((unsigned long long)q * (unsigned long long)a.tb);
}

// Key lane k of row r: the cache-group key (CG, lane 0), the time key, a
// group column (MISSING = -1), or the single zero lane of a scan without
// any.
template <bool HEAD, bool CG>
__device__ __forceinline__ long long key_lane(const SortedFrontArgs& a,
                                              int k, long long r) {
  if (CG) {
    if (k == 0) return r >> (a.log2C + __ffs(a.vg_span) - 1);
    --k;
  }
  if (a.has_time && k == 0) return time_lane(a, a.t_vals[r]);
  const int g = k - a.has_time;
  if (g >= a.ngroups) return 0ll;
  return desc_at<HEAD>(a.desc, a.key_valid, g)[r]
             ? desc_at<HEAD>(a.desc, a.key_vals, g)[r] : -1ll;
}

// HEAD: where the descriptor block lies (desc.cuh), a template
// parameter as in K2; MASK: write the matched mask (not with ENUM); CG:
// lane 0 is the cache-group key (not with ENUM).
template <bool ENUM, bool HEAD, bool MASK, bool CG>
__global__ void __launch_bounds__(THREADS) sorted_front_kernel(
    const SortedFrontArgs a) {
  __shared__ unsigned long long s_spill, s_count, s_samples;
  __shared__ long long s_fv[FV_SMEM];
  if (threadIdx.x < min(a.nfilters, FV_SMEM))
    s_fv[threadIdx.x] = a.filter_vals[threadIdx.x];
  if (threadIdx.x == 0) s_spill = s_count = s_samples = 0ull;
  __syncthreads();
  const long long cmask = (1ll << a.log2C) - 1;
  unsigned long long my_spill = 0ull, my_count = 0ull, my_samples = 0ull;
  for (long long r = (long long)blockIdx.x * THREADS + threadIdx.x;
       r < a.R; r += (long long)gridDim.x * THREADS) {
    bool matched = (r & cmask) < a.nrec[r >> a.log2C];
    // the staged constants first, the rest (past FV_SMEM) from global
    const int nfs = min(a.nfilters, FV_SMEM);
    for (int i = 0; matched && i < nfs; ++i)
      matched = passes<HEAD>(a, i, r, s_fv[i]);
    for (int i = FV_SMEM; matched && i < a.nfilters; ++i)
      matched = passes<HEAD>(a, i, r, a.filter_vals[i]);
    if (a.has_time && matched) matched = a.t_valid[r] != 0;
    if (MASK) a.mask[r] = matched;
    if (ENUM) {
      if (matched) {
        my_count += a.has_weight && a.w_valid[r]
                        ? (unsigned long long)a.w_vals[r] : 1ull;
        ++my_samples;
      }
    } else {
      a.idxm[r] = matched ? (int)((unsigned)r | 0x80000000u) : (int)r;
    }
    if (ENUM || a.packed) {
      unsigned long long acc = 0ull;
      bool bad = false;
      for (int k = 0; k < a.nkeys; ++k) {
        const long long key = key_lane<HEAD, CG>(a, k, r);
        const long long card = desc_at<HEAD>(a.desc, a.pack_card, k);
        const unsigned long long mn =
            (unsigned long long)desc_at<HEAD>(a.desc, a.pack_min, k);
        const long long digit =
            key == -1ll ? 0ll
                        : (long long)((unsigned long long)key - mn + 1ull);
        bad |= digit < 0 || digit > card;
        acc = acc * (unsigned long long)(card + 1) + (unsigned long long)digit;
      }
      const long long out = matched && !bad ? (long long)acc : a.sent;
      if (ENUM || a.packed == 1)
        static_cast<int*>(a.key_out)[r] = (int)out;
      else
        static_cast<long long*>(a.key_out)[r] = out;
      my_spill += matched && bad;
    } else {
      long long* keys = static_cast<long long*>(a.key_out);
      for (int k = 0; k < a.nkeys; ++k)
        keys[(size_t)k * a.R + r] =
            matched ? key_lane<HEAD, CG>(a, k, r) : SENTINEL;
      for (int j = 0; j < a.ndist; ++j) {
        long long v = SENTINEL;
        if (matched)
          v = desc_at<HEAD>(a.desc, a.d_valid, j)[r]
                  ? desc_at<HEAD>(a.desc, a.d_vals, j)[r] : -1ll;
        keys[(size_t)(a.nkeys + j) * a.R + r] = v;
      }
    }
  }
  if (my_spill) atomicAdd(&s_spill, my_spill);
  if (ENUM) {
    if (my_count) atomicAdd(&s_count, my_count);
    if (my_samples) atomicAdd(&s_samples, my_samples);
  }
  __syncthreads();
  if (threadIdx.x == 0 && s_spill) atomicAdd(a.spill, s_spill);
  if (ENUM && threadIdx.x == 0) {
    if (s_count) atomicAdd(a.totals, s_count);
    if (s_samples) atomicAdd(a.totals + 1, s_samples);
  }
}

__global__ void __launch_bounds__(THREADS) sort_permute_kernel(
    const long long* base, const long long* p, const long long* nxt,
    long long* base_out, long long* gathered, long long R) {
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < R;
       i += (long long)gridDim.x * THREADS) {
    const long long j = p[i];
    const long long b = base ? base[j] : j;
    if (base_out) base_out[i] = b;
    if (gathered) gathered[i] = nxt[b];
  }
}

template <bool CG>
void launch_sorted(const SortedFrontArgs* args, bool head, int grid,
                   cudaStream_t s) {
  if (args->mask) {
    if (head)
      sorted_front_kernel<false, true, true, CG><<<grid, THREADS, 0, s>>>(
          *args);
    else
      sorted_front_kernel<false, false, true, CG><<<grid, THREADS, 0, s>>>(
          *args);
  } else {
    if (head)
      sorted_front_kernel<false, true, false, CG><<<grid, THREADS, 0, s>>>(
          *args);
    else
      sorted_front_kernel<false, false, false, CG><<<grid, THREADS, 0, s>>>(
          *args);
  }
}

}  // namespace

// Copies the descriptor block, zeroes the spill count (and the enum
// form's totals), then one grid-stride pass on `stream`, the enum form
// when `enum_form` is set, writing the matched mask when `mask` is set
// and making lane 0 the cache-group key when vg_span > 0 (the sorted
// form only).  Returns cudaError_t.
extern "C" int sorted_front(const SortedFrontArgs* args, int enum_form,
                            int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (args->R >= (1ll << 31) || (enum_form && args->packed != 1) ||
      (args->ndist > 0 && args->packed) || (enum_form && args->mask) ||
      args->vg_span < 0 || (args->vg_span & (args->vg_span - 1)) ||
      (enum_form && args->vg_span) ||
      (args->vg_span && args->nkeys < 1 + args->has_time))
    return cudaErrorInvalidValue;
  const bool head = args->desc.n <= DESC_HEAD;
  cudaError_t err = desc_upload(args->desc, s);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(args->spill, 0, sizeof(unsigned long long), s);
  if (err != cudaSuccess) return err;
  if (enum_form) {
    err = cudaMemsetAsync(args->totals, 0, 2 * sizeof(unsigned long long), s);
    if (err != cudaSuccess) return err;
    if (head)
      sorted_front_kernel<true, true, false, false><<<grid, THREADS, 0, s>>>(
          *args);
    else
      sorted_front_kernel<true, false, false, false><<<grid, THREADS, 0, s>>>(
          *args);
  } else if (args->vg_span) {
    launch_sorted<true>(args, head, grid, s);
  } else {
    launch_sorted<false>(args, head, grid, s);
  }
  return cudaGetLastError();
}

// base_out[i] = base[p[i]] (base non-null) and gathered[i] = nxt[base_out
// [i]], or nxt[p[i]] without a base.  Returns cudaError_t.
extern "C" int sort_permute(const long long* base, const long long* p,
                            const long long* nxt, long long* base_out,
                            long long* gathered, long long R, int grid,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((base == nullptr) != (base_out == nullptr) ||
      (nxt == nullptr) != (gathered == nullptr))
    return cudaErrorInvalidValue;
  sort_permute_kernel<<<grid, THREADS, 0, s>>>(base, p, nxt, base_out,
                                               gathered, R);
  return cudaGetLastError();
}
