// K7 sorted_front: the front end of the sorted scan strategy over R = B*C
// rows, and sort_permute, the step between its stable sorts.
//
// sorted_front replaces sybil_tpu/ops/scan.py: _front_end (row-in-range,
// the int/str/regex filters, the time key, the key lanes [time?, *groups]
// with MISSING = -1, one zero lane without either) and the sort operands
// of _scan_sorted (1076-1104, 1117-1118):
//   idxm[r]   r with the matched flag in its sign bit (the reference's
//             sort payload);
//   packed    (sort_pack) the mixed-radix key: digit 0 for MISSING, else
//             key - min + 1; a matched row whose digit leaves [0, card]
//             counts in `spill`; unmatched and spilled rows take the
//             sentinel, the radix product.  int32 when the product is
//             below 2^31 - 1, else int64;
//   unpacked  the K key lanes [K, R], SENTINEL (int64 max) for unmatched
//             rows.
// Filters and the time key are K2's (dense_scan.cu), copied: a filter
// never passes on a missing value; re/nre read the regex bitset at
// clamp(v, 0, len-1); an unknown op never matches; a row without the time
// column is unmatched; the time key is trunc_div(t, tb) * tb with Go's
// division, in int32 arithmetic under time_i32 like the reference's.
//
// sort_permute replaces the operand permutation inside the reference's
// multi-key lax.sort (1119): the port sorts the key lanes one stable
// torch.sort at a time, least significant first, so between two sorts
// it composes the running permutation with the last sort's indices
// (base[p], or p) and gathers the next key lane through it.
//
// Bound: memory.  sorted_front reads 9 B per referenced column per row
// and writes 4 B of idxm plus the 4 or 8 B packed key, or 8 B per key
// lane; one grid-stride pass, the spill count summed per CTA and added
// once.  sort_permute reads p and gathers 8 B twice per row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAXK = 16;
constexpr int MAXF = 16;
constexpr long long SENTINEL = 0x7fffffffffffffffll;

}  // namespace

// Mirrored field for field by SortedFrontArgs in ops/scan.py (ctypes).
struct SortedFrontArgs {
  const long long* key_vals[MAXK];    // group columns
  const unsigned char* key_valid[MAXK];
  long long pack_min[MAXK];           // per key lane (packed)
  long long pack_card[MAXK];
  const long long* f_vals[MAXF];
  const unsigned char* f_valid[MAXF];
  const unsigned char* f_bits[MAXF];  // regex bitsets (re/nre) or null
  long long f_bits_len[MAXF];
  const long long* filter_vals;       // [F] filter constants, on device
  const long long* t_vals;            // time column (has_time)
  const unsigned char* t_valid;
  const int* nrec;                    // [B] valid records per block
  void* key_out;                      // int32/int64 [R] packed, int64 [K, R]
  int* idxm;                          // [R]
  unsigned long long* spill;          // [1]
  long long R;
  long long tb;                       // time bucket (> 0)
  long long sent;                     // packed sentinel
  int f_op[MAXF];                     // 0 gt, 1 lt, 2 eq, 3 neq, 4 re, 5 nre
  int log2C;
  int nkeys;                          // key lanes, >= 1
  int ngroups;                        // group columns
  int nfilters;
  int has_time;                       // lane 0 is the time key
  int time_i32;
  int packed;                         // 0 unpacked, 1 int32, 2 int64 key
  int pad_;
};

namespace {

__device__ __forceinline__ bool passes(const SortedFrontArgs& a, int i,
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

// Key lane k of row r: the time key, a group column (MISSING = -1), or
// the single zero lane of a scan without either.
__device__ __forceinline__ long long key_lane(const SortedFrontArgs& a,
                                              int k, long long r) {
  if (a.has_time && k == 0) return time_lane(a, a.t_vals[r]);
  const int g = k - a.has_time;
  if (g >= a.ngroups) return 0ll;
  return a.key_valid[g][r] ? a.key_vals[g][r] : -1ll;
}

__global__ void __launch_bounds__(THREADS) sorted_front_kernel(
    const SortedFrontArgs a) {
  __shared__ long long s_fv[MAXF];
  __shared__ unsigned long long s_spill;
  if (threadIdx.x < a.nfilters) s_fv[threadIdx.x] = a.filter_vals[threadIdx.x];
  if (threadIdx.x == 0) s_spill = 0ull;
  __syncthreads();
  const long long cmask = (1ll << a.log2C) - 1;
  unsigned long long my_spill = 0ull;
  for (long long r = (long long)blockIdx.x * THREADS + threadIdx.x;
       r < a.R; r += (long long)gridDim.x * THREADS) {
    bool matched = (r & cmask) < a.nrec[r >> a.log2C];
    for (int i = 0; matched && i < a.nfilters; ++i)
      matched = passes(a, i, r, s_fv[i]);
    if (a.has_time && matched) matched = a.t_valid[r] != 0;
    a.idxm[r] = matched ? (int)((unsigned)r | 0x80000000u) : (int)r;
    if (a.packed) {
      unsigned long long acc = 0ull;
      bool bad = false;
      for (int k = 0; k < a.nkeys; ++k) {
        const long long key = key_lane(a, k, r);
        const long long card = a.pack_card[k];
        const long long digit =
            key == -1ll ? 0ll
                        : (long long)((unsigned long long)key -
                                      (unsigned long long)a.pack_min[k] + 1ull);
        bad |= digit < 0 || digit > card;
        acc = acc * (unsigned long long)(card + 1) + (unsigned long long)digit;
      }
      const long long out = matched && !bad ? (long long)acc : a.sent;
      if (a.packed == 1)
        static_cast<int*>(a.key_out)[r] = (int)out;
      else
        static_cast<long long*>(a.key_out)[r] = out;
      my_spill += matched && bad;
    } else {
      long long* keys = static_cast<long long*>(a.key_out);
      for (int k = 0; k < a.nkeys; ++k)
        keys[(size_t)k * a.R + r] = matched ? key_lane(a, k, r) : SENTINEL;
    }
  }
  if (my_spill) atomicAdd(&s_spill, my_spill);
  __syncthreads();
  if (threadIdx.x == 0 && s_spill) atomicAdd(a.spill, s_spill);
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

}  // namespace

// Zeroes the spill count, then one grid-stride pass on `stream`.
// Returns cudaError_t.
extern "C" int sorted_front(const SortedFrontArgs* args, int grid,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (args->R >= (1ll << 31)) return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(args->spill, 0, sizeof(unsigned long long),
                                    s);
  if (err != cudaSuccess) return err;
  sorted_front_kernel<<<grid, THREADS, 0, s>>>(*args);
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
