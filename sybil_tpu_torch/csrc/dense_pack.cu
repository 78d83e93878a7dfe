// K3 dense_pack: the dense strategy's single download buffer.
//
// Replaces the dense compact table of sybil_tpu/ops/scan.py:_scan_dense
// (expand the compact [g+1] sums, mins and maxs to the lane-padded
// slots, zero the dead slot's count and samples, count live slots into
// num_groups) and of pack_outputs: the meta row (num_groups, spill, the
// outlier count of each histogram aggregation); the keyless table in
// dense_table_plan column order, where lanes proven equal to samples are
// not shipped and int32 pairs pack into one int64 word (first column in
// the low word, an odd column count padded with its last column),
// followed by each histogram aggregation's min and max words; and the
// dense histogram sections: the gids of the first Ph slots of
// lax.top_k(live, Ph) (live slots in ascending order, then the others in
// ascending order, as top_k breaks ties toward the lower index), then
// each aggregation's bucket rows gathered at those gids, flattened
// row-major.  The outlier rows between the table and the histogram
// sections are K5's; this kernel leaves them alone.  With the device HLL
// (1934-1945) it also writes the HLL sections: the gids of the first
// Phll slots of the same top_k order, then each of those slots' 2^14
// uint8 registers (K13's planes) as 2048 little-endian int64 words, and
// leaves the npairs meta word 0.
//
// Bound: launch latency.  It reads the small sum, min/max and bucket
// tables and writes a buffer of a few to a few hundred KB.  Design: one
// CTA of 1024 threads walks the slots in steps of 1024, so a block-wide
// scan of the live flags gives num_groups and every live slot's rank
// without a second launch; a second walk ranks the non-live slots after
// them.  The entry point zeroes every word this kernel owns by memsets on
// the same stream before the launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "desc.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int HLL_WORDS = (1 << 14) / 8;  // one register plane, int64 words
constexpr long long BIG = 1ll << 62;

}  // namespace

// Mirrored field for field by DensePackArgs in ops/scan.py (ctypes).  The
// per-aggregation and per-column arrays point into the descriptor block
// (desc.cuh).
struct DensePackArgs {
  Desc desc;
  const unsigned long long* sums;   // [Sc, L]
  const unsigned long long* spill;  // [1]
  const long long* mins;            // [Sc, H]
  const long long* maxs;            // [Sc, H]
  const unsigned long long* const* nout;  // [H] [1] per hist agg, or null
  const unsigned long long* const* hist;  // [H] [Sc, nv_h] per hist agg
  const long long* hist_row;        // [H] first row of each bucket matrix
  const long long* hist_nv;         // [H]
  const long long* lane;  // [ncols] lane of each wire column (even if i32)
  const unsigned long long* hll;    // [slots, 2048] K13's planes, or null
  unsigned long long* main;         // [rows, W]
  long long rows;
  long long out_lo;                 // [out_lo, out_hi): K5's rows
  long long out_hi;
  long long gid_row;                // first row of the hist gid section
  long long hll_gid_row;            // first row of the HLL gid section
  long long hll_reg_row;            // first row of the HLL planes
  int ncols;
  int i32;
  int slots;
  int Sc;
  int compact;  // 1: sums hold [g+1] rows, g = Sc-1 is the dead row
  int L;
  int W;
  int H;        // histogram aggregations
  int Ph;       // hist gid rows shipped (0 without hist aggs)
  int Phll;     // HLL planes shipped (0 without the device HLL)
};

namespace {

// compact: rows [0, Sc-1) map 1:1, the rest (padding and the dead slot)
// read as empty; otherwise the tables are already slot-sized
__device__ __forceinline__ int src_row(const DensePackArgs& a, int s) {
  return a.compact ? (s < a.Sc - 1 ? s : -1) : s;
}

__device__ __forceinline__ bool slot_live(const DensePackArgs& a, int s) {
  const int src = src_row(a, s);
  if (src < 0 || s >= a.slots - 1) return false;
  const unsigned long long* row = a.sums + (size_t)src * a.L;
  return (long long)row[0] > 0 || (long long)row[1] > 0;
}

__global__ void __launch_bounds__(THREADS) dense_pack_kernel(
    const DensePackArgs a) {
  extern __shared__ int s_gidx[];   // [max(Ph, Phll)]
  const int ng = a.Ph > a.Phll ? a.Ph : a.Phll;
  const int wpr = (a.i32 ? a.ncols / 2 : a.ncols) + 2 * a.H;
  int nlive = 0;
  for (int base = 0; base < a.slots; base += THREADS) {
    const int s = base + threadIdx.x;
    bool live = false;
    if (s < a.slots) {
      const int src = src_row(a, s);
      const bool live_row = s < a.slots - 1;
      const unsigned long long* row =
          a.sums + (size_t)(src < 0 ? 0 : src) * a.L;
      const unsigned long long count =
          (src >= 0 && live_row) ? row[0] : 0ull;
      const unsigned long long samples =
          (src >= 0 && live_row) ? row[1] : 0ull;
      live = (long long)count > 0 || (long long)samples > 0;
      unsigned long long* out = a.main + a.W + (size_t)s * wpr;
      const int per = a.i32 ? 2 : 1;
      const int npack = a.ncols / per;
      for (int w = 0; w < npack; ++w) {
        unsigned long long word[2];
        for (int h = 0; h < per; ++h) {
          const int lane = (int)desc_at(a.desc, a.lane, w * per + h);
          unsigned long long x = src >= 0 ? row[lane] : 0ull;
          if (lane == 0) x = count;
          if (lane == 1) x = samples;
          if (lane >= 2 && (lane - 2) % 3 == 0) x = (long long)x > 0;  // exists
          word[h] = x;
        }
        out[w] = a.i32 ? ((word[0] & 0xffffffffull) | (word[1] << 32))
                       : word[0];
      }
      for (int h = 0; h < a.H; ++h) {
        const long long mn = src >= 0 ? a.mins[(size_t)src * a.H + h] : BIG;
        const long long mx = src >= 0 ? a.maxs[(size_t)src * a.H + h] : -BIG;
        out[npack + 2 * h] = (unsigned long long)mn;
        out[npack + 2 * h + 1] = (unsigned long long)mx;
      }
    }
    int n;
    const int pre = block_scan<THREADS>(live ? 1 : 0, &n);
    if (live && nlive + pre < ng) s_gidx[nlive + pre] = s;
    nlive += n;
  }
  // non-live slots follow the live ones, in ascending order
  int ndead = 0;
  for (int base = 0; base < a.slots && nlive + ndead < ng;
       base += THREADS) {
    const int s = base + threadIdx.x;
    const bool dead = s < a.slots && !slot_live(a, s);
    int n;
    const int pre = block_scan<THREADS>(dead ? 1 : 0, &n);
    if (dead && nlive + ndead + pre < ng) s_gidx[nlive + ndead + pre] = s;
    ndead += n;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a.main[0] = (unsigned long long)nlive;
    a.main[1] = *a.spill;
    for (int h = 0; h < a.H; ++h) {
      const unsigned long long* nout = desc_at(a.desc, a.nout, h);
      if (nout) a.main[2 + h] = *nout;
    }
  }
  if (a.Phll) {
    unsigned long long* hg = a.main + (size_t)a.hll_gid_row * a.W;
    for (int i = threadIdx.x; i < a.Phll; i += THREADS) hg[i] = s_gidx[i];
    unsigned long long* dst = a.main + (size_t)a.hll_reg_row * a.W;
    for (int i = threadIdx.x; i < a.Phll * HLL_WORDS; i += THREADS)
      dst[i] = a.hll[(size_t)s_gidx[i / HLL_WORDS] * HLL_WORDS +
                     i % HLL_WORDS];
  }
  if (a.Ph == 0) return;
  unsigned long long* gids = a.main + (size_t)a.gid_row * a.W;
  for (int i = threadIdx.x; i < a.Ph; i += THREADS) gids[i] = s_gidx[i];
  for (int h = 0; h < a.H; ++h) {
    const int nv = (int)desc_at(a.desc, a.hist_nv, h);
    unsigned long long* dst =
        a.main + (size_t)desc_at(a.desc, a.hist_row, h) * a.W;
    const auto* hist = desc_at(a.desc, a.hist, h);
    const int n = a.Ph * nv;
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const int src = src_row(a, s_gidx[i / nv]);
      dst[i] = src >= 0 ? hist[(size_t)src * nv + i % nv] : 0ull;
    }
  }
}

}  // namespace

// Copies the descriptor block and zeroes the words of `main` this kernel
// owns (all but K5's outlier rows [out_lo, out_hi)) on `stream`, then
// writes them.  Returns cudaError_t.
extern "C" int dense_pack(const DensePackArgs* args, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t row_bytes = (size_t)args->W * sizeof(long long);
  if (args->Phll && !args->hll) return cudaErrorInvalidValue;
  cudaError_t err = desc_upload(args->desc, st);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(args->main, 0, args->out_lo * row_bytes, st);
  if (err != cudaSuccess) return err;
  if (args->rows > args->out_hi) {
    err = cudaMemsetAsync(args->main + (size_t)args->out_hi * args->W, 0,
                          (args->rows - args->out_hi) * row_bytes, st);
    if (err != cudaSuccess) return err;
  }
  const size_t shm =
      (size_t)(args->Ph > args->Phll ? args->Ph : args->Phll) * sizeof(int);
  dense_pack_kernel<<<1, THREADS, shm, st>>>(*args);
  return cudaGetLastError();
}
