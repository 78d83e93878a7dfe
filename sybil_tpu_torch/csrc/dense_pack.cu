// K3 dense_pack: the dense strategy's single download buffer.
//
// Replaces the dense compact table of sybil_tpu/ops/scan.py:_scan_dense
// (expand the compact [g+1] sums to the lane-padded slots, zero the
// dead slot's count and samples, count live slots into num_groups) and
// of pack_outputs (meta row; the keyless table in dense_table_plan
// column order, where lanes proven equal to samples are not shipped and
// int32 pairs pack into one int64 word, first column in the low word,
// an odd column count padded with its last column).
//
// Bound: launch latency.  It reads Sc*L*8 bytes of sums and writes
// (1 + table rows) * W * 8 bytes, a few KB for typical group-bys.
// Design: one thread per padded slot writes its row's words; the live
// count is a __syncthreads_count per CTA and one atomicAdd into the
// meta row, which the entry point zeroes (with the padding words) by a
// memset on the same stream before the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAXC = 2 + 3 * 32;

}  // namespace

// Mirrored field for field by DensePackArgs in ops/scan.py (ctypes).
struct DensePackArgs {
  const unsigned long long* sums;   // [Sc, L]
  const unsigned long long* spill;  // [1]
  unsigned long long* main;         // [rows, W], rows = 1 + table rows
  long long rows;
  int lane[MAXC];  // lane index of each wire column (already even if i32)
  int ncols;
  int i32;
  int slots;
  int Sc;
  int compact;  // 1: sums hold [g+1] rows, g = Sc-1 is the dead row
  int L;
  int W;
  int pad_;
};

namespace {

__global__ void __launch_bounds__(THREADS) dense_pack_kernel(
    const DensePackArgs a) {
  const int s = blockIdx.x * THREADS + threadIdx.x;
  bool live = false;
  if (s < a.slots) {
    // compact: rows [0, Sc-1) map 1:1, the rest (padding and the dead
    // slot) read as zeros; otherwise the table is already slot-sized
    const int src = a.compact ? (s < a.Sc - 1 ? s : -1) : s;
    const bool live_row = s < a.slots - 1;
    const unsigned long long* row = a.sums + (size_t)(src < 0 ? 0 : src) * a.L;
    const unsigned long long count = (src >= 0 && live_row) ? row[0] : 0ull;
    const unsigned long long samples = (src >= 0 && live_row) ? row[1] : 0ull;
    live = (long long)count > 0 || (long long)samples > 0;
    const int wpr = a.i32 ? a.ncols / 2 : a.ncols;
    unsigned long long* out = a.main + a.W + (size_t)s * wpr;
    for (int w = 0; w < wpr; ++w) {
      unsigned long long word[2];
      const int per = a.i32 ? 2 : 1;
      for (int h = 0; h < per; ++h) {
        const int lane = a.lane[w * per + h];
        unsigned long long x = src >= 0 ? row[lane] : 0ull;
        if (lane == 0) x = count;
        if (lane == 1) x = samples;
        if (lane >= 2 && (lane - 2) % 3 == 0) x = (long long)x > 0;  // exists
        word[h] = x;
      }
      out[w] = a.i32 ? ((word[0] & 0xffffffffull) | (word[1] << 32))
                     : word[0];
    }
  }
  const int n = __syncthreads_count(live);
  if (threadIdx.x == 0 && n) atomicAdd(a.main, (unsigned long long)n);
  if (s == 0) a.main[1] = *a.spill;
}

}  // namespace

// Zeroes `main` on `stream`, then writes it.  Returns cudaError_t.
extern "C" int dense_pack(const DensePackArgs* args, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      args->main, 0, (size_t)args->rows * args->W * sizeof(long long), st);
  if (err != cudaSuccess) return err;
  const int grid = (args->slots + THREADS - 1) / THREADS;
  dense_pack_kernel<<<grid, THREADS, 0, st>>>(*args);
  return cudaGetLastError();
}
