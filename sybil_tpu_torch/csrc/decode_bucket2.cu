// K1 decode_bucket2: bucket-v2 column decode for a batch of blocks.
//
// Replaces sybil_tpu/ops/decode.py:_decode_bucket2_jit (and, for this
// encoding, the reassembly gather of decode_column_batch).  A bucket-v2
// container stores, per distinct value, a CSR segment of posting row
// ids, delta-encoded WITHIN the segment (each segment's first delta is
// 0) plus the segment's first row id (blocks.py:_bucket_encode).  For
// posting p of a block:
//     slot = searchsorted(offsets, p, side="right")
//     start = slot > 0 ? offsets[slot-1] : 0
//     row  = seg_bases[slot] + cum[p] - cum[start]      (int32, wrapping)
//     out[row] = uniq[slot], valid[row] = 1   when 0 <= row < C
// with cum the inclusive prefix sum of the deltas.
//
// Bound: memory.  The block reads its deltas (1-4 B per posting) and
// writes 9 B per output row (int64 value + bool validity); everything
// else is small.  Design: one CTA per OUTPUT row of the [B, C] batch.
// The CTA zeroes its row (a missing block stops there), stages its
// block's offsets, seg_bases and uniq in dynamic shared memory (20 B per
// slot, 160 KB at the K = 8192 cap), then walks the postings in tiles
// of 1024 with a running cub::BlockScan.  The head posting of each
// segment records cum[start] in a per-slot shared array, so a posting
// whose segment began in an earlier tile still finds it; rows scatter
// straight into the block's row of the output through the row -> block
// map, so no gather reassembles block order afterwards.  The delta type
// is a template parameter, so no widening pass runs first.

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 4;
constexpr int TILE = THREADS * ITEMS;

struct RunningPrefix {
  unsigned total;
  __device__ unsigned operator()(unsigned tile_sum) {
    unsigned old = total;
    total += tile_sum;
    return old;
  }
};

template <typename D>
__global__ void __launch_bounds__(THREADS) decode_bucket2_kernel(
    const D* __restrict__ deltas,        // [b, P]
    const int* __restrict__ counts,      // [b] postings per block
    const int* __restrict__ offsets,     // [b, K] CSR offsets[1:], 2^31-1 pad
    const long long* __restrict__ uniq,  // [b, K]
    const int* __restrict__ seg_bases,   // [b, K]
    const int* __restrict__ src_of_row,  // [B] block index, -1 = missing
    long long* __restrict__ values,      // [B, C]
    bool* __restrict__ valid,            // [B, C]
    int P, int K, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* s_uniq = reinterpret_cast<long long*>(smem);
  int* s_off = reinterpret_cast<int*>(s_uniq + K);
  int* s_sb = s_off + K;
  unsigned* s_segcum = reinterpret_cast<unsigned*>(s_sb + K);
  typedef cub::BlockScan<unsigned, THREADS> Scan;
  __shared__ typename Scan::TempStorage scan_tmp;

  const int row = blockIdx.x;
  // C is a power of two >= 128: 16-byte stores zero the row
  longlong2* vrow = reinterpret_cast<longlong2*>(values + (size_t)row * C);
  uint4* mrow = reinterpret_cast<uint4*>(valid + (size_t)row * C);
  for (int i = threadIdx.x; i < C / 2; i += THREADS)
    vrow[i] = make_longlong2(0, 0);
  for (int i = threadIdx.x; i < C / 16; i += THREADS)
    mrow[i] = make_uint4(0, 0, 0, 0);
  const int src = src_of_row[row];
  if (src < 0) return;  // the whole CTA leaves: a missing block is zeros

  const int* off_g = offsets + (size_t)src * K;
  const int* sb_g = seg_bases + (size_t)src * K;
  const long long* uq_g = uniq + (size_t)src * K;
  for (int i = threadIdx.x; i < K; i += THREADS) {
    s_off[i] = off_g[i];
    s_sb[i] = sb_g[i];
    s_uniq[i] = uq_g[i];
  }
  __syncthreads();  // also orders the zeroing before the scatter

  const int n = counts[src];
  const D* d_g = deltas + (size_t)src * P;
  long long* out_v = values + (size_t)row * C;
  bool* out_m = valid + (size_t)row * C;
  RunningPrefix prefix{0u};
  for (int base = 0; base < n; base += TILE) {
    unsigned cum[ITEMS];
    int slot[ITEMS];
    const int p0 = base + threadIdx.x * ITEMS;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int p = p0 + j;
      // u8/u16 zero-extend, i32 keeps its bits: the int32 cast of the
      // reference's cumsum
      cum[j] = p < n ? static_cast<unsigned>(static_cast<int>(d_g[p])) : 0u;
    }
    Scan(scan_tmp).InclusiveSum(cum, cum, prefix);
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int p = p0 + j;
      slot[j] = 0;
      if (p >= n) continue;
      int lo = 0, hi = K;  // first offsets entry > p (side="right")
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s_off[mid] <= p) lo = mid + 1; else hi = mid;
      }
      slot[j] = lo;
      const int start = lo > 0 ? s_off[lo - 1] : 0;
      if (p == start) s_segcum[min(lo, K - 1)] = cum[j];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int p = p0 + j;
      if (p >= n) continue;
      const int s = min(slot[j], K - 1);
      const int id = static_cast<int>(static_cast<unsigned>(s_sb[s]) +
                                      cum[j] - s_segcum[s]);
      if (id >= 0 && id < C) {
        out_v[id] = s_uniq[s];
        out_m[id] = true;
      }
    }
    __syncthreads();  // scan_tmp and s_segcum reuse
  }
}

template <typename D>
cudaError_t launch(const void* deltas, const void* counts,
                   const void* offsets, const void* uniq,
                   const void* seg_bases, const void* src_of_row,
                   void* values, void* valid, int B, int P, int K, int C,
                   cudaStream_t stream) {
  const size_t smem = (size_t)K * (sizeof(long long) + 3 * sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      decode_bucket2_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  decode_bucket2_kernel<D><<<B, THREADS, smem, stream>>>(
      static_cast<const D*>(deltas), static_cast<const int*>(counts),
      static_cast<const int*>(offsets), static_cast<const long long*>(uniq),
      static_cast<const int*>(seg_bases),
      static_cast<const int*>(src_of_row), static_cast<long long*>(values),
      static_cast<bool*>(valid), P, K, C);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = uint8, 1 = uint16, 2 = int32 deltas.  Returns cudaError_t.
extern "C" int decode_bucket2(const void* deltas, int dtype,
                              const void* counts, const void* offsets,
                              const void* uniq, const void* seg_bases,
                              const void* src_of_row, void* values,
                              void* valid, int B, int P, int K, int C,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<uint8_t>(deltas, counts, offsets, uniq, seg_bases,
                             src_of_row, values, valid, B, P, K, C, s);
    case 1:
      return launch<uint16_t>(deltas, counts, offsets, uniq, seg_bases,
                              src_of_row, values, valid, B, P, K, C, s);
    case 2:
      return launch<int32_t>(deltas, counts, offsets, uniq, seg_bases,
                             src_of_row, values, valid, B, P, K, C, s);
    default:
      return cudaErrorInvalidValue;
  }
}
