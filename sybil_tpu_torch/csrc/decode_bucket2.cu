// K1 decode_bucket2: bucket column decode for a batch of blocks, both
// on-disk layouts.
//
// Replaces sybil_tpu/ops/decode.py:_decode_bucket2_jit (v2) and
// _decode_bucket_jit (v1), and, for these encodings, the reassembly
// gather of decode_column_batch.  A bucket container stores, per
// distinct value, a CSR segment of posting row ids.  v2 (blocks.py:
// _bucket_encode) delta-encodes the ids WITHIN each segment (each
// segment's first delta is 0) and keeps each segment's first row id in
// seg_bases; v1 delta-encodes them ACROSS segments from one id_base per
// block, so a segment boundary may jump backwards.  For posting p:
//     slot = searchsorted(offsets, p, side="right")
//     v2: start = slot > 0 ? offsets[slot-1] : 0
//         row = seg_bases[slot] + cum[p] - cum[start]   (int32, wrapping)
//     v1: row = id_base + cum[p]                        (int32, wrapping)
//     out[row] = uniq[slot], valid[row] = 1   when 0 <= row < C
// with cum the inclusive prefix sum of the deltas' int32 casts.
//
// Bound: memory.  The block reads its deltas (1-8 B per posting) and
// writes 9 B per output row (int64 value + bool validity); everything
// else is small.  Design: one CTA per OUTPUT row of the [B, C] batch.
// src_of_row maps each row to its block; -1 marks a row whose block
// lacks the column (zeroed here) and -2 a row that another launch of
// the batch writes (a block of another encoding: left alone).  The CTA
// zeroes its row, stages its block's offsets, seg_bases and uniq in
// dynamic shared memory (20 B per slot, 160 KB at the K = 8192 cap),
// then walks the postings in tiles of 1024 with a running
// cub::BlockScan.  In v2 the head posting of each segment records
// cum[start] in a per-slot shared array, so a posting whose segment
// began in an earlier tile still finds it; rows scatter straight into
// the block's row of the output, so no gather reassembles block order
// afterwards.  The delta type and the layout are template parameters,
// so no widening pass runs first.

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

template <typename D, bool V1>
__global__ void __launch_bounds__(THREADS) decode_bucket2_kernel(
    const D* __restrict__ deltas,        // [b, P]
    const int* __restrict__ counts,      // [b] postings per block
    const int* __restrict__ offsets,     // [b, K] CSR offsets[1:], 2^31-1 pad
    const long long* __restrict__ uniq,  // [b, K]
    const int* __restrict__ bases,       // v2: seg_bases [b, K]; v1: [b]
    const int* __restrict__ src_of_row,  // [B] block, -1 zero, -2 skip
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
  const int src = src_of_row[row];
  if (src == -2) return;  // another launch writes this row
  // C is a power of two >= 128: 16-byte stores zero the row
  longlong2* vrow = reinterpret_cast<longlong2*>(values + (size_t)row * C);
  uint4* mrow = reinterpret_cast<uint4*>(valid + (size_t)row * C);
  for (int i = threadIdx.x; i < C / 2; i += THREADS)
    vrow[i] = make_longlong2(0, 0);
  for (int i = threadIdx.x; i < C / 16; i += THREADS)
    mrow[i] = make_uint4(0, 0, 0, 0);
  if (src < 0) return;  // the whole CTA leaves: a missing block is zeros

  const int* off_g = offsets + (size_t)src * K;
  const long long* uq_g = uniq + (size_t)src * K;
  for (int i = threadIdx.x; i < K; i += THREADS) {
    s_off[i] = off_g[i];
    if (!V1) s_sb[i] = bases[(size_t)src * K + i];
    s_uniq[i] = uq_g[i];
  }
  const unsigned id_base = V1 ? static_cast<unsigned>(bases[src]) : 0u;
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
      // unsigned types zero-extend, signed ones sign-extend, int64 keeps
      // its low 32 bits: the int32 cast of the reference's cumsum
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
      if (V1) continue;
      const int start = lo > 0 ? s_off[lo - 1] : 0;
      if (p == start) s_segcum[min(lo, K - 1)] = cum[j];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int p = p0 + j;
      if (p >= n) continue;
      const int s = min(slot[j], K - 1);
      const int id = V1 ? static_cast<int>(id_base + cum[j])
                        : static_cast<int>(static_cast<unsigned>(s_sb[s]) +
                                           cum[j] - s_segcum[s]);
      if (id >= 0 && id < C) {
        out_v[id] = s_uniq[s];
        out_m[id] = true;
      }
    }
    __syncthreads();  // scan_tmp and s_segcum reuse
  }
}

template <typename D, bool V1>
cudaError_t launch(const void* deltas, const void* counts,
                   const void* offsets, const void* uniq, const void* bases,
                   const void* src_of_row, void* values, void* valid, int B,
                   int P, int K, int C, cudaStream_t stream) {
  const size_t smem = (size_t)K * (sizeof(long long) + 3 * sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      decode_bucket2_kernel<D, V1>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  decode_bucket2_kernel<D, V1><<<B, THREADS, smem, stream>>>(
      static_cast<const D*>(deltas), static_cast<const int*>(counts),
      static_cast<const int*>(offsets), static_cast<const long long*>(uniq),
      static_cast<const int*>(bases), static_cast<const int*>(src_of_row),
      static_cast<long long*>(values), static_cast<bool*>(valid), P, K, C);
  return cudaGetLastError();
}

template <typename D>
cudaError_t launch_layout(int v1, const void* deltas, const void* counts,
                          const void* offsets, const void* uniq,
                          const void* bases, const void* src_of_row,
                          void* values, void* valid, int B, int P, int K,
                          int C, cudaStream_t s) {
  return v1 ? launch<D, true>(deltas, counts, offsets, uniq, bases,
                              src_of_row, values, valid, B, P, K, C, s)
            : launch<D, false>(deltas, counts, offsets, uniq, bases,
                               src_of_row, values, valid, B, P, K, C, s);
}

}  // namespace

// dtype: 0 uint8, 1 uint16, 2 int32, 3 int8, 4 int16, 5 int64 deltas.
// v1: 0 = v2 layout (bases = seg_bases [b, K]), 1 = v1 layout (bases =
// id_base [b]).  Returns cudaError_t.
extern "C" int decode_bucket2(const void* deltas, int dtype, int v1,
                              const void* counts, const void* offsets,
                              const void* uniq, const void* bases,
                              const void* src_of_row, void* values,
                              void* valid, int B, int P, int K, int C,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K1_CASE(code, T)                                                   \
  case code:                                                               \
    return launch_layout<T>(v1, deltas, counts, offsets, uniq, bases,      \
                            src_of_row, values, valid, B, P, K, C, s);
  switch (dtype) {
    K1_CASE(0, uint8_t)
    K1_CASE(1, uint16_t)
    K1_CASE(2, int32_t)
    K1_CASE(3, int8_t)
    K1_CASE(4, int16_t)
    K1_CASE(5, int64_t)
    default:
      return cudaErrorInvalidValue;
  }
#undef K1_CASE
}
