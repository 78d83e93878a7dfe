// K6 decode_value: value and str-id column decode for a batch of blocks.
//
// Replaces sybil_tpu/ops/decode.py:_decode_value_jit (value mode) and
// _decode_ids_jit (id mode), and, for these encodings, the reassembly
// gather of decode_column_batch.  A value container stores an int
// column as deltas (int8/16/32 or int64, blocks.py:_narrow) from a base
// kept in the column meta, and its validity as little-endian packed
// bits; a str-value container stores int32 dict ids and the same bits.
// For entry c of a block:
//     value mode: out[c] = base + sum(deltas[0..c])   (int64, wrapping)
//     id mode:    out[c] = ids[c]                     (widened)
//     valid[c] = (bits[c / 8] >> (c % 8)) & 1
// The host zero-pads deltas and ids past a block's records, so in value
// mode entries in [nrec, C) hold the carried last value, as the
// reference's cumsum gives.
//
// Bound: memory.  Per entry the block reads its delta (1-8 B) and 1/8 B
// of bits and writes 9 B (int64 value + bool validity).  Design: one CTA
// per OUTPUT row of the [B, C] batch, as K1.  src_of_row maps each row to
// its block; -1 marks a row whose block lacks the column (zeroed here)
// and -2 a row that another launch writes (left alone).  Each thread
// takes 8 consecutive entries, so its validity is exactly one byte of
// bits, and the CTA walks the row in tiles of 4096 entries with a
// running cub::BlockScan of unsigned 64-bit sums (wrapping like the
// reference's int64 cumsum); the delta type is a template parameter, so
// no widening pass runs first.

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int THREADS = 512;
constexpr int ITEMS = 8;  // one byte of validity bits
constexpr int TILE = THREADS * ITEMS;

struct RunningPrefix {
  unsigned long long total;
  __device__ unsigned long long operator()(unsigned long long tile_sum) {
    const unsigned long long old = total;
    total += tile_sum;
    return old;
  }
};

template <typename D, bool IDS>
__global__ void __launch_bounds__(THREADS) decode_value_kernel(
    const D* __restrict__ lanes,               // [b, C] deltas or ids
    const unsigned char* __restrict__ bits,    // [b, C/8]
    const long long* __restrict__ bases,       // [b] (value mode)
    const int* __restrict__ src_of_row,        // [B] block, -1 zero, -2 skip
    long long* __restrict__ values,            // [B, C]
    bool* __restrict__ valid,                  // [B, C]
    int C) {
  typedef cub::BlockScan<unsigned long long, THREADS> Scan;
  __shared__ typename Scan::TempStorage scan_tmp;
  const int row = blockIdx.x;
  const int src = src_of_row[row];
  if (src == -2) return;  // another launch writes this row
  long long* out_v = values + (size_t)row * C;
  bool* out_m = valid + (size_t)row * C;
  if (src < 0) {
    // C is a power of two >= 128: 16-byte stores zero the row
    longlong2* vrow = reinterpret_cast<longlong2*>(out_v);
    uint4* mrow = reinterpret_cast<uint4*>(out_m);
    for (int i = threadIdx.x; i < C / 2; i += THREADS)
      vrow[i] = make_longlong2(0, 0);
    for (int i = threadIdx.x; i < C / 16; i += THREADS)
      mrow[i] = make_uint4(0, 0, 0, 0);
    return;
  }
  const D* l_g = lanes + (size_t)src * C;
  const unsigned char* b_g = bits + (size_t)src * (C / 8);
  RunningPrefix prefix{IDS ? 0ull
                           : static_cast<unsigned long long>(bases[src])};
  for (int base = 0; base < C; base += TILE) {
    const int c0 = base + threadIdx.x * ITEMS;
    unsigned long long v[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      // unsigned types zero-extend, signed ones sign-extend: the int64
      // cast of the reference
      v[j] = c0 + j < C ? static_cast<unsigned long long>(
                              static_cast<long long>(l_g[c0 + j]))
                        : 0ull;
    }
    if (!IDS) Scan(scan_tmp).InclusiveSum(v, v, prefix);
    if (c0 < C) {
      const unsigned long long m = b_g[c0 >> 3];
      unsigned long long mb = 0ull;  // bool j in byte j, little-endian
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        out_v[c0 + j] = static_cast<long long>(v[j]);
        mb |= ((m >> j) & 1ull) << (8 * j);
      }
      // 8 validity bytes of one thread: one 8-byte store
      *reinterpret_cast<unsigned long long*>(out_m + c0) = mb;
    }
    if (!IDS) __syncthreads();  // scan_tmp reuse
  }
}

template <typename D, bool IDS>
cudaError_t launch(const void* lanes, const void* bits, const void* bases,
                   const void* src_of_row, void* values, void* valid, int B,
                   int C, cudaStream_t stream) {
  decode_value_kernel<D, IDS><<<B, THREADS, 0, stream>>>(
      static_cast<const D*>(lanes), static_cast<const unsigned char*>(bits),
      static_cast<const long long*>(bases),
      static_cast<const int*>(src_of_row), static_cast<long long*>(values),
      static_cast<bool*>(valid), C);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 uint8, 1 uint16, 2 int32, 3 int8, 4 int16, 5 int64 lanes;
// ids_mode: 0 = value mode (deltas + bases), 1 = id mode (int32 ids,
// bases unused).  C is a power of two >= 128.  Returns cudaError_t.
extern "C" int decode_value(const void* lanes, int dtype, int ids_mode,
                            const void* bits, const void* bases,
                            const void* src_of_row, void* values,
                            void* valid, int B, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ids_mode)
    return dtype == 2 ? launch<int32_t, true>(lanes, bits, bases, src_of_row,
                                              values, valid, B, C, s)
                      : cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch<uint8_t, false>(lanes, bits, bases, src_of_row, values,
                                    valid, B, C, s);
    case 1:
      return launch<uint16_t, false>(lanes, bits, bases, src_of_row, values,
                                     valid, B, C, s);
    case 2:
      return launch<int32_t, false>(lanes, bits, bases, src_of_row, values,
                                    valid, B, C, s);
    case 3:
      return launch<int8_t, false>(lanes, bits, bases, src_of_row, values,
                                   valid, B, C, s);
    case 4:
      return launch<int16_t, false>(lanes, bits, bases, src_of_row, values,
                                    valid, B, C, s);
    case 5:
      return launch<int64_t, false>(lanes, bits, bases, src_of_row, values,
                                    valid, B, C, s);
    default:
      return cudaErrorInvalidValue;
  }
}
