// K6 decode_value: value and str-id column decode for a batch of blocks.
//
// Replaces sybil_tpu/ops/decode.py:_decode_value_jit (value mode) and
// _decode_ids_jit (id mode), and, for these encodings, the reassembly
// gather of decode_column_batch.  A value container stores an int
// column as deltas (int8/16/32 or int64, blocks.py:_narrow) from a base
// kept in the column meta, and its validity as little-endian packed
// bits; a str-value container (a str column of more than
// CARDINALITY_THRESHOLD distinct values a block: user ids, URLs) stores
// int32 dict ids and the same bits.  For entry c of a block:
//     value mode: out[c] = base + sum(deltas[0..c])   (int64, wrapping)
//     id mode:    out[c] = ids[c]                     (widened)
//     valid[c] = (bits[c / 8] >> (c % 8)) & 1
// The host zero-pads deltas and ids past a block's records, so in value
// mode entries in [nrec, C) hold the carried last value, as the
// reference's cumsum gives.  src_of_row maps each row of the [B, C]
// output to its block; -1 marks a row whose block lacks the column
// (zeroed here) and -2 a row that another launch writes (left alone).
//
// Value mode.  Bound: memory.  Per entry the block reads its delta (1-8
// B) and 1/8 B of bits and writes 9 B (int64 value + bool validity).
// Design: one CTA per OUTPUT row, as K1.  Each thread takes 8
// consecutive entries, so its validity is exactly one byte of bits, and
// the CTA walks the row in tiles of 4096 entries with a running
// cub::BlockScan of unsigned 64-bit sums (wrapping like the reference's
// int64 cumsum); the delta type is a template parameter, so no widening
// pass runs first.
//
// Id mode.  Bound: memory, 13.125 B an entry (the 4-byte id and 1/8 B
// of bits read, 9 B written): 0.0329 ms at 128 blocks of 65,536 on an
// H100 (3.35 TB/s).  It has no scan, so it does not inherit the value
// mode's grid of one CTA a row (128 CTAs that fill at most a quarter of
// the card's warps, each thread walking 16 tiles in series) nor its
// lane layout (8 consecutive entries a lane: scalar loads 32 B apart
// and stores 64 B apart, so every warp instruction touched 32 sectors).
// Its own kernel runs a flat grid over quads (4 consecutive entries) of
// the whole [B, C] output, 4 quads a thread, a CTA per 4,096 entries
// (2,048 CTAs at that shape).  A quad is one 16-byte load of ids, two
// 16-byte stores of values and one 4-byte store of validity (a nibble of
// its bits byte), neighbouring lanes on neighbouring quads: every access
// of a warp is contiguous.  C >= 128 is a power of two, so a quad never
// crosses a row and every row starts 512-byte aligned for the ids and
// 16-byte aligned for the bits (the wrapper checks the base pointers).

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

template <typename D>
__global__ void __launch_bounds__(THREADS) decode_value_kernel(
    const D* __restrict__ lanes,               // [b, C] deltas
    const unsigned char* __restrict__ bits,    // [b, C/8]
    const long long* __restrict__ bases,       // [b]
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
  RunningPrefix prefix{static_cast<unsigned long long>(bases[src])};
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
    Scan(scan_tmp).InclusiveSum(v, v, prefix);
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
    __syncthreads();  // scan_tmp reuse
  }
}

// Id mode: quad q of the flat [B, C] output (entries 4q..4q+3).
constexpr int ID_THREADS = 256;
constexpr int ID_QUADS = 4;  // quads a thread
constexpr int ID_TILE = ID_THREADS * ID_QUADS;  // quads a CTA

__global__ void __launch_bounds__(ID_THREADS) decode_ids_kernel(
    const int4* __restrict__ ids,            // [b, C/4] quads of ids
    const unsigned char* __restrict__ bits,  // [b, C/8]
    const int* __restrict__ src_of_row,      // [B] block, -1 zero, -2 skip
    longlong2* __restrict__ values,          // [B, C/2]
    unsigned* __restrict__ valid,            // [B, C/4] 4 bools a word
    int log2_quads,                          // log2(C / 4)
    long long nquads) {                      // B * C / 4
  const long long q0 = (long long)blockIdx.x * ID_TILE + threadIdx.x;
  int4 id[ID_QUADS];
  unsigned char m[ID_QUADS];
  int src[ID_QUADS];
  // every load first, so a thread has its 4 quads in flight at once
#pragma unroll
  for (int j = 0; j < ID_QUADS; ++j) {
    const long long q = q0 + j * ID_THREADS;
    src[j] = q < nquads ? src_of_row[q >> log2_quads] : -2;
    if (src[j] >= 0) {
      const long long sq =
          ((long long)src[j] << log2_quads) + (q & ((1ll << log2_quads) - 1));
      id[j] = ids[sq];
      m[j] = bits[sq >> 1];
    }
  }
#pragma unroll
  for (int j = 0; j < ID_QUADS; ++j) {
    const long long q = q0 + j * ID_THREADS;
    if (src[j] == -2) continue;  // another launch writes this row
    if (src[j] < 0) {
      values[2 * q] = make_longlong2(0, 0);
      values[2 * q + 1] = make_longlong2(0, 0);
      valid[q] = 0u;
      continue;
    }
    // int -> long long sign-extends: the reference's astype(int64)
    values[2 * q] = make_longlong2(id[j].x, id[j].y);
    values[2 * q + 1] = make_longlong2(id[j].z, id[j].w);
    // the quad's nibble of its bits byte, bool j in byte j
    const unsigned nib = (m[j] >> ((q & 1) * 4)) & 0xfu;
    valid[q] = (nib & 1u) | ((nib & 2u) << 7) | ((nib & 4u) << 14) |
               ((nib & 8u) << 21);
  }
}

template <typename D>
cudaError_t launch(const void* lanes, const void* bits, const void* bases,
                   const void* src_of_row, void* values, void* valid, int B,
                   int C, cudaStream_t stream) {
  decode_value_kernel<D><<<B, THREADS, 0, stream>>>(
      static_cast<const D*>(lanes), static_cast<const unsigned char*>(bits),
      static_cast<const long long*>(bases),
      static_cast<const int*>(src_of_row), static_cast<long long*>(values),
      static_cast<bool*>(valid), C);
  return cudaGetLastError();
}

}  // namespace

// Value mode.  dtype: 0 uint8, 1 uint16, 2 int32, 3 int8, 4 int16, 5
// int64 deltas.  C is a power of two >= 128.  Returns cudaError_t.
extern "C" int decode_value(const void* lanes, int dtype, const void* bits,
                            const void* bases, const void* src_of_row,
                            void* values, void* valid, int B, int C,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<uint8_t>(lanes, bits, bases, src_of_row, values, valid,
                             B, C, s);
    case 1:
      return launch<uint16_t>(lanes, bits, bases, src_of_row, values, valid,
                              B, C, s);
    case 2:
      return launch<int32_t>(lanes, bits, bases, src_of_row, values, valid,
                             B, C, s);
    case 3:
      return launch<int8_t>(lanes, bits, bases, src_of_row, values, valid,
                            B, C, s);
    case 4:
      return launch<int16_t>(lanes, bits, bases, src_of_row, values, valid,
                             B, C, s);
    case 5:
      return launch<int64_t>(lanes, bits, bases, src_of_row, values, valid,
                             B, C, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Id mode: int32 ids [b, C], bits [b, C/8].  C is a power of two >= 128;
// ids and values 16-byte aligned, valid 4-byte aligned.  Returns
// cudaError_t.
extern "C" int decode_ids(const void* ids, const void* bits,
                          const void* src_of_row, void* values, void* valid,
                          int B, int C, void* stream) {
  if (C < 128 || (C & (C - 1)) ||
      ((uintptr_t)ids | (uintptr_t)values) % 16 || (uintptr_t)valid % 4)
    return cudaErrorInvalidValue;
  const long long nquads = (long long)B * (C / 4);
  const int log2_quads = __builtin_ctz((unsigned)C) - 2;
  const long long grid = (nquads + ID_TILE - 1) / ID_TILE;
  decode_ids_kernel<<<(unsigned)grid, ID_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(ids), static_cast<const unsigned char*>(bits),
      static_cast<const int*>(src_of_row), static_cast<longlong2*>(values),
      static_cast<unsigned*>(valid), log2_quads, nquads);
  return cudaGetLastError();
}
