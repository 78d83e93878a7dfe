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
// B) and 1/8 B of bits and writes 9 B (int64 value + bool validity):
// 0.0329 ms for 128 blocks of 65,536 int32 deltas on an H100 (3.35 TB/s).
// What a trace of the former design showed (PERF.md §6): one CTA
// of 512 threads a row (128 CTAs, 16 warps a SM of 64), walking its row
// in 16 serial tiles with a block scan each, 8 consecutive entries a
// lane (scalar loads 32 B apart, int64 stores 64 B apart: every warp
// instruction touched 32 sectors): 0.1200 ms, 27% of its bound.
// Design: a flat grid of tiles of 4,096 entries (a row of fewer is one
// tile), a CTA of 256 threads each, in the id mode's layout: a thread
// takes quads (4 consecutive entries) q = j * 256 + t, j < 4, so every
// access of a warp is contiguous: one load of the quad's deltas (16 B of
// int32, 2 x 16 of int64, 8 of int16, 4 of int8), two 16-byte stores of
// values and one 4-byte store of validity (a nibble of its bits byte);
// all of a CTA's loads in flight at once.  The scan: each quad's sum, a
// warp shuffle scan of the four rounds' sums at once, the warps' totals
// through shared memory (one barrier), so each entry's prefix runs over
// consecutive entries.  The carry between a row's tiles: a decoupled
// look-back (Merrill and Garland, 2016, as in segment_reduce.cu), the
// tiles taken in order from an atomic ticket: a tile publishes its total,
// then its first warp adds its row's earlier tiles' totals back to one
// that has published its inclusive prefix, or to the row's start, and
// publishes its own.  The tickets go part by part across the rows, so
// that a tile's predecessor most often has its prefix out when the tile
// looks back.  One memset clears the ticket and the status words.
// Sums are unsigned 64-bit from bases[src] (wrapping like the
// reference's int64 cumsum); the delta type is a template parameter, so
// no widening pass runs first.
// Tried and dropped on the H100 (PERF.md §6; device ms at 128 x
// 65,536 int32 deltas): a thread-block cluster of 8 CTAs of 512 threads
// a row, each CTA's total read by the later ones through distributed
// shared memory after a cluster barrier (0.069; 16 CTAs of 256 0.072), a
// warp's prefix by a look-back through (distributed) shared memory
// (0.079), one CTA of 1,024 a row with the next tile's loads in flight
// (0.080), tiles of 8,192 (0.075-0.079), tickets row by row (0.073), 6
// CTAs a SM (0.105, spills), and a warp a tile of 512 with no barrier
// (0.0793-0.0794: its look-back waited 15 us longer than this one's; with
// tiles of 1,024 0.0728-0.0732, without its ticket 0.0766, 16 tiles a CTA
// of 512 0.0830-0.0832).  Tiles by block index without the ticket timed as
// this design (0.0659-0.0660), but are not safe: a tile can then spin on a
// predecessor whose CTA has not been scheduled, a deadlock that the
// ticket rules out.

// Id mode.  Bound: memory, 13.125 B an entry (the 4-byte id and 1/8 B
// of bits read, 9 B written): 0.0329 ms at 128 blocks of 65,536 on an
// H100 (3.35 TB/s).  It has no scan, so it did not inherit the value
// mode's first grid of one CTA a row (128 CTAs that fill at most a
// quarter of the card's warps, each thread walking 16 tiles in series)
// nor its lane layout (8 consecutive entries a lane: scalar loads 32 B
// apart and stores 64 B apart, so every warp instruction touched 32
// sectors).
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
#include <cstring>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int V_THREADS = 256;
constexpr int V_WARPS = V_THREADS / 32;
constexpr int V_QUADS = 4;                          // quads a thread a tile
constexpr int V_TILE = V_THREADS * V_QUADS * 4;     // entries: 4,096
// look-back status: a tile's flag word (below), then its total and its
// inclusive prefix, each at the word its flag names
constexpr unsigned long long ST_AGG = 1ull;         // the tile's total
constexpr unsigned long long ST_PREFIX = 2ull;      // its inclusive prefix

// A quad's deltas as loaded: 4 * sizeof(D) bytes, sizeof(D) words.
template <typename D>
struct Quad {
  unsigned w[sizeof(D)];
};

// The quad of deltas at p (4 consecutive, 4 * sizeof(D)-byte aligned): one
// load of 4, 8 or 16 bytes, two of 16 for int64.
template <typename D>
__device__ __forceinline__ Quad<D> load_quad(const D* p) {
  Quad<D> q;
  if constexpr (sizeof(D) == 8) {
    const uint4 u = reinterpret_cast<const uint4*>(p)[0];
    const uint4 v = reinterpret_cast<const uint4*>(p)[1];
    memcpy(q.w, &u, 16);
    memcpy(q.w + 4, &v, 16);
  } else if constexpr (sizeof(D) == 4) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    memcpy(q.w, &u, 16);
  } else if constexpr (sizeof(D) == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    memcpy(q.w, &u, 8);
  } else {
    q.w[0] = *reinterpret_cast<const unsigned*>(p);
  }
  return q;
}

// The quad's deltas widened to unsigned 64 bits: unsigned types
// zero-extend, signed ones sign-extend (the int64 cast of the reference).
template <typename D>
__device__ __forceinline__ void widen(const Quad<D>& q,
                                      unsigned long long (&d)[4]) {
  D e[4];
  memcpy(e, q.w, sizeof e);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    d[j] = static_cast<unsigned long long>(static_cast<long long>(e[j]));
}

template <typename D>
__device__ __forceinline__ unsigned long long quad_sum(const Quad<D>& q) {
  unsigned long long d[4];
  widen(q, d);
  return d[0] + d[1] + d[2] + d[3];
}

// The exclusive prefix of each of the thread's V_QUADS quad sums s[j]
// within the tile (rounds j in order, quads of a round in thread order),
// in pre[j]; returns the tile's total.  All threads must call it.
__device__ __forceinline__ unsigned long long tile_prefix(
    const unsigned long long (&s)[V_QUADS], unsigned long long (&pre)[V_QUADS],
    unsigned long long (*s_warp)[V_WARPS]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long inc[V_QUADS];
#pragma unroll
  for (int j = 0; j < V_QUADS; ++j) inc[j] = s[j];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int j = 0; j < V_QUADS; ++j) {
      const unsigned long long y = __shfl_up_sync(FULL, inc[j], d);
      if (lane >= d) inc[j] += y;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int j = 0; j < V_QUADS; ++j) s_warp[j][warp] = inc[j];
  }
  __syncthreads();
  // each warp scans the warps' totals of every round: lane w < V_WARPS
  // holds warp w's
  unsigned long long wt[V_QUADS], wi[V_QUADS];
#pragma unroll
  for (int j = 0; j < V_QUADS; ++j)
    wi[j] = wt[j] = lane < V_WARPS ? s_warp[j][lane] : 0ull;
#pragma unroll
  for (int d = 1; d < V_WARPS; d <<= 1) {
#pragma unroll
    for (int j = 0; j < V_QUADS; ++j) {
      const unsigned long long y = __shfl_up_sync(FULL, wi[j], d);
      if (lane >= d) wi[j] += y;
    }
  }
  unsigned long long run = 0ull;
#pragma unroll
  for (int j = 0; j < V_QUADS; ++j) {
    const unsigned long long wex =
        __shfl_sync(FULL, wi[j] - wt[j], warp);  // warps before this one
    pre[j] = run + wex + inc[j] - s[j];
    run += __shfl_sync(FULL, wi[j], V_WARPS - 1);  // the round's total
  }
  return run;
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// Writes quad q of the CTA's part: values from the exclusive prefix x0
// and the quad's deltas, validity from its nibble of its bits byte.
template <typename D>
__device__ __forceinline__ void store_quad(long long* out_v, bool* out_m,
                                           int q, unsigned long long x0,
                                           const Quad<D>& raw,
                                           unsigned byte) {
  unsigned long long d[4];
  widen(raw, d);
  const unsigned long long v0 = x0 + d[0], v1 = v0 + d[1], v2 = v1 + d[2],
                           v3 = v2 + d[3];
  longlong2* vq = reinterpret_cast<longlong2*>(out_v) + 2 * q;
  vq[0] = make_longlong2((long long)v0, (long long)v1);
  vq[1] = make_longlong2((long long)v2, (long long)v3);
  // the quad's nibble, bool j in byte j
  const unsigned nib = (byte >> ((q & 1) * 4)) & 0xfu;
  reinterpret_cast<unsigned*>(out_m)[q] =
      (nib & 1u) | ((nib & 2u) << 7) | ((nib & 4u) << 14) |
      ((nib & 8u) << 21);
}

// Two CTAs a SM (at most 64 registers a thread) but for int64 deltas,
// whose quads take twice the registers.
template <typename D>
__global__ void __launch_bounds__(V_THREADS) decode_value_kernel(
    const D* __restrict__ lanes,               // [b, C] deltas
    const unsigned char* __restrict__ bits,    // [b, C/8]
    const long long* __restrict__ bases,       // [b]
    const int* __restrict__ src_of_row,        // [B] block, -1 zero, -2 skip
    long long* __restrict__ values,            // [B, C]
    bool* __restrict__ valid,                  // [B, C]
    unsigned long long* status,  // [1 + 3 * ntiles]: the ticket, then a
                                 // flag, a total and a prefix word a tile
    int B, int C, int log2_tpr) {  // tiles a row, log2
  __shared__ unsigned long long s_warp[V_QUADS][V_WARPS];
  __shared__ unsigned long long s_carry;
  __shared__ int s_tile;
  if (threadIdx.x == 0)
    s_tile = (int)atomicAdd(status, 1ull);  // the ticket: tiles in order
  __syncthreads();
  // tiles in order part by part across the rows, so a tile's predecessor
  // in its row took its ticket B tiles before and has most likely
  // published its prefix by the time the tile looks back
  const int tile = s_tile;
  const int row = tile % B;
  const int part = tile / B;
  const int span = C >> log2_tpr;          // entries a tile
  const int src = src_of_row[row];
  // every tile of a row takes the same branch, so none waits on another
  if (src == -2) return;  // another launch writes this row
  const long long c0 = (long long)part * span;
  long long* out_v = values + (size_t)row * C + c0;
  bool* out_m = valid + (size_t)row * C + c0;
  if (src < 0) {
    // span is a multiple of 16: 16-byte stores zero the part
    for (int i = threadIdx.x; i < span / 2; i += V_THREADS)
      reinterpret_cast<longlong2*>(out_v)[i] = make_longlong2(0, 0);
    for (int i = threadIdx.x; i < span / 16; i += V_THREADS)
      reinterpret_cast<uint4*>(out_m)[i] = make_uint4(0, 0, 0, 0);
    return;
  }
  const D* l_g = lanes + (size_t)src * C + c0;
  const unsigned char* b_g = bits + ((size_t)src * C + c0) / 8;
  const int nq = span / 4;                 // quads of the tile
  Quad<D> d[V_QUADS];
  unsigned long long sq[V_QUADS], pre[V_QUADS];
  unsigned byte[V_QUADS];
#pragma unroll
  for (int j = 0; j < V_QUADS; ++j) {
    const int q = j * V_THREADS + threadIdx.x;
    if (q < nq) {
      d[j] = load_quad(l_g + 4 * (size_t)q);
      byte[j] = b_g[q >> 1];
    }
  }
#pragma unroll
  for (int j = 0; j < V_QUADS; ++j)
    sq[j] = j * V_THREADS + (int)threadIdx.x < nq ? quad_sum(d[j]) : 0ull;
  const unsigned long long total = tile_prefix(sq, pre, s_warp);
  // the tile's carry: the base, and its row's earlier tiles' totals
  unsigned long long* st = status + 1;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    unsigned long long carry = static_cast<unsigned long long>(bases[src]);
    if (part == 0) {
      if (lane == 0 && log2_tpr > 0) {
        st[3 * tile + 2] = carry + total;
        st_release(st + 3 * tile, ST_PREFIX);
      }
    } else {
      if (lane == 0) {
        st[3 * tile + 1] = total;
        st_release(st + 3 * tile, ST_AGG);
      }
      // back over the row's earlier tiles (B apart), 32 at a time, to an
      // inclusive prefix or the row's first tile (whose prefix includes
      // the base)
      unsigned long long excl = 0ull;
      for (int top = part - 1;; top -= 32) {
        const bool mine = top - lane >= 0;
        const int j = (top - lane) * B + row;
        unsigned long long f = mine ? ld_acquire(st + 3 * j) : ST_PREFIX;
        // wait until each has published
        while (__any_sync(FULL, f == 0ull))
          if (f == 0ull) f = ld_acquire(st + 3 * j);
        // its total, or its prefix (a word of its own, so that a tile
        // that publishes its prefix after this read of its flag leaves
        // the total this read takes as it was)
        const unsigned long long v =
            mine ? *(volatile unsigned long long*)(st + 3 * j + f) : 0ull;
        const unsigned pre_ = __ballot_sync(FULL, f == ST_PREFIX);
        const int stop = pre_ ? __ffs(pre_) - 1 : 31;
        unsigned long long c = lane <= stop ? v : 0ull;
#pragma unroll
        for (int o = 16; o; o >>= 1) c += __shfl_xor_sync(FULL, c, o);
        excl += c;
        if (pre_) break;
      }
      carry = excl;
      if (lane == 0 && part < (1 << log2_tpr) - 1) {
        st[3 * tile + 2] = carry + total;
        st_release(st + 3 * tile, ST_PREFIX);
      }
    }
    if (lane == 0) s_carry = carry;
  }
  __syncthreads();
  const unsigned long long carry = s_carry;
#pragma unroll
  for (int j = 0; j < V_QUADS; ++j) {
    const int q = j * V_THREADS + threadIdx.x;
    if (q < nq) store_quad(out_v, out_m, q, carry + pre[j], d[j], byte[j]);
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
                   const void* src_of_row, void* values, void* valid,
                   void* status, int B, int C, cudaStream_t stream) {
  // tiles of V_TILE entries; a row of fewer is one tile
  const int log2_tpr = C > V_TILE ? __builtin_ctz((unsigned)(C / V_TILE)) : 0;
  const long long ntiles = (long long)B << log2_tpr;
  cudaError_t err = cudaMemsetAsync(
      status, 0, (size_t)(1 + 3 * ntiles) * sizeof(unsigned long long),
      stream);
  if (err != cudaSuccess) return err;
  decode_value_kernel<D><<<(unsigned)ntiles, V_THREADS, 0, stream>>>(
      static_cast<const D*>(lanes), static_cast<const unsigned char*>(bits),
      static_cast<const long long*>(bases),
      static_cast<const int*>(src_of_row), static_cast<long long*>(values),
      static_cast<bool*>(valid), static_cast<unsigned long long*>(status), B,
      C, log2_tpr);
  return cudaGetLastError();
}

}  // namespace

// Value mode: one memset of the status words and the kernel.  dtype: 0
// uint8, 1 uint16, 2 int32, 3 int8, 4 int16, 5 int64 deltas.  C is a
// power of two >= 128; lanes and values 16-byte aligned, valid 4-byte
// aligned; status holds nstatus >= 1 + 3 * B * max(1, C / 4,096) words.
// Returns cudaError_t.
extern "C" int decode_value(const void* lanes, int dtype, const void* bits,
                            const void* bases, const void* src_of_row,
                            void* values, void* valid, void* status,
                            long long nstatus, int B, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C < 128 || (C & (C - 1)) || B < 1 ||
      ((uintptr_t)lanes | (uintptr_t)values) % 16 || (uintptr_t)valid % 4 ||
      nstatus < 1 + 3ll * B * (C > V_TILE ? C / V_TILE : 1))
    return cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch<uint8_t>(lanes, bits, bases, src_of_row, values, valid,
                             status, B, C, s);
    case 1:
      return launch<uint16_t>(lanes, bits, bases, src_of_row, values, valid,
                              status, B, C, s);
    case 2:
      return launch<int32_t>(lanes, bits, bases, src_of_row, values, valid,
                             status, B, C, s);
    case 3:
      return launch<int8_t>(lanes, bits, bases, src_of_row, values, valid,
                            status, B, C, s);
    case 4:
      return launch<int16_t>(lanes, bits, bases, src_of_row, values, valid,
                             status, B, C, s);
    case 5:
      return launch<int64_t>(lanes, bits, bases, src_of_row, values, valid,
                             status, B, C, s);
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
