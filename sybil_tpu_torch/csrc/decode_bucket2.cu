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
// with cum the inclusive prefix sum of the deltas' int32 casts.  In v2,
// cum[p] - cum[start] is the sum of the deltas after the segment's first
// posting through p: a scan that restarts at each segment's first
// posting.
//
// Bound: memory.  The block reads its deltas (1-8 B per posting) and
// writes 9 B per output row (int64 value + bool validity); everything
// else is small.  src_of_row maps each output row to its block; -1 marks
// a row whose block lacks the column (zeroed here) and -2 a row that
// another launch of the batch writes (a block of another encoding: left
// alone).  Rows scatter straight into the block's row of the output, so
// no gather reassembles block order afterwards.
//
// What a trace of the former design showed (PERF.md §6, PR 15;
// torch.profiler on the H100): one CTA of 256 threads an output row (128
// CTAs for 132 SMs) zeroed its 590 KB row, then walked the block's
// postings in order, 1,024 a step behind a running block scan, with a
// binary search over K a posting: 577 us for config 1's `ping` at
// 8,388,608 rows, 508 us for `host`, of which the zeroing alone takes 25.
//
// Design: one memset (the ticket and the look-back status words) and two
// launches.
//   A. bucket_scan: B * NT units of TILE postings, NT = ceil(P / TILE) a
//      row, each a CTA that takes its unit from an atomic ticket, so that
//      every unit before it has started.  A unit loads its postings'
//      deltas (ITEMS consecutive a thread); finds the slots by two binary
//      searches (its first and last posting), then one thread a slot
//      between them marks the posting where that slot's segment starts
//      (offsets walked, not searched); scans (slot, restart, sum) over the
//      unit, the slot carried forward from the last segment start, the v2
//      sum restarted there; takes the sum carried into its first segment
//      (v2: only when that segment began in an earlier unit; v1: always)
//      by decoupled look-back over the row's earlier units (Merrill and
//      Garland, 2016), as K8 and K15 do: a status word a unit, a warp
//      reading 32 at a time (a v2 unit that holds a segment start
//      publishes its inclusive word at once).  Then it sorts its postings
//      in shared memory by the slice of NR row ranges their row falls in
//      and writes them, (row, slot) in 8 bytes, to scratch, a slice's run
//      contiguous, with the count of each slice.
//   B. bucket_rows: a CTA a (row range, output row) gathers the range's
//      postings from every unit of the block (a warp a unit, its run of
//      that slice) into a shared copy of the range, zeroed first, and
//      writes the range out with 16-byte stores.  So each output byte is
//      written once, in full lines, and the scattered stores go to shared
//      memory.
// A one-launch form of A that zeroed the next row and then scattered
// each posting to the output took 0.245 ms at config 1's ping, 0.18 of
// it the 15 million scattered 8-byte and 1-byte stores (PERF.md §6, PR
// 15); the two launches take 0.16.
// The delta type and the layout are template parameters, so no widening
// pass runs first.

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;     // postings a unit
constexpr int NR = 32;                    // row ranges a row (at most)
constexpr unsigned FULL = 0xffffffffu;
// look-back status words: a flag in the top two bits, bit 61 set when a
// segment starts in the words' span (v2), the span's sum in the low 32
constexpr unsigned long long FLAG_AGG = 1ull << 62;
constexpr unsigned long long FLAG_PREFIX = 2ull << 62;
constexpr unsigned long long HEAD_BIT = 1ull << 61;
// a.paths (optional) counts, for the checks: v2 units whose first
// segment began in an earlier unit (a cut segment), and units whose
// look-back read more than one earlier unit's word
enum { P_CUT, P_MULTI };

// One posting of the scan: the slot of the last segment start at or
// before it (-1: none in the unit yet), whether the v2 sum restarts at
// or before it, and the sum since.
struct Item {
  int slot;
  unsigned head;
  unsigned sum;
};

struct ItemOp {
  __device__ __forceinline__ Item operator()(const Item& x,
                                             const Item& y) const {
    return {max(x.slot, y.slot), x.head | y.head,
            y.head ? y.sum : x.sum + y.sum};
  }
};

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

// First index of offsets[0, K) greater than p (side="right").
__device__ __forceinline__ int search_right(const int* off, int K, int p) {
  int lo = 0, hi = K;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (off[mid] <= p) lo = mid + 1; else hi = mid;
  }
  return lo;
}

struct K1Args {
  const void* deltas;               // [b, P]
  const int* counts;                // [b] postings per block
  const int* offsets;               // [b, K] CSR offsets[1:], 2^31-1 pad
  const long long* uniq;            // [b, K]
  const int* bases;                 // v2: seg_bases [b, K]; v1: [b]
  const int* src_of_row;            // [B] block, -1 zero, -2 skip
  long long* values;                // [B, C]
  bool* valid;                      // [B, C]
  unsigned long long* ws;           // [1 + B * NT], zeroed: the ticket,
                                    // a status word a unit
  int2* pairs;                      // [B, NT * TILE] (row, slot), a
                                    // unit's postings by row range
  int* rcount;                      // [B, NT, nr] postings a unit a range
  unsigned long long* paths;        // [2] or null
  int B, P, K, C, NT;
  int nr, lw;                       // row ranges a row, log2 of their rows
};

template <typename D, bool V1>
__global__ void __launch_bounds__(THREADS) bucket_scan(const K1Args a) {
  typedef cub::BlockScan<Item, THREADS> Scan;
  __shared__ typename Scan::TempStorage scan_tmp;
  __shared__ int s_head[TILE];     // the slot starting at a posting
  __shared__ int s_unit, s_lo, s_hi;
  __shared__ unsigned s_csum;
  __shared__ int s_rc[NR];         // postings a row range
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) s_unit = (int)atomicAdd(a.ws, 1ull);  // the ticket
  __syncthreads();
  const int unit = s_unit;
  const int row = unit / a.NT, part = unit - row * a.NT;
  unsigned long long* status = a.ws + 1;
  const int src = a.src_of_row[row];
  if (src < 0) return;  // zeroed (-1) or another launch's (-2)
  const int n = a.counts[src];
  const int T = part * TILE;
  if (T >= n) return;

  // the unit's deltas, ITEMS consecutive postings a thread
  const D* d_g = static_cast<const D*>(a.deltas) + (size_t)src * a.P;
  const int* off = a.offsets + (size_t)src * a.K;
  const int p0 = T + tid * ITEMS;
  unsigned x[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    // unsigned types zero-extend, signed ones sign-extend, int64 keeps
    // its low 32 bits: the int32 cast of the reference's cumsum
    x[j] = p0 + j < n ? static_cast<unsigned>(static_cast<int>(d_g[p0 + j]))
                      : 0u;

  // the slots: the segment starts inside the unit
  for (int i = tid; i < TILE; i += THREADS) s_head[i] = -1;
  const int last = min(T + TILE, n) - 1;
  if (tid == 0) s_lo = search_right(off, a.K, T);
  if (tid == 32) s_hi = search_right(off, a.K, last);
  __syncthreads();
  const int lo = s_lo, hi = s_hi;
  // slots (lo, hi] start at offsets[s - 1] in (T, last]; empty segments
  // share a start, and the posting's slot is the largest
  for (int s = lo + 1 + tid; s <= hi; s += THREADS) {
    const int q = off[s - 1] - T;
    if (q > 0 && q < TILE) atomicMax(&s_head[q], s);  // sorted offsets
  }
  const bool first_head = (lo == 0 ? 0 : off[lo - 1]) == T;
  if (tid == 0 && first_head) atomicMax(&s_head[0], lo);
  __syncthreads();

  // (slot, restart, sum) over the unit
  Item it[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int h = s_head[tid * ITEMS + j];
    const unsigned st = (!V1 && h >= 0) ? 1u : 0u;
    it[j] = {h, st, st ? 0u : x[j]};
  }
  Item agg;
  Scan(scan_tmp).InclusiveScan(it, it, ItemOp(), agg);

  // the sum carried into the unit's first segment: v1 always, v2 when
  // that segment began in an earlier unit
  if (tid < 32) {
    unsigned long long* st = status + (size_t)row * a.NT;
    const unsigned long long own =
        (agg.head ? HEAD_BIT : 0ull) | (unsigned long long)agg.sum;
    unsigned csum = 0u, chead = 0u;
    if (lane == 0)
      // nothing before it, or (v2) a segment starts in it: its own words
      // are the prefix its successors need
      st_release(st + part,
                 (part == 0 || agg.head ? FLAG_PREFIX : FLAG_AGG) | own);
    if (part > 0 && (V1 || !first_head)) {
      int reads = 0;
      for (int top = part - 1;; top -= 32) {
        const int j = top - lane;
        unsigned long long w = j >= 0 ? ld_acquire(st + j) : FLAG_PREFIX;
        while (__any_sync(FULL, (w >> 62) == 0))
          if ((w >> 62) == 0) w = ld_acquire(st + j);
        // the nearest unit that ends the fold: a prefix, or a segment
        // start inside it
        const unsigned stop_m =
            __ballot_sync(FULL, (w >> 62) == 2 || (w & HEAD_BIT));
        const int stop = stop_m ? __ffs(stop_m) - 1 : 31;
        unsigned v = lane <= stop ? (unsigned)w : 0u;
        for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
        csum += v;
        const unsigned long long wstop = __shfl_sync(FULL, w, stop);
        reads += stop + 1;
        if (stop_m) {
          chead = (wstop & HEAD_BIT) ? 1u : 0u;
          break;
        }
      }
      if (lane == 0) {
        if (!agg.head)  // publish the inclusive words
          st_release(st + part,
                     FLAG_PREFIX | (chead ? HEAD_BIT : 0ull) |
                         (unsigned long long)(csum + agg.sum));
        if (a.paths) {
          if (!V1) atomicAdd(a.paths + P_CUT, 1ull);
          if (reads > 1) atomicAdd(a.paths + P_MULTI, 1ull);
        }
      }
    }
    if (lane == 0) s_csum = csum;
  }
  __syncthreads();  // also: every thread has read s_head

  // each posting's row and slot, and its row range's rank
  if (tid < a.nr) s_rc[tid] = 0;
  __syncthreads();
  const unsigned csum = s_csum;
  const unsigned id_base = V1 ? static_cast<unsigned>(a.bases[src]) : 0u;
  int id[ITEMS], rank[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int slot = it[j].slot >= 0 ? it[j].slot : lo;
    const unsigned sum = it[j].head ? it[j].sum : csum + it[j].sum;
    it[j].slot = min(slot, a.K - 1);
    id[j] = V1 ? static_cast<int>(id_base + sum)
               : static_cast<int>(static_cast<unsigned>(
                     a.bases[(size_t)src * a.K + it[j].slot]) + sum);
    if (p0 + j >= n || id[j] < 0 || id[j] >= a.C) id[j] = -1;
    rank[j] = id[j] >= 0 ? atomicAdd(&s_rc[id[j] >> a.lw], 1) : 0;
  }
  __syncthreads();
  // the ranges' counts to global, their starts in the unit's run
  int* rc_g = a.rcount + ((size_t)row * a.NT + part) * a.nr;
  if (tid < 32) {
    const int c = lane < a.nr ? s_rc[lane] : 0;
    int x = c;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, x, d);
      if (lane >= d) x += y;
    }
    if (lane < a.nr) {
      rc_g[lane] = c;
      s_rc[lane] = x - c;
    }
  }
  __syncthreads();
  int2* out = a.pairs + (size_t)row * a.NT * TILE + (size_t)part * TILE;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    if (id[j] >= 0)
      out[s_rc[id[j] >> a.lw] + rank[j]] = make_int2(id[j], it[j].slot);
}

// B: a CTA a (row range, output row): the range's postings from every
// unit of the row's block into a shared copy of the range, then the range
// out with 16-byte stores (zeros where no posting lands).
__global__ void __launch_bounds__(THREADS) bucket_rows(const K1Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = 1 << a.lw;
  long long* s_v = reinterpret_cast<long long*>(smem);      // [W]
  unsigned char* s_m = reinterpret_cast<unsigned char*>(s_v + W);
  const int r = blockIdx.x, row = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int src = a.src_of_row[row];
  if (src == -2) return;  // another launch writes this row
  longlong2* vo = reinterpret_cast<longlong2*>(
      a.values + (size_t)row * a.C + ((size_t)r << a.lw));
  uint4* mo = reinterpret_cast<uint4*>(a.valid + (size_t)row * a.C +
                                       ((size_t)r << a.lw));
  if (src < 0) {  // a missing block: zeros
    for (int i = tid; i < W / 2; i += THREADS) vo[i] = make_longlong2(0, 0);
    for (int i = tid; i < W / 16; i += THREADS) mo[i] = make_uint4(0, 0, 0, 0);
    return;
  }
  for (int i = tid; i < W; i += THREADS) {
    s_v[i] = 0;
    s_m[i] = 0;
  }
  __syncthreads();
  const int nu = (a.counts[src] + TILE - 1) / TILE;
  const long long* uq = a.uniq + (size_t)src * a.K;
  const int r0 = r << a.lw;
  for (int u = warp; u < nu; u += THREADS / 32) {
    // the unit's run of range r: after the runs of ranges < r
    const int* rc = a.rcount + ((size_t)row * a.NT + u) * a.nr;
    const int c = lane < a.nr ? rc[lane] : 0;
    int x = c;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, x, d);
      if (lane >= d) x += y;
    }
    const int start = __shfl_sync(FULL, x - c, r);
    const int cnt = __shfl_sync(FULL, c, r);
    const int2* run =
        a.pairs + (size_t)row * a.NT * TILE + (size_t)u * TILE + start;
    for (int i = lane; i < cnt; i += 32) {
      const int2 e = run[i];
      s_v[e.x - r0] = uq[e.y];
      s_m[e.x - r0] = 1;
    }
  }
  __syncthreads();
  const longlong2* vs = reinterpret_cast<const longlong2*>(s_v);
  const uint4* ms = reinterpret_cast<const uint4*>(s_m);
  for (int i = tid; i < W / 2; i += THREADS) vo[i] = vs[i];
  for (int i = tid; i < W / 16; i += THREADS) mo[i] = ms[i];
}

template <typename D>
cudaError_t launch(int v1, const K1Args& a, cudaStream_t s) {
  const int units = a.B * a.NT;
  if (v1)
    bucket_scan<D, true><<<units, THREADS, 0, s>>>(a);
  else
    bucket_scan<D, false><<<units, THREADS, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t shm = (size_t)9 << a.lw;
  err = cudaFuncSetAttribute(bucket_rows,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)shm);
  if (err != cudaSuccess) return err;
  bucket_rows<<<dim3(a.nr, a.B), THREADS, shm, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 uint8, 1 uint16, 2 int32, 3 int8, 4 int16, 5 int64 deltas.
// v1: 0 = v2 layout (bases = seg_bases [b, K]), 1 = v1 layout (bases =
// id_base [b]).  scratch: decode_bucket2_scratch(B, P, C) int64 words (the
// ticket and status words, zeroed here; the postings by row range; their
// counts); paths: [2] int64 or null.  C is a power of two in [128, 2^19].
// Returns cudaError_t.
extern "C" long long decode_bucket2_scratch(int B, int P, int C) {
  const long long nt = P <= TILE ? 1 : (P + TILE - 1) / TILE;
  const long long nr = min(NR, C / 16);
  return 1 + B * nt + B * nt * TILE + (B * nt * nr + 1) / 2;
}

extern "C" int decode_bucket2(const void* deltas, int dtype, int v1,
                              const void* counts, const void* offsets,
                              const void* uniq, const void* bases,
                              const void* src_of_row, void* values,
                              void* valid, void* scratch, void* paths, int B,
                              int P, int K, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C < 128 || C > (1 << 19) || (C & (C - 1)) || K < 1)
    return cudaErrorInvalidValue;
  K1Args a;
  a.deltas = deltas;
  a.counts = static_cast<const int*>(counts);
  a.offsets = static_cast<const int*>(offsets);
  a.uniq = static_cast<const long long*>(uniq);
  a.bases = static_cast<const int*>(bases);
  a.src_of_row = static_cast<const int*>(src_of_row);
  a.values = static_cast<long long*>(values);
  a.valid = static_cast<bool*>(valid);
  a.B = B;
  a.P = P;
  a.K = K;
  a.C = C;
  a.NT = P <= TILE ? 1 : (P + TILE - 1) / TILE;
  a.nr = min(NR, C / 16);
  a.lw = 0;
  while ((a.nr << a.lw) < C) ++a.lw;
  unsigned long long* w = static_cast<unsigned long long*>(scratch);
  a.ws = w;
  a.pairs = reinterpret_cast<int2*>(w + 1 + (size_t)B * a.NT);
  a.rcount = reinterpret_cast<int*>(a.pairs + (size_t)B * a.NT * TILE);
  a.paths = static_cast<unsigned long long*>(paths);
  cudaError_t err = cudaMemsetAsync(
      w, 0, (1 + (size_t)B * a.NT) * sizeof(long long), s);
  if (err != cudaSuccess) return err;
  switch (dtype) {
    case 0: return launch<uint8_t>(v1, a, s);
    case 1: return launch<uint16_t>(v1, a, s);
    case 2: return launch<int32_t>(v1, a, s);
    case 3: return launch<int8_t>(v1, a, s);
    case 4: return launch<int16_t>(v1, a, s);
    case 5: return launch<int64_t>(v1, a, s);
    default: return cudaErrorInvalidValue;
  }
}
