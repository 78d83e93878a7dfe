// K15 shuffle_partition: every local shard's group table of a mesh batch
// as shuffle payload rows, placed by key owner into the shard's send
// buffer of the mesh exchange, in one launch.
//
// Replaces sybil_tpu/parallel/mesh.py:_build_payload (88-109), _mix_keys
// (112-122) and _partition_rows (125-143), which the reference runs for
// every shard inside one shard_map program, and for the dense strategy
// sybil_tpu/ops/scan.py:_dense_decode_keys (608-626, dense_keys.cuh's
// formula) with the expansion of _scan_dense's compact reduce space
// (1003-1015).  Row r < Seff of a shard's table becomes the payload row
//   [keys K | count, samples, (exists, count, wv) per agg |
//    bucket counts of each histogram agg (dense) | min per agg | max per agg]
// (WP = K + 2 + 3A + nv_total + 2A words):
//   dense   the keys decoded from the slot index (mixed radix over the key
//           bounds, digit 0 = MISSING, the time key (digit - 1 + min) * tb),
//           reading no column; the lanes, min/max and bucket rows from K2's
//           and K4's tables in reduce space (compact: rows [0, Sr-1) map
//           1:1, the others read as empty: zero lanes, min +2^62, max
//           -2^62); count and samples zero on the dead slot (slots - 1);
//           exists = its lane > 0; an aggregation without a histogram
//           has min +2^62 and max -2^62;
//   sorted  K8's keyed table: its keys, lanes (exists = lane > 0) and the
//           histogram aggregations' min/max (+-2^62 for the others).
// A row is live when count > 0 or samples > 0.  Its owner is the FNV-style
// uint32 hash of its keys' 32-bit halves (low, then high, per key), with
// the murmur finaliser steps, modulo D; dead rows have none.  Rows go to
// send[shard, owner, pos] in row order within each owner (jnp.argsort of
// the owner is stable), pos < Sc; a live row past Sc adds one to the
// shard's overflow count.  Unused send rows are zero.
//
// Each shard's statistics row stats[shard] [3 + 2H] gets word 1 = the
// scan's spill, word 2 = the overflow count, words 3.. = each histogram
// agg's outlier count, then (sorted) its hist pair count; K16 writes
// word 0.
//
// Bound: memory.  It reads each table once (Seff rows of the count and
// samples lanes, a live row's other words) and writes the send buffers
// once; at path 2 (8 shards of 100,000 rows, Sc 25,128, WP 9) the zeroed
// send buffers are most of the bytes.
//
// What the former design cost (PERF.md §6): one host call a shard (8 a
// mesh batch), each with five device operations (two memsets, an owner
// kernel writing every owner to global scratch, a one-CTA scan walking
// every tile in series an owner, a placement kernel); the dense keys
// decoded twice with a 64-bit divide and modulo a key; a payload row
// written by one thread, so a warp's stores touched 32 rows WP words
// apart.
//
// Design: one memset (every shard's send buffer, and above one tile the
// ticket and the status words, one allocation), then one launch of
// TILE-row CTAs over every shard's tiles:
//   1. each thread takes a row: its live test, its keys (dense: decoded
//      once, 32-bit digit arithmetic, into shared memory), its owner;
//   2. a warp match gives each row its rank among the warp's rows of the
//      same owner and the warp's count per owner (shared memory); a warp
//      an owner scans the 32 warps' counts: each warp's offset in the
//      tile, and the tile's count per owner;
//   3. the tile's offset per owner: 0 for a shard of one tile (Seff <=
//      TILE: the CTA is the whole shard, no scratch at all); above one
//      tile a decoupled look-back (Merrill and Garland 2016, as
//      segment_reduce.cu): the CTA's tile comes from an atomic ticket,
//      so every tile before it has started; it publishes its count per
//      owner, and a warp an owner sums its predecessors' published
//      counts, 32 tiles a step, until it meets an inclusive prefix.  A
//      status word is a flag in its top two bits and the count below,
//      stored with st.release and read with ld.acquire.  The shard's
//      last tile holds every owner's total: it writes the overflow count
//      and the statistics words;
//   4. the tile's live rows are listed in row order (a block scan) with
//      their destination row, and the threads walk (row, word) pairs of
//      that list, consecutive threads on consecutive words, so a warp
//      writes contiguous words of the destination rows and reads
//      contiguous words of the source rows.

#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "desc.cuh"

namespace {

constexpr int TILE = 1024;        // rows per CTA, one a thread
constexpr int WARPS = TILE / 32;
constexpr int MAX_D = 256;
constexpr int MAX_DENSE_K = 20;   // dense keys staged in shared memory
constexpr long long BIG = 1ll << 62;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long FLAG_AGG = 1ull << 62;
constexpr unsigned long long FLAG_PREFIX = 2ull << 62;
constexpr unsigned long long COUNT_MASK = (1ull << 62) - 1;

}  // namespace

// A shard's record in the descriptor block: its tables' pointers.
enum { T_SUMS, T_MINS, T_MAXS, T_KEYS, T_SPILL, T_HIST };
//   sums   dense [Sr, L]; sorted [S+1, L]
//   mins   [Sr or S, H] (null when H = 0), maxs the same
//   keys   sorted [S, K]; dense null
//   spill  [1]
//   hist   H of them: dense [Sr, nv_h]; sorted null
//   then nstat = 2H statistics sources [1] or null

// Mirrored field for field by ShufflePartitionArgs in parallel/mesh.py
// (ctypes).  Every pointer but send, status and stats points into the
// descriptor block.
struct ShufflePartitionArgs {
  Desc desc;
  const long long* const* tabs;     // [Dl, T_HIST + H + nstat] records
  const long long* hist_nv;         // [H]
  const long long* agg_mm;          // [A] hist index of each agg, -1 = none
  const long long* kb_min;          // [nkb] dense key bounds
  const long long* kb_card;         // [nkb]
  long long* send;                  // [Dl, D, Sc, WP]
  unsigned long long* status;       // ntiles > 1: [1 + Dl * ntiles * D]
  long long* stats;                 // [Dl, 3 + nstat]
  long long tb;
  int Dl;
  int Seff;
  int D;
  int Sc;
  int K;
  int A;
  int L;
  int H;
  int WP;
  int dense;
  int compact;
  int Sr;                           // dense reduce-space rows
  int slots;
  int nkb;
  int tpos;
  int ntiles;
  int nstat;
};

namespace {

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

// One shard's tables, read once per CTA from the descriptor block.
struct Shard {
  const long long* sums;
  const long long* mins;
  const long long* maxs;
  const long long* keys;
  int rec;                          // its record's first word
};

// dense: the reduce-space row of slot r, or -1 when it reads as empty
__device__ __forceinline__ int src_row(const ShufflePartitionArgs& a, int r) {
  if (!a.dense) return r;
  return a.compact ? (r < a.Sr - 1 ? r : -1) : r;
}

__device__ __forceinline__ long long lane_val(const ShufflePartitionArgs& a,
                                              const Shard& s, int r, int src,
                                              int j) {
  if (src < 0) return 0;
  if (a.dense && j < 2 && r >= a.slots - 1) return 0;   // the dead slot
  const long long v = s.sums[(size_t)src * a.L + j];
  return (j >= 2 && (j - 2) % 3 == 0) ? (v > 0) : v;
}

// Word w of row r's payload (rl: its row in the tile, for the dense keys
// staged in shared memory).
__device__ long long payload_word(const ShufflePartitionArgs& a,
                                  const Shard& s, const long long* s_key,
                                  int r, int rl, int w) {
  if (w < a.K)
    return a.dense ? s_key[rl * a.K + w] : s.keys[(size_t)r * a.K + w];
  int c = w - a.K;
  const int src = src_row(a, r);
  if (c < a.L) return lane_val(a, s, r, src, c);
  c -= a.L;
  if (a.dense) {
    for (int h = 0; h < a.H; ++h) {
      const int nv = (int)desc_at(a.desc, a.hist_nv, h);
      if (c < nv) {
        if (src < 0) return 0;
        const long long* hist = desc_at(a.desc, a.tabs, s.rec + T_HIST + h);
        return hist[(size_t)src * nv + c];
      }
      c -= nv;
    }
  }
  const bool is_max = c >= a.A;
  const int ai = is_max ? c - a.A : c;
  const int mm = (int)desc_at(a.desc, a.agg_mm, ai);
  if (mm < 0 || src < 0) return is_max ? -BIG : BIG;
  return (is_max ? s.maxs : s.mins)[(size_t)src * a.H + mm];
}

__device__ __forceinline__ unsigned mix_step(unsigned h, long long key) {
  const unsigned long long v = (unsigned long long)key;
  h = (h ^ (unsigned)(v & 0xffffffffull)) * 16777619u;
  return (h ^ (unsigned)(v >> 32)) * 16777619u;
}

// The row's owner in [0, D), or D when it is dead.  Dense keys are
// decoded into s_key[rl * K ..] on the way (the slot index is a
// mixed-radix number over the key bounds, the last key least
// significant; slot and radix fit 32 bits).
__device__ int row_owner(const ShufflePartitionArgs& a, const Shard& s,
                         long long* s_key, int r, int rl) {
  const int src = src_row(a, r);
  if (!(lane_val(a, s, r, src, 0) > 0 || lane_val(a, s, r, src, 1) > 0))
    return a.D;
  unsigned h = 2166136261u;
  if (a.dense) {
    long long* key = s_key + rl * a.K;
    for (int k = a.nkb; k < a.K; ++k) key[k] = 0;
    unsigned sid = (unsigned)r;
    for (int i = a.nkb - 1; i >= 0; --i) {
      const long long mn = desc_at(a.desc, a.kb_min, i);
      const unsigned radix = (unsigned)desc_at(a.desc, a.kb_card, i) + 1u;
      const unsigned digit = sid % radix;
      sid /= radix;
      key[i] = i == a.tpos ? ((long long)digit - 1 + mn) * a.tb
                           : (digit == 0 ? -1ll : (long long)digit - 1 + mn);
    }
    for (int k = 0; k < a.K; ++k) h = mix_step(h, key[k]);
  } else {
    for (int k = 0; k < a.K; ++k)
      h = mix_step(h, s.keys[(size_t)r * a.K + k]);
  }
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  return (int)(h % (unsigned)a.D);
}

// Dynamic shared memory: the dense keys [TILE, K] (int64), then each
// warp's count per owner [WARPS, D], each owner's tile count [D] and
// offset [D] (int32).
template <bool TILED>
__global__ void __launch_bounds__(TILE, 2) partition_kernel(
    const ShufflePartitionArgs a) {
  extern __shared__ long long s_key[];
  __shared__ int s_ticket;
  __shared__ int s_row[TILE];       // the tile's live rows, in row order
  __shared__ int s_dst[TILE];       // and their send rows, -1 past Sc
  __shared__ long long s_over;
  const int D = a.D;
  int* s_warp = reinterpret_cast<int*>(s_key + (a.dense ? TILE * a.K : 0));
  int* s_cnt = s_warp + WARPS * D;
  int* s_base = s_cnt + D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  int shard = blockIdx.x, tile = 0;
  if (TILED) {
    if (threadIdx.x == 0) s_ticket = (int)atomicAdd(a.status, 1ull);
    __syncthreads();
    shard = s_ticket / a.ntiles;
    tile = s_ticket - shard * a.ntiles;
  }
  Shard s;
  s.rec = shard * (T_HIST + a.H + a.nstat);
  s.sums = desc_at(a.desc, a.tabs, s.rec + T_SUMS);
  s.mins = desc_at(a.desc, a.tabs, s.rec + T_MINS);
  s.maxs = desc_at(a.desc, a.tabs, s.rec + T_MAXS);
  s.keys = desc_at(a.desc, a.tabs, s.rec + T_KEYS);

  for (int i = threadIdx.x; i < WARPS * D; i += TILE) s_warp[i] = 0;
  if (threadIdx.x == 0) s_over = 0;
  __syncthreads();

  // 1-2. the row's owner, its rank in the warp, the warp's counts
  const int rl = threadIdx.x;
  const int r = tile * TILE + rl;
  const int o = r < a.Seff ? row_owner(a, s, s_key, r, rl) : D;
  const unsigned same = __match_any_sync(FULL, o);
  const int rank = __popc(same & ((1u << lane) - 1u));
  if (o < D && rank == 0) s_warp[warp * D + o] = __popc(same);
  __syncthreads();
  // a warp an owner: each warp's exclusive offset, the tile's count
  for (int d = warp; d < D; d += WARPS) {
    const int x = s_warp[lane * D + d];
    int inc = x;
    for (int k = 1; k < 32; k <<= 1) {
      const int y = __shfl_up_sync(FULL, inc, k);
      if (lane >= k) inc += y;
    }
    s_warp[lane * D + d] = inc - x;
    if (lane == 31) s_cnt[d] = inc;
  }
  __syncthreads();

  // 3. the tile's offset per owner; the shard's last tile has the totals
  for (int d = warp; d < D; d += WARPS) {
    const unsigned long long count = (unsigned long long)s_cnt[d];
    unsigned long long excl = 0ull;
    if (TILED) {
      unsigned long long* st =
          a.status + 1 + (size_t)shard * a.ntiles * D + d;
      if (tile == 0) {
        if (lane == 0) st_release(st, FLAG_PREFIX | count);
      } else {
        if (lane == 0)
          st_release(st + (size_t)tile * D, FLAG_AGG | count);
        for (int hi = tile - 1;; hi -= 32) {
          const int j = hi - lane;
          unsigned long long w =
              j >= 0 ? ld_acquire(st + (size_t)j * D) : FLAG_PREFIX;
          // wait until the 32 tiles before have each published
          while (__any_sync(FULL, (w >> 62) == 0))
            if ((w >> 62) == 0) w = ld_acquire(st + (size_t)j * D);
          const unsigned pre = __ballot_sync(FULL, (w >> 62) == 2);
          const int stop = pre ? __ffs(pre) - 1 : 31;
          unsigned long long c = lane <= stop ? (w & COUNT_MASK) : 0ull;
          for (int k = 16; k; k >>= 1) c += __shfl_xor_sync(FULL, c, k);
          excl += c;
          if (pre) break;
        }
        if (lane == 0)
          st_release(st + (size_t)tile * D, FLAG_PREFIX | (excl + count));
      }
    }
    if (lane == 0) {
      s_base[d] = (int)excl;
      const long long total = (long long)(excl + count);
      if (tile == a.ntiles - 1 && total > a.Sc)
        atomicAdd((unsigned long long*)&s_over,
                  (unsigned long long)(total - a.Sc));
    }
  }
  __syncthreads();
  if (tile == a.ntiles - 1 && threadIdx.x == 0) {
    long long* st = a.stats + (size_t)shard * (3 + a.nstat);
    st[1] = desc_at(a.desc, a.tabs, s.rec + T_SPILL)[0];
    st[2] = s_over;
    for (int i = 0; i < a.nstat; ++i) {
      const long long* p = desc_at(a.desc, a.tabs, s.rec + T_HIST + a.H + i);
      st[3 + i] = p ? p[0] : 0;
    }
  }

  // 4. the live rows in row order with their send rows, then their words
  int nlive;
  const int j = block_scan<TILE>(o < D ? 1 : 0, &nlive);
  if (o < D) {
    const int pos = s_base[o] + s_warp[warp * D + o] + rank;
    s_row[j] = rl;
    s_dst[j] = pos < a.Sc ? o * a.Sc + pos : -1;
  }
  __syncthreads();
  const int WP = a.WP;
  long long* send = a.send + (size_t)shard * D * a.Sc * WP;
  const int words = nlive * WP;
  for (int f = threadIdx.x; f < words; f += TILE) {
    const int i = (unsigned)f / (unsigned)WP;
    const int w = f - i * WP;
    const int dst = s_dst[i];
    if (dst < 0) continue;
    const int row = s_row[i];
    send[(size_t)dst * WP + w] =
        payload_word(a, s, s_key, tile * TILE + row, row, w);
  }
}

template <bool TILED>
cudaError_t launch(const ShufflePartitionArgs& a, size_t smem,
                   cudaStream_t s) {
  if (smem > (48 << 10)) {    // many dense keys, or many owners
    const cudaError_t err = cudaFuncSetAttribute(
        partition_kernel<TILED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  partition_kernel<TILED><<<TILED ? a.Dl * a.ntiles : a.Dl, TILE, smem, s>>>(
      a);
  return cudaGetLastError();
}

}  // namespace

// Zeroes every shard's send buffer (and above one tile the ticket and the
// status words that follow it in the same allocation) with one memset,
// then runs the kernel on `stream`.  Returns cudaError_t.
extern "C" int shuffle_partition(const ShufflePartitionArgs* args,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ShufflePartitionArgs& a = *args;
  if (a.Dl < 1 || a.D < 1 || a.D > MAX_D || a.Seff < 1 || a.Sc < 1 ||
      a.ntiles != (a.Seff + TILE - 1) / TILE ||
      a.WP < a.K + a.L + 2 * a.A || (a.dense && a.K > MAX_DENSE_K) ||
      (a.ntiles > 1 &&
       a.status != reinterpret_cast<unsigned long long*>(
                       a.send + (size_t)a.Dl * a.D * a.Sc * a.WP)))
    return cudaErrorInvalidValue;
  cudaError_t err = desc_upload(a.desc, s);
  if (err != cudaSuccess) return err;
  size_t words = (size_t)a.Dl * a.D * a.Sc * a.WP;
  if (a.ntiles > 1) words += 1 + (size_t)a.Dl * a.ntiles * a.D;
  err = cudaMemsetAsync(a.send, 0, words * sizeof(long long), s);
  if (err != cudaSuccess) return err;
  const size_t smem = (a.dense ? (size_t)TILE * a.K * sizeof(long long) : 0) +
                      (size_t)(WARPS + 2) * a.D * sizeof(int);
  return a.ntiles > 1 ? launch<true>(a, smem, s) : launch<false>(a, smem, s);
}
