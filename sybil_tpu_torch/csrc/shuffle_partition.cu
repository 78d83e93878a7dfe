// K15 shuffle_partition: one shard's group table as shuffle payload rows,
// placed by key owner into the shard's send buffer of the mesh exchange.
//
// Replaces sybil_tpu/parallel/mesh.py:_build_payload (88-109), _mix_keys
// (112-122) and _partition_rows (125-143), and for the dense strategy
// sybil_tpu/ops/scan.py:_dense_decode_keys (608-626, dense_keys.cuh)
// with the expansion of _scan_dense's compact reduce space (1003-1015).
// Row r < Seff of the shard's table becomes the payload row
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
// send[owner, pos] in row order within each owner (jnp.argsort of the
// owner is stable), pos < Sc; a live row past Sc adds one to the overflow
// count.  Unused send rows are zero.
//
// The shard's statistics row `stats` [3 + 2H] gets word 1 = the scan's
// spill, word 2 = the overflow count, words 3.. = each histogram agg's
// outlier count, then (sorted) its hist pair count; K16 writes word 0.
//
// Bound: memory.  It reads the table once (Seff rows of the lanes, and of
// the bucket rows on the dense strategy) and writes the live rows once.
// Design, three launches: (1) each CTA of TILE rows computes every row's
// owner into scratch and counts its rows per owner (a warp match and one
// shared atomic per owner run); (2) one CTA turns the tile counts into
// per-owner exclusive offsets; (3) each CTA ranks its rows per owner
// (the warp match, lane rank and the counts of the warps before) and
// writes each live row's payload at its place.

#include <cstdint>
#include <cuda_runtime.h>

#include "dense_keys.cuh"
#include "desc.cuh"

namespace {

constexpr int TILE = 1024;        // rows per CTA, one a thread
constexpr int WARPS = TILE / 32;
constexpr int MAX_D = 256;
constexpr long long BIG = 1ll << 62;
constexpr unsigned FULL = 0xffffffffu;

}  // namespace

// Mirrored field for field by ShufflePartitionArgs in ops/scan.py (ctypes).
// The per-aggregation and per-key arrays point into the descriptor block.
struct ShufflePartitionArgs {
  Desc desc;
  const long long* sums;            // dense [Sr, L]; sorted [S+1, L]
  const long long* mins;            // [Sr or S, H]
  const long long* maxs;
  const long long* keys;            // sorted [S, K]; dense null
  const long long* const* hist;     // [H] dense [Sr, nv_h]
  const long long* hist_nv;         // [H]
  const long long* agg_mm;          // [A] hist index of each agg, -1 = none
  const long long* kb_min;          // [nkb] dense key bounds
  const long long* kb_card;         // [nkb]
  const long long* const* stat_src; // [nstat] [1] counts copied to stats[3..]
  const long long* spill;           // [1]
  long long* send;                  // [D, Sc, WP]
  long long* stats;                 // [3 + nstat]
  int* owner;                       // [Seff] scratch
  int* counts;                      // [ntiles, D] scratch
  long long tb;
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

// dense: the reduce-space row of slot r, or -1 when it reads as empty
__device__ __forceinline__ int src_row(const ShufflePartitionArgs& a, int r) {
  if (!a.dense) return r;
  return a.compact ? (r < a.Sr - 1 ? r : -1) : r;
}

__device__ __forceinline__ long long lane_val(const ShufflePartitionArgs& a,
                                              int r, int src, int j) {
  if (src < 0) return 0;
  if (a.dense && j < 2 && r >= a.slots - 1) return 0;   // the dead slot
  const long long v = a.sums[(size_t)src * a.L + j];
  return (j >= 2 && (j - 2) % 3 == 0) ? (v > 0) : v;
}

__device__ __forceinline__ long long key_val(const ShufflePartitionArgs& a,
                                             int r, int k) {
  if (!a.dense) return a.keys[(size_t)r * a.K + k];
  return dense_key(a.desc, a.kb_min, a.kb_card, a.nkb, a.tpos, a.tb, r, k);
}

__device__ __forceinline__ bool row_live(const ShufflePartitionArgs& a,
                                         int r) {
  const int src = src_row(a, r);
  return lane_val(a, r, src, 0) > 0 || lane_val(a, r, src, 1) > 0;
}

__device__ __forceinline__ unsigned mix_keys(const ShufflePartitionArgs& a,
                                             int r) {
  unsigned h = 2166136261u;
  for (int k = 0; k < a.K; ++k) {
    const unsigned long long v = (unsigned long long)key_val(a, r, k);
    h = (h ^ (unsigned)(v & 0xffffffffull)) * 16777619u;
    h = (h ^ (unsigned)(v >> 32)) * 16777619u;
  }
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  return h ^ (h >> 13);
}

// Owner of every row, and each tile's row count per owner.
__global__ void __launch_bounds__(TILE) owner_kernel(
    const ShufflePartitionArgs a) {
  __shared__ int s_cnt[MAX_D];
  for (int d = threadIdx.x; d < a.D; d += TILE) s_cnt[d] = 0;
  __syncthreads();
  const int r = blockIdx.x * TILE + threadIdx.x;
  int o = a.D;
  if (r < a.Seff) {
    if (row_live(a, r)) o = (int)(mix_keys(a, r) % (unsigned)a.D);
    a.owner[r] = o;
  }
  const unsigned same = __match_any_sync(FULL, o);
  if (o < a.D && (threadIdx.x & 31) == __ffs(same) - 1)
    atomicAdd(&s_cnt[o], __popc(same));
  __syncthreads();
  for (int d = threadIdx.x; d < a.D; d += TILE)
    a.counts[(size_t)blockIdx.x * a.D + d] = s_cnt[d];
}

// Tile counts -> exclusive offsets, per owner (one thread an owner).
__global__ void scan_kernel(const ShufflePartitionArgs a) {
  for (int d = threadIdx.x; d < a.D; d += blockDim.x) {
    int run = 0;
    for (int t = 0; t < a.ntiles; ++t) {
      int* c = a.counts + (size_t)t * a.D + d;
      const int n = *c;
      *c = run;
      run += n;
    }
  }
  if (threadIdx.x == 0) {
    a.stats[1] = a.spill[0];
    for (int i = 0; i < a.nstat; ++i) {
      const long long* p = desc_at(a.desc, a.stat_src, i);
      a.stats[3 + i] = p ? p[0] : 0;
    }
  }
}

__global__ void __launch_bounds__(TILE) place_kernel(
    const ShufflePartitionArgs a) {
  __shared__ int s_warp[WARPS][MAX_D];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.x * TILE + threadIdx.x;
  const int o = r < a.Seff ? a.owner[r] : a.D;
  for (int d = lane; d < a.D; d += 32) s_warp[warp][d] = 0;
  __syncwarp();
  const unsigned same = __match_any_sync(FULL, o);
  if (o < a.D && lane == __ffs(same) - 1) s_warp[warp][o] = __popc(same);
  __syncthreads();
  if (o >= a.D) return;
  int pos = a.counts[(size_t)blockIdx.x * a.D + o] +
            __popc(same & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) pos += s_warp[w][o];
  if (pos >= a.Sc) {
    atomicAdd(reinterpret_cast<unsigned long long*>(a.stats + 2), 1ull);
    return;
  }
  long long* out = a.send + ((size_t)o * a.Sc + pos) * a.WP;
  for (int k = 0; k < a.K; ++k) out[k] = key_val(a, r, k);
  const int src = src_row(a, r);
  for (int j = 0; j < a.L; ++j) out[a.K + j] = lane_val(a, r, src, j);
  int c = a.K + a.L;
  for (int h = 0; h < a.H && a.dense; ++h) {
    const int nv = (int)desc_at(a.desc, a.hist_nv, h);
    const long long* hist = desc_at(a.desc, a.hist, h);
    for (int j = 0; j < nv; ++j)
      out[c + j] = src >= 0 ? hist[(size_t)src * nv + j] : 0;
    c += nv;
  }
  for (int ai = 0; ai < a.A; ++ai) {
    const int mm = (int)desc_at(a.desc, a.agg_mm, ai);
    long long mn = BIG, mx = -BIG;
    if (mm >= 0 && src >= 0) {
      mn = a.mins[(size_t)src * a.H + mm];
      mx = a.maxs[(size_t)src * a.H + mm];
    }
    out[c + ai] = mn;
    out[c + a.A + ai] = mx;
  }
}

}  // namespace

// Zeroes the send buffer and the overflow word, then runs the three
// launches on `stream`.  Returns cudaError_t.
extern "C" int shuffle_partition(const ShufflePartitionArgs* args,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ShufflePartitionArgs& a = *args;
  if (a.D < 1 || a.D > MAX_D || a.Seff < 1 || a.Sc < 1 ||
      a.ntiles != (a.Seff + TILE - 1) / TILE || a.WP < a.K + a.L + 2 * a.A)
    return cudaErrorInvalidValue;
  cudaError_t err = desc_upload(a.desc, s);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(a.send, 0,
                        (size_t)a.D * a.Sc * a.WP * sizeof(long long), s);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(a.stats + 2, 0, sizeof(long long), s);
  if (err != cudaSuccess) return err;
  owner_kernel<<<a.ntiles, TILE, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_kernel<<<1, MAX_D, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  place_kernel<<<a.ntiles, TILE, 0, s>>>(a);
  return cudaGetLastError();
}
