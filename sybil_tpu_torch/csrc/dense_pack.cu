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
// The keyed forms (no_compact_table, pack_outputs 1865-1872) write the
// table as rows 1..slots of W words each, [keys K, count, samples,
// (exists, count, wv, min, max) per agg].  The merged form packs a mesh
// scan's merged table (K16's unpack: `keys` given, every row a slot, no
// dead slot, min/max of every aggregation, num_groups and the overflow
// from the shards' merged statistics; the meta word 3 + H is the shuffle
// overflow).  The unmerged form, entry dense_keyed, packs the scan's own
// reduce-space table (the row-store scan's): the compact expansion and
// the dead slot as above, each slot's keys decoded from its index by
// dense_key (dense_keys.cuh: _dense_decode_keys 608-626, digit 0 MISSING
// or, for the time key, (min - 1) * bucket; one zero column without
// keys), the tracked min/max of the histogram aggregations and the
// sentinels +-2^62 for every other aggregation (_scan_dense 1005-1012).
//
// Bound: launch latency.  It reads the small sum, min/max and bucket
// tables and writes a buffer of a few to a few hundred KB (the HLL
// planes 16 KB each, a keyed table slots x W words).
//
// What a trace of the former design showed (torch.profiler on the H100;
// PERF.md §6): a call was two memsets (every word the kernel owns,
// zeroed first) and one single-CTA kernel whose thread a slot stored the
// slot's words one by one, and the wrapper's host time exceeded the
// device's.
//
// Design: one launch, no memset.  The words the kernel owns, rows [0,
// out_lo) and [out_hi, rows) of `main` (K5 owns the rows between), are
// one index space cut into CHUNK-word pieces, a CTA each; thread t of a
// CTA computes words t, t + THREADS, ... of its piece, zeros included,
// so every store is coalesced and no word is left to a memset.  A word's
// value comes from its row and column: the meta row, a compact table
// word (slot = word / wpr), a keyed table word (slot = row - 1), or a
// word of the HLL or hist sections (a gid, a plane word, a bucket).  A
// CTA whose piece holds a gathered section first ranks the first
// max(Ph, Phll) slots of the top_k order into shared memory: 8
// consecutive slots a thread, one block scan a round of 2,048 slots,
// stopping once that many live slots are found (then the non-live slots
// in a second walk, where there were fewer).  CTA 0 counts the live slots
// for num_groups (a merged table brings its own).

#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "dense_keys.cuh"
#include "desc.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 4;                     // words a thread
constexpr int CHUNK = THREADS * ITEMS;       // words a CTA
constexpr int SLOTS_T = 8;                   // slots a thread a ranking round
constexpr int HLL_WORDS = (1 << 14) / 8;     // one register plane, int64 words
constexpr long long BIG = 1ll << 62;
constexpr unsigned FULL = 0xffffffffu;

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
  // the merged form: a merged table's keys and statistics, else null
  const long long* keys;        // [slots, K]
  const long long* num_groups;  // [1]
  const long long* overflow;    // [1] the shuffle overflow
  // the unmerged keyed form: the key bounds (min, card) of the nkb keys,
  // the time key's position (or -1) and bucket, and each aggregation's
  // index among the histogram aggregations (-1: untracked)
  const long long* kb_min;      // [nkb]
  const long long* kb_card;     // [nkb]
  const long long* agg_mm;      // [A]
  long long tb;
  int K;        // key columns of a keyed form (rows of K + 2 + 5A words),
                // 0 for the compact table
  int A;        // aggregations
  int nkb;
  int tpos;
};

namespace {

// compact: rows [0, Sc-1) map 1:1, the rest (padding and the dead slot)
// read as empty; otherwise the tables are already slot-sized
__device__ __forceinline__ int src_row(const DensePackArgs& a, int s) {
  return a.compact ? (s < a.Sc - 1 ? s : -1) : s;
}

// the scan's own table has a dead slot; a merged table has none
__device__ __forceinline__ bool dead_slot(const DensePackArgs& a, int s) {
  return !a.keys && s >= a.slots - 1;
}

__device__ __forceinline__ bool slot_live(const DensePackArgs& a, int s) {
  const int src = src_row(a, s);
  if (src < 0 || dead_slot(a, s)) return false;
  const unsigned long long* row = a.sums + (size_t)src * a.L;
  return (long long)row[0] > 0 || (long long)row[1] > 0;
}

// Word j of slot s of the compact keyless table (dense_table_plan's
// columns, then the hist aggregations' min and max).
__device__ __forceinline__ unsigned long long compact_word(
    const DensePackArgs& a, int s, int j) {
  const int src = src_row(a, s);
  const bool live_row = !dead_slot(a, s);
  const unsigned long long* row = a.sums + (size_t)(src < 0 ? 0 : src) * a.L;
  const int per = a.i32 ? 2 : 1;
  const int npack = a.ncols / per;
  if (j >= npack) {
    const int h = (j - npack) >> 1;
    if ((j - npack) & 1)
      return (unsigned long long)(src >= 0 ? a.maxs[(size_t)src * a.H + h]
                                           : -BIG);
    return (unsigned long long)(src >= 0 ? a.mins[(size_t)src * a.H + h]
                                         : BIG);
  }
  unsigned long long word[2] = {0ull, 0ull};
  for (int hh = 0; hh < per; ++hh) {
    const int lane = (int)desc_at(a.desc, a.lane, j * per + hh);
    unsigned long long x = src >= 0 ? row[lane] : 0ull;
    if (lane < 2 && !live_row) x = 0ull;            // the dead slot
    if (lane >= 2 && (lane - 2) % 3 == 0) x = (long long)x > 0;  // exists
    word[hh] = x;
  }
  return a.i32 ? ((word[0] & 0xffffffffull) | (word[1] << 32)) : word[0];
}

// Column c of keyed row 1 + s: a merged table's row s, or slot s of the
// scan's own table.
__device__ __forceinline__ long long keyed_word(const DensePackArgs& a, int s,
                                                int c) {
  if (c < a.K)
    return a.keys ? a.keys[(size_t)s * a.K + c]
                  : dense_key(a.desc, a.kb_min, a.kb_card, a.nkb, a.tpos,
                              a.tb, s, c);
  const int src = src_row(a, s);
  const unsigned long long* row = a.sums + (size_t)(src < 0 ? 0 : src) * a.L;
  if (c < a.K + 2)
    return src >= 0 && !dead_slot(a, s) ? (long long)row[c - a.K] : 0ll;
  const int ai = (c - a.K - 2) / 5, f = (c - a.K - 2) - 5 * ai;
  if (ai >= a.A) return 0ll;          // past the row: zero padding to W
  if (f == 0) return src >= 0 && (long long)row[2 + 3 * ai] > 0;
  if (f < 3) return src >= 0 ? (long long)row[2 + 3 * ai + f] : 0ll;
  if (a.keys)
    return f == 3 ? a.mins[(size_t)s * a.A + ai] : a.maxs[(size_t)s * a.A + ai];
  const int h = (int)desc_at(a.desc, a.agg_mm, ai);
  const bool mm = h >= 0 && src >= 0;
  if (f == 3) return mm ? a.mins[(size_t)src * a.H + h] : BIG;
  return mm ? a.maxs[(size_t)src * a.H + h] : -BIG;
}

// Word `col` of the meta row.
__device__ __forceinline__ unsigned long long meta_word(
    const DensePackArgs& a, int col, int nlive) {
  if (col == 0)
    return a.num_groups ? (unsigned long long)*a.num_groups
                        : (unsigned long long)nlive;
  if (col == 1) return *a.spill;
  if (col < 2 + a.H) {
    const unsigned long long* nout = desc_at(a.desc, a.nout, col - 2);
    return nout ? *nout : 0ull;
  }
  if (col == 3 + a.H && a.overflow) return (unsigned long long)*a.overflow;
  return 0ull;
}

// The tail sections after K5's rows, in layout order: HLL gids, HLL
// planes, hist gids, each hist aggregation's buckets.  Word i (from the
// first row of section `sec`): its value, given the ranked gids g.
enum { T_HLL_GID, T_HLL_REG, T_GID, T_HIST };

__device__ __forceinline__ unsigned long long tail_word(
    const DensePackArgs& a, int sec, int h, long long i, const int* g) {
  switch (sec) {
    case T_HLL_GID:
      return i < a.Phll ? (unsigned long long)g[i] : 0ull;
    case T_HLL_REG:
      return i < (long long)a.Phll * HLL_WORDS
                 ? a.hll[(size_t)g[i / HLL_WORDS] * HLL_WORDS + i % HLL_WORDS]
                 : 0ull;
    case T_GID:
      return i < a.Ph ? (unsigned long long)g[i] : 0ull;
    default: {
      const int nv = (int)desc_at(a.desc, a.hist_nv, h);
      if (i >= (long long)a.Ph * nv) return 0ull;
      const int src = src_row(a, g[i / nv]);
      return src >= 0 ? desc_at(a.desc, a.hist, h)[(size_t)src * nv + i % nv]
                      : 0ull;
    }
  }
}

// Which tail section holds main row `row` (>= out_hi): its kind, hist
// aggregation and first row.
__device__ __forceinline__ void tail_section(const DensePackArgs& a,
                                             long long row, int* sec, int* h,
                                             long long* first) {
  *h = 0;
  if (a.Ph) {
    for (int k = a.H - 1; k >= 0; --k) {
      const long long r0 = desc_at(a.desc, a.hist_row, k);
      if (row >= r0) {
        *sec = T_HIST;
        *h = k;
        *first = r0;
        return;
      }
    }
    if (row >= a.gid_row) {
      *sec = T_GID;
      *first = a.gid_row;
      return;
    }
  }
  if (row >= a.hll_reg_row) {
    *sec = T_HLL_REG;
    *first = a.hll_reg_row;
    return;
  }
  *sec = T_HLL_GID;
  *first = a.hll_gid_row;
}

// The first `ng` slots of lax.top_k(live, ng)'s order into g (live slots
// ascending, then the others ascending).
__device__ void rank_slots(const DensePackArgs& a, int ng, int* g) {
  int found = 0;
  for (int pass = 0; pass < 2 && found < ng; ++pass) {
    for (int base = 0; base < a.slots && found < ng;
         base += THREADS * SLOTS_T) {
      const int s0 = base + threadIdx.x * SLOTS_T;
      unsigned m = 0u;
#pragma unroll
      for (int k = 0; k < SLOTS_T; ++k)
        if (s0 + k < a.slots && slot_live(a, s0 + k) == (pass == 0))
          m |= 1u << k;
      int total;
      int pos = found + block_scan<THREADS>(__popc(m), &total);
      for (; m && pos < ng; m &= m - 1, ++pos) g[pos] = s0 + __ffs(m) - 1;
      found += total;
    }
  }
  __syncthreads();
}

// Live slots, for num_groups (all threads get the total).
__device__ int count_live(const DensePackArgs& a) {
  __shared__ int s_warp[THREADS / 32];
  int n = 0;
  for (int s = threadIdx.x; s < a.slots; s += THREADS) n += slot_live(a, s);
  n = __reduce_add_sync(FULL, n);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = n;
  __syncthreads();
  n = 0;
  for (int w = 0; w < THREADS / 32; ++w) n += s_warp[w];
  return n;
}

__global__ void __launch_bounds__(THREADS) dense_pack_kernel(
    const DensePackArgs a) {
  extern __shared__ int s_gidx[];   // [max(Ph, Phll)]
  const long long W = a.W;
  const long long head = a.out_lo * W;          // words [0, out_lo) rows
  const long long n = head + (a.rows - a.out_hi) * W;
  const long long lo = (long long)blockIdx.x * CHUNK;
  const long long hi = lo + CHUNK < n ? lo + CHUNK : n;
  // the piece's tail words gather at ranked gids: rank them first
  const int ng = a.Ph > a.Phll ? a.Ph : a.Phll;
  if (ng > 0 && hi > head) rank_slots(a, ng, s_gidx);
  const int nlive = (blockIdx.x == 0 && !a.num_groups) ? count_live(a) : 0;
  const int per = a.i32 ? 2 : 1;
  const int wpr = a.ncols / per + 2 * a.H;
  unsigned long long v[ITEMS];
  long long at[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const long long w = lo + threadIdx.x + (long long)k * THREADS;
    at[k] = -1;
    v[k] = 0ull;
    if (w >= hi) continue;
    if (w < head) {
      at[k] = w;
      const long long row = w / W;
      const int col = (int)(w - row * W);
      if (row == 0) {
        v[k] = meta_word(a, col, nlive);
      } else if (a.K > 0) {
        const long long s = row - 1;
        if (s < a.slots) v[k] = (unsigned long long)keyed_word(a, (int)s, col);
      } else {
        const long long t = w - W;               // the table's word t
        const long long s = t / wpr;
        if (s < a.slots) v[k] = compact_word(a, (int)s, (int)(t - s * wpr));
      }
    } else {
      const long long mw = w - head + a.out_hi * W;
      at[k] = mw;
      int sec, h;
      long long first;
      tail_section(a, mw / W, &sec, &h, &first);
      v[k] = tail_word(a, sec, h, mw - first * W, s_gidx);
    }
  }
#pragma unroll
  for (int k = 0; k < ITEMS; ++k)
    if (at[k] >= 0) a.main[at[k]] = v[k];
}

// Copies the descriptor block, then launches the kernel: one CTA a
// CHUNK of the words it owns (all of `main` but K5's outlier rows).
int launch(const DensePackArgs* args, cudaStream_t st) {
  const DensePackArgs& a = *args;
  if ((a.Phll && !a.hll) || a.W < a.K + 2 + 5 * a.A || a.W < 4 + a.H ||
      a.out_lo < 1 || a.out_lo > a.out_hi || a.out_hi > a.rows ||
      a.slots < 1 || a.Sc < 1 || a.Sc > a.slots ||
      (a.Ph || a.Phll) != (a.rows > a.out_hi) ||
      (a.K == 0 && (long long)a.slots * (a.ncols / (a.i32 ? 2 : 1) + 2 * a.H)
                       > (a.out_lo - 1) * a.W) ||
      (a.K > 0 && a.out_lo != 1 + a.slots))
    return cudaErrorInvalidValue;
  cudaError_t err = desc_upload(a.desc, st);
  if (err != cudaSuccess) return err;
  const long long n = (a.out_lo + a.rows - a.out_hi) * (long long)a.W;
  const long long grid = (n + CHUNK - 1) / CHUNK;
  if (grid >= (1ll << 31)) return cudaErrorInvalidValue;
  const size_t shm = (size_t)(a.Ph > a.Phll ? a.Ph : a.Phll) * sizeof(int);
  dense_pack_kernel<<<(unsigned)grid, THREADS, shm, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The compact form, and the keyed form of a merged table.  Returns
// cudaError_t.
extern "C" int dense_pack(const DensePackArgs* args, void* stream) {
  if (args->K > 0 && (!args->keys || args->compact ||
                      args->Sc != args->slots))
    return cudaErrorInvalidValue;
  return launch(args, static_cast<cudaStream_t>(stream));
}

// The keyed form of the scan's own table (the row-store scan).  Returns
// cudaError_t.
extern "C" int dense_keyed(const DensePackArgs* args, void* stream) {
  if (args->K < 1 || args->keys || args->num_groups || args->overflow ||
      !(args->nkb == args->K || (args->nkb == 0 && args->K == 1)))
    return cudaErrorInvalidValue;
  return launch(args, static_cast<cudaStream_t>(stream));
}
