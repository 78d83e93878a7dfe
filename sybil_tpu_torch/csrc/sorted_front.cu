// K7 sorted_front: the front end of the sorted scan strategy over R = B*C
// rows, and sort_permute, the step between its stable sorts.
//
// sorted_front replaces sybil_tpu/ops/scan.py: _front_end (row-in-range,
// the int/str/regex filters, the time key, the key lanes [cg?, time?,
// *groups] with MISSING = -1, one zero lane without any) and the sort operands
// of _scan_sorted (1076-1104, 1117-1118):
//   idxm[r]   r with the matched flag in its sign bit (the reference's
//             sort payload);
//   packed    (sort_pack) the mixed-radix key: digit 0 for MISSING, else
//             key - min + 1; a matched row whose digit leaves [0, card]
//             counts in `spill`; unmatched and spilled rows take the
//             sentinel, the radix product.  int32 when the product is
//             below 2^31 - 1, else int64;
//   unpacked  the K key lanes [K + D, R], then the D distinct lanes
//             (dkeys 435-438: the value, MISSING = -1 where it is
//             missing), SENTINEL (int64 max) in every lane of an
//             unmatched row.
// The cache-group key of a query-cache group scan (vg_span > 0; cg_key,
// 405-411, 424-428) is lane 0: the row's block position over the group
// span, (r >> log2C) / vg_span (a power of two: one shift), made from
// the row index with no column read, never MISSING; a group scan's
// config has no sort_pack, so it is an unpacked int64 lane sorted like
// any other (a packed key takes it, and the time key, as a digit like
// any lane).  Filters are K2's (filters.cuh); a row without the time
// column is unmatched; the time key is trunc_div(t, tb) * tb with Go's
// division, in int32 arithmetic under time_i32 like the reference's
// (time_key.cuh).  For a samples query the sorted form also
// writes the matched mask, one byte a row (_scan_sorted 1273-1274); the
// enum form never does (enum_radix declines samples).
//
// In its enum form (chosen when the engine runs the enumerated strategy)
// it replaces the front end of _scan_enum (1420-1435, 1596-1597): the
// same packed key, always int32 there since the radix is at most 2^21,
// the spill count, and the whole-scan totals totals[0] = sum of the
// matched rows' weights (1 where the weight column is missing or absent)
// and totals[1] = matched rows, exact and wrapping mod 2^64 like the
// reference's int64 sums; idxm is not written.
//
// sort_permute replaces the operand permutation inside the reference's
// multi-key lax.sort (1119): the port sorts the key lanes one stable
// torch.sort at a time, least significant first, so between two sorts
// it composes the running permutation with the last sort's indices
// (base[p], or p) and gathers the next key lane through it.
//
// Bound: memory.  sorted_front reads 9 B per referenced column per row
// and writes 4 B of idxm plus the 4 or 8 B packed key, or 8 B per key
// lane (the enum form: the 4 B key, and the weight column read).
// sort_permute reads p and gathers 8 B once or twice per row; a gathered
// word costs a whole 32-byte sector unless its neighbours are read while
// the sector is in L2.
//
// What a trace of the former kernels showed (PERF.md §6, the sorted
// front end's redesign; torch.profiler on the H100).  sorted_front took
// one row a thread, 8 CTAs of 256 threads a SM, and a row's loads formed
// one chain (the record count, then each filter, short-circuited, then
// the time column, then each key lane, the time key's branch taken
// inside the key loop):
// path 1's one filter cost 56 us of 151 (S4b's same launch without a
// filter 94 us), and a call was one or two memsets and the kernel.
// sort_permute took one row a thread, a chain of two or three dependent
// loads each.
//
// Design.  sorted_front is K2's tile (dense_scan.cu): one CTA of TT
// threads a SM, a warp's tiles of 32 x TU rows (rows lane + 32u, so each
// load and store is coalesced) read a column at a time: the record
// counts, each filter's TU rows (filters.cuh), the time column's and then
// each key's TU rows are loaded together, unconditionally, before any of
// them is used.  The form (unpacked, packed int32 or int64, enum), MASK,
// CG, TIME and HEAD (where the descriptor block lies, desc.cuh) are
// template parameters, so the time and cache-group lanes are peeled off
// the key loop.  The spill count and the totals are summed a warp at a
// time by shuffles, then a CTA at a time, and added once a CTA; they
// share one buffer, zeroed by the call's one memset (the unpacked form
// needs none: its spill, always 0, is written by the kernel).
// sort_permute: a lane's PU rows (lane + 32u) load their p together, then
// their base words, then their nxt words, so a thread has PU chains in
// flight rather than one; and each CTA takes its chunks of rows in the
// order of their first row's source, so that the ascending runs of a
// stable sort's p gather each sector of the sources from L2 together
// rather than from memory once a run.  The more chunks a CTA orders, the
// narrower that window: 2 rows a lane and 4 CTAs of 256 threads a SM give
// path 2's 8,388,608 rows 31 chunks a CTA (kernel_variants.py on the
// H100: 0.076 ms; 4 rows a lane and 8 CTAs a SM, 8 chunks, 0.105; in row
// order 0.134).

#include <cstdint>
#include <cuda_runtime.h>

#include "desc.cuh"
#include "filters.cuh"
#include "time_key.cuh"

namespace {

constexpr int TT = 1024;     // sorted_front's threads (one CTA a SM)
constexpr int TU = 4;        // rows a lane a tile: 32 x TU rows a warp
constexpr int PT = 256;      // sort_permute's threads a CTA
constexpr int PU = 2;        // sort_permute's rows a lane a tile
constexpr long long SENTINEL = 0x7fffffffffffffffll;
constexpr unsigned FULL = 0xffffffffu;

// the forms: the key lanes, the packed key (int32, int64), the enum form
enum { F_LANES, F_I32, F_I64, F_ENUM };

}  // namespace

// Mirrored field for field by SortedFrontArgs in ops/scan.py (ctypes).  The
// per-key, per-distinct-column and per-filter arrays point into the
// descriptor block (desc.cuh): no fixed cap on their counts.
struct SortedFrontArgs {
  Desc desc;
  const long long* const* key_vals;   // [ngroups] group columns
  const unsigned char* const* key_valid;
  const long long* pack_min;          // [nkeys] per key lane (packed)
  const long long* pack_card;
  const long long* const* d_vals;     // [ndist] distinct columns
  const unsigned char* const* d_valid;
  const long long* const* f_vals;     // [nfilters]; set ops: K14's hit
  const unsigned char* const* f_valid;  // set ops: K14's has
  const unsigned char* const* f_bits; // regex bitsets (re/nre) or null
  const long long* f_bits_len;
  // 0 gt, 1 lt, 2 eq, 3 neq, 4 re, 5 nre, 6 never, 7 set in, 8 set nin
  const long long* f_op;
  const long long* filter_vals;       // [nfilters] filter constants
  const long long* t_vals;            // time column (has_time)
  const unsigned char* t_valid;
  const int* nrec;                    // [B] valid records per block
  void* key_out;             // int32/int64 [R] packed, int64 [K + D, R]
  int* idxm;                          // [R] (not in the enum form)
  // [3]: the spill count, then the enum form's totals (sum w, matched
  // rows)
  unsigned long long* counts;
  const long long* w_vals;            // weight column (has_weight)
  const unsigned char* w_valid;
  unsigned char* mask;                // [R] matched rows (MASK), or null
  unsigned long long* paths;          // [K7_PATHS] CTA counts, or null
  long long R;
  long long tb;                       // time bucket (> 0)
  long long sent;                     // packed sentinel
  int log2C;
  int nkeys;                          // key lanes, >= 1
  int ngroups;                        // group columns
  int nfilters;
  int has_time;                       // the time key follows the cg lane
  int time_i32;
  int packed;                         // 0 unpacked, 1 int32, 2 int64 key
  int has_weight;
  int ndist;                          // distinct lanes (unpacked only)
  int vg_span;                        // > 0: lane 0 is the cache-group key
};

namespace {

// The instantiations a launch adds its CTAs to (`paths`, ops/scan.py
// K7_PATHS): the enum form, the mask, the cache-group lane, the time key,
// the descriptor in the parameters or in device memory, unpacked lanes,
// packed int32 and int64, the distinct lanes.
enum { P_ENUM, P_MASK, P_CG, P_TIME, P_HEAD, P_DEV, P_LANES, P_I32, P_I64,
       P_DIST, NPATHS };

// The key state of a warp's tile: unpacked, each lane's TU values are
// written as they come (SENTINEL for unmatched rows); packed, they fold
// into the mixed-radix key and the bad-digit bits.
template <int F, bool HEAD>
struct TileKeys {
  const SortedFrontArgs& a;
  long long r;
  unsigned inr, live;
  unsigned long long acc[TU];
  unsigned bad = 0u;
  int k = 0;                          // the next key lane

  __device__ __forceinline__ TileKeys(const SortedFrontArgs& args,
                                      long long row, unsigned in,
                                      unsigned lv)
      : a(args), r(row), inr(in), live(lv) {
#pragma unroll
    for (int u = 0; u < TU; ++u) acc[u] = 0ull;
  }

  // lane k's value of each row (MISSING = -1)
  __device__ __forceinline__ void put(const long long* v) {
    if (F == F_LANES) {
      long long* out = static_cast<long long*>(a.key_out) + (size_t)k * a.R;
#pragma unroll
      for (int u = 0; u < TU; ++u)
        if ((inr >> u) & 1u)
          out[r + 32 * u] = (live >> u) & 1u ? v[u] : SENTINEL;
    } else {
      const long long card = desc_at<HEAD>(a.desc, a.pack_card, k);
      const unsigned long long mn =
          (unsigned long long)desc_at<HEAD>(a.desc, a.pack_min, k);
#pragma unroll
      for (int u = 0; u < TU; ++u) {
        const long long d =
            v[u] == -1ll ? 0ll
                         : (long long)((unsigned long long)v[u] - mn + 1ull);
        bad |= (unsigned)(d < 0 || d > card) << u;
        acc[u] = acc[u] * (unsigned long long)(card + 1) +
                 (unsigned long long)d;
      }
    }
    ++k;
  }

  // a column's lane: its TU rows loaded together, MISSING where invalid
  __device__ __forceinline__ void put_col(const long long* vals,
                                          const unsigned char* valid) {
    long long v[TU];
    unsigned ok = 0u;
#pragma unroll
    for (int u = 0; u < TU; ++u) {
      v[u] = 0;
      if ((inr >> u) & 1u) {
        ok |= (unsigned)(valid[r + 32 * u] != 0) << u;
        v[u] = vals[r + 32 * u];
      }
    }
#pragma unroll
    for (int u = 0; u < TU; ++u)
      if (!((ok >> u) & 1u)) v[u] = -1ll;
    put(v);
  }
};

// One warp's tile, rows r + 32u: the match, idxm and the mask, then the
// key lanes in order [cg?, time?, *groups, zero lane?, *distinct].
// Returns the rows that spilled (packed forms); the enum form adds the
// matched rows' weights to *wsum and their count to *nmatch.
template <int F, bool HEAD, bool MASK, bool CG, bool TIME>
__device__ __forceinline__ unsigned front_tile(const SortedFrontArgs& a,
                                               long long r,
                                               const long long* s_fv,
                                               unsigned long long* wsum,
                                               unsigned* nmatch) {
  unsigned inr;
  unsigned live = tile_in_range<TU>(a.nrec, a.R, a.log2C, r, &inr);
  live = tile_filters<HEAD, TU>(a, r, inr, live, s_fv);
  long long tk[TU];
  if (TIME) {
    unsigned tv = 0u;
#pragma unroll
    for (int u = 0; u < TU; ++u) {
      tk[u] = 0;
      if ((inr >> u) & 1u) {
        tv |= (unsigned)(a.t_valid[r + 32 * u] != 0) << u;
        tk[u] = a.t_vals[r + 32 * u];
      }
    }
    live &= tv;
#pragma unroll
    for (int u = 0; u < TU; ++u) tk[u] = time_key(tk[u], a.tb, a.time_i32);
  }
  if (F == F_ENUM) {
    unsigned long long w = 0ull;
    if (a.has_weight) {
      long long wv[TU];
      unsigned ok = 0u;
#pragma unroll
      for (int u = 0; u < TU; ++u) {
        wv[u] = 0;
        if ((inr >> u) & 1u) {
          ok |= (unsigned)(a.w_valid[r + 32 * u] != 0) << u;
          wv[u] = a.w_vals[r + 32 * u];
        }
      }
#pragma unroll
      for (int u = 0; u < TU; ++u)
        if ((live >> u) & 1u)
          w += (ok >> u) & 1u ? (unsigned long long)wv[u] : 1ull;
    } else {
      w = __popc(live);
    }
    *wsum += w;
    *nmatch += __popc(live);
  } else {
#pragma unroll
    for (int u = 0; u < TU; ++u) {
      if (!((inr >> u) & 1u)) continue;
      const long long ru = r + 32 * u;
      a.idxm[ru] = (live >> u) & 1u ? (int)((unsigned)ru | 0x80000000u)
                                    : (int)ru;
      if (MASK) a.mask[ru] = (live >> u) & 1u;
    }
  }
  TileKeys<F, HEAD> keys(a, r, inr, live);
  if (CG) {
    const int sh = a.log2C + __ffs(a.vg_span) - 1;
    long long v[TU];
#pragma unroll
    for (int u = 0; u < TU; ++u) v[u] = (r + 32 * u) >> sh;
    keys.put(v);
  }
  if (TIME) keys.put(tk);
  for (int g = 0; g < a.ngroups; ++g)
    keys.put_col(desc_at<HEAD>(a.desc, a.key_vals, g),
                 desc_at<HEAD>(a.desc, a.key_valid, g));
  while (keys.k < a.nkeys) {  // a scan without keys: one zero lane
    const long long zero[TU] = {};
    keys.put(zero);
  }
  if (F == F_LANES) {
    for (int j = 0; j < a.ndist; ++j)
      keys.put_col(desc_at<HEAD>(a.desc, a.d_vals, j),
                   desc_at<HEAD>(a.desc, a.d_valid, j));
    return 0u;
  }
#pragma unroll
  for (int u = 0; u < TU; ++u) {
    if (!((inr >> u) & 1u)) continue;
    const bool ok = ((live & ~keys.bad) >> u) & 1u;
    const long long out = ok ? (long long)keys.acc[u] : a.sent;
    if (F == F_I64)
      static_cast<long long*>(a.key_out)[r + 32 * u] = out;
    else
      static_cast<int*>(a.key_out)[r + 32 * u] = (int)out;
  }
  return __popc(live & keys.bad);
}

// One CTA of TT threads a SM; a warp takes tiles of 32 x TU rows by a
// grid stride.  The packed forms' spill counts and the enum form's
// totals are summed a warp, then a CTA at a time, and added once a CTA.
template <int F, bool HEAD, bool MASK, bool CG, bool TIME>
__global__ void __launch_bounds__(TT, 1) sorted_front_tiles(
    const SortedFrontArgs a) {
  __shared__ long long s_fv[FV_SMEM];
  __shared__ unsigned s_spill[TT / 32], s_n[TT / 32];
  __shared__ unsigned long long s_w[TT / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x < min(a.nfilters, FV_SMEM))
    s_fv[threadIdx.x] = a.filter_vals[threadIdx.x];
  __syncthreads();
  unsigned spill = 0u, n = 0u;
  unsigned long long w = 0ull;
  const long long step = (long long)gridDim.x * TT * TU;
  for (long long r0 = ((long long)blockIdx.x * (TT / 32) + warp) * (32 * TU);
       r0 < a.R; r0 += step)
    spill += front_tile<F, HEAD, MASK, CG, TIME>(a, r0 + lane, s_fv, &w, &n);
  if (F == F_LANES) {
    if (blockIdx.x == 0 && threadIdx.x == 0) a.counts[0] = 0ull;
  } else {
    spill = __reduce_add_sync(FULL, spill);
    if (F == F_ENUM) {
      n = __reduce_add_sync(FULL, n);
#pragma unroll
      for (int o = 16; o; o >>= 1) w += __shfl_xor_sync(FULL, w, o);
    }
    if (lane == 0) {
      s_spill[warp] = spill;
      s_n[warp] = n;
      s_w[warp] = w;
    }
    __syncthreads();
    if (warp == 0) {
      const bool in = lane < TT / 32;
      spill = __reduce_add_sync(FULL, in ? s_spill[lane] : 0u);
      if (lane == 0 && spill) atomicAdd(a.counts, (unsigned long long)spill);
      if (F == F_ENUM) {
        n = __reduce_add_sync(FULL, in ? s_n[lane] : 0u);
        w = in ? s_w[lane] : 0ull;
#pragma unroll
        for (int o = 16; o; o >>= 1) w += __shfl_xor_sync(FULL, w, o);
        if (lane == 0) {
          if (w) atomicAdd(a.counts + 1, w);
          if (n) atomicAdd(a.counts + 2, (unsigned long long)n);
        }
      }
    }
  }
  if (a.paths && threadIdx.x == 0) {
    const bool took[NPATHS] = {F == F_ENUM, MASK, CG, TIME, HEAD, !HEAD,
                               F == F_LANES, F == F_I32 || F == F_ENUM,
                               F == F_I64, F == F_LANES && a.ndist > 0};
    for (int i = 0; i < NPATHS; ++i)
      if (took[i]) atomicAdd(a.paths + i, 1ull);
  }
}

// base_out[i] = base[p[i]] (BASE) and gathered[i] = nxt[that] (GATHER),
// or nxt[p[i]] without a base, over chunks of PT * PU rows, a tile a warp:
// a lane's PU rows (lane + 32u) load their p together, then
// their base words, then their nxt words.  CTA b takes the chunks b +
// grid * i (i < m <= 32: the entry sizes the grid) in the order of their
// first row's source, p[chunk start]: a stable sort's p is a few
// ascending runs, which row order sweeps over the source rows one run
// after another, each gathered word a 32-byte sector from memory; in
// source order every CTA's k-th chunk reads about the same window of the
// sources, so the runs share each sector while it is in L2.
template <bool BASE, bool GATHER>
__global__ void __launch_bounds__(PT) sort_permute_chunks(
    const long long* __restrict__ base, const long long* __restrict__ p,
    const long long* __restrict__ nxt, long long* __restrict__ base_out,
    long long* __restrict__ gathered, long long R) {
  __shared__ int s_ord[32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int CH = PT * PU;
  const long long nch = (R + CH - 1) / CH;
  const int m = (int)((nch - blockIdx.x + gridDim.x - 1) / gridDim.x);
  if (m > 1 && warp == 0) {  // each chunk's rank by its first source
    const long long key =
        lane < m ? p[(blockIdx.x + (long long)gridDim.x * lane) * CH]
                 : 0x7fffffffffffffffll;
    int rank = 0;
    for (int o = 0; o < 32; ++o) {
      const long long ko = __shfl_sync(FULL, key, o);
      rank += ko < key || (ko == key && o < lane);
    }
    if (lane < m) s_ord[rank] = lane;
  }
  if (m > 1) __syncthreads();
  for (int k = 0; k < m; ++k) {
    const long long c =
        blockIdx.x + (long long)gridDim.x * (m > 1 ? s_ord[k] : 0);
    const long long r1 = min(R, (c + 1) * CH);
    const long long r = c * CH + warp * 32 * PU + lane;
    long long j[PU];
#pragma unroll
    for (int u = 0; u < PU; ++u)
      j[u] = r + 32 * u < r1 ? __ldcs(p + r + 32 * u) : 0ll;
    if (BASE) {
#pragma unroll
      for (int u = 0; u < PU; ++u)
        if (r + 32 * u < r1) j[u] = base[j[u]];
    }
    long long g[PU];
    if (GATHER) {
#pragma unroll
      for (int u = 0; u < PU; ++u)
        g[u] = r + 32 * u < r1 ? nxt[j[u]] : 0ll;
    }
#pragma unroll
    for (int u = 0; u < PU; ++u) {
      if (r + 32 * u >= r1) continue;
      if (BASE) __stcs(base_out + r + 32 * u, j[u]);
      if (GATHER) __stcs(gathered + r + 32 * u, g[u]);
    }
  }
}

template <int F, bool HEAD, bool MASK>
void launch_lanes(const SortedFrontArgs* args, int grid, cudaStream_t s) {
  const bool cg = args->vg_span > 0, time = args->has_time;
  if (cg && time)
    sorted_front_tiles<F, HEAD, MASK, true, true><<<grid, TT, 0, s>>>(*args);
  else if (cg)
    sorted_front_tiles<F, HEAD, MASK, true, false><<<grid, TT, 0, s>>>(
        *args);
  else if (time)
    sorted_front_tiles<F, HEAD, MASK, false, true><<<grid, TT, 0, s>>>(
        *args);
  else
    sorted_front_tiles<F, HEAD, MASK, false, false><<<grid, TT, 0, s>>>(
        *args);
}

template <int F, bool HEAD>
void launch_mask(const SortedFrontArgs* args, int grid, cudaStream_t s) {
  if constexpr (F == F_ENUM) {
    sorted_front_tiles<F, HEAD, false, false, false><<<grid, TT, 0, s>>>(
        *args);
  } else {
    if (args->mask) launch_lanes<F, HEAD, true>(args, grid, s);
    else launch_lanes<F, HEAD, false>(args, grid, s);
  }
}

template <int F>
void launch_form(const SortedFrontArgs* args, int grid, cudaStream_t s) {
  if (args->desc.n <= DESC_HEAD) launch_mask<F, true>(args, grid, s);
  else launch_mask<F, false>(args, grid, s);
}

}  // namespace

// Copies the descriptor block when it passes its head, zeroes the spill
// count (and the enum form's totals: one memset; the unpacked form needs
// none), then one launch of TT-thread CTAs (`grid`, one a SM) on
// `stream`: the enum form when `enum_form` is set (packed int32, no mask,
// no cache-group or time key), else the packed key (packed 1 or 2) or
// the key lanes and the distinct lanes (packed 0),
// writing the matched mask when `mask` is set and making lane 0 the
// cache-group key when vg_span > 0 (a power of two).  Returns
// cudaError_t.
extern "C" int sorted_front(const SortedFrontArgs* args, int enum_form,
                            int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int packed = args->packed;
  if (args->R >= (1ll << 31) || packed < 0 || packed > 2 ||
      (enum_form && (packed != 1 || args->mask)) ||
      (args->ndist > 0 && packed) ||
      (enum_form && (args->has_time || args->vg_span)) ||
      args->vg_span < 0 || (args->vg_span & (args->vg_span - 1)) ||
      (args->vg_span && args->nkeys < 1 + args->has_time))
    return cudaErrorInvalidValue;
  cudaError_t err = desc_upload(args->desc, s);
  if (err != cudaSuccess) return err;
  if (packed) {
    err = cudaMemsetAsync(args->counts, 0,
                          (enum_form ? 3 : 1) * sizeof(unsigned long long),
                          s);
    if (err != cudaSuccess) return err;
  }
  if (enum_form) launch_form<F_ENUM>(args, grid, s);
  else if (packed == 1) launch_form<F_I32>(args, grid, s);
  else if (packed == 2) launch_form<F_I64>(args, grid, s);
  else launch_form<F_LANES>(args, grid, s);
  return cudaGetLastError();
}

// base_out[i] = base[p[i]] (base non-null) and gathered[i] = nxt[base_out
// [i]], or nxt[p[i]] without a base, over R rows in `grid` CTAs of PT
// threads on `stream` (more where a CTA would take over 32 chunks of
// PT * PU rows, fewer where there are fewer chunks), each CTA taking its
// chunks in their sources' order.  Returns cudaError_t.
extern "C" int sort_permute(const long long* base, const long long* p,
                            const long long* nxt, long long* base_out,
                            long long* gathered, long long R, int grid,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((base == nullptr) != (base_out == nullptr) ||
      (nxt == nullptr) != (gathered == nullptr) || grid < 1 || R < 0)
    return cudaErrorInvalidValue;
  if (R == 0 || (!base && !nxt)) return cudaSuccess;
  const long long nch = (R + PT * PU - 1) / (PT * PU);
  if (grid > nch) grid = (int)nch;
  if (grid < (nch + 31) / 32) grid = (int)((nch + 31) / 32);
  if (base && nxt)
    sort_permute_chunks<true, true><<<grid, PT, 0, s>>>(
        base, p, nxt, base_out, gathered, R);
  else if (base)
    sort_permute_chunks<true, false><<<grid, PT, 0, s>>>(
        base, p, nxt, base_out, gathered, R);
  else
    sort_permute_chunks<false, true><<<grid, PT, 0, s>>>(
        base, p, nxt, base_out, gathered, R);
  return cudaGetLastError();
}
