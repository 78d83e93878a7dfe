// K10 sorted_pack: the keyed group table and the packed download buffer of
// the sorted scan strategy, with the device prune's score and gather, and
// the enumerated strategy's table (enum_pack).
//
// Replaces sybil_tpu/ops/scan.py:pack_outputs for a non-dense scan:
//   table    [S, K+2+5A] (1865-1872): each slot's keys, count, samples,
//            and per aggregation exists (0/1: its lane sum > 0), count,
//            wv, min, max (+2^62 / -2^62 for an avg aggregation; a mesh
//            scan's merged table brings every aggregation's min and max,
//            mmw = A); it stays on the device for the engine's escalation;
//   meta     row 0 (1902-1965): [num_groups, spill, nout per hist agg,
//            npairs (distinct pairs, else 0), the mesh shuffle's overflow
//            (0 without a mesh), pruned,
//            total count, total samples, nhistpairs per hist agg],
//            zero-padded to W;
//   prefix   rows 1..P: the table's first P rows, zero-padded to W;
//   pairs    per histogram aggregation (1979-1991), Hcap rows [keys,
//            bucket, Σw, live] of the first Hcap rows of hp_mask in row
//            order; when fewer are set the rest repeat row R-1 with live
//            = 0, as _mask_positions' clipped searchsorted does;
//   distinct with D distinct columns (1925-1933), kmax_pairs rows [the
//            K group and D distinct keys, live] of the first kmax_pairs
//            rows of K8's pair_mask, padded the same way, and meta word
//            2 + H = npairs, the number of set rows.
// K5 writes the outlier rows between the prefix and the pair sections;
// this kernel leaves them alone.
//
// The device prune (prune_topk > 0, 1874-1900, 1961-1963): the prefix is
// not written; each slot's score (live = count > 0 or samples > 0; by
// $COUNT its count where live else -1, int64; by an aggregation's mean
// f32(wv) / f32(max(count, 1)) where live and count > 0, else -inf, with
// IEEE division) goes to `score` for K12, and the meta row gets pruned =
// min(prune_topk, S, P) and the sums of the count and samples columns over
// the whole [S] table.  prune_gather then writes table[pidx] (K12's
// winners, in their order) as the prefix and as the pruned table.
//
// enum_pack replaces the readout of _scan_enum (1547-1607) and its part of
// pack_outputs (1866-1879, 1902-1960): for each of the Pk = min(P, R)
// winners of K12 (row indices into the sorted packed keys) its live flag
// (the last row of a segment whose key is below the radix), its keys (the
// mixed-radix digits of its packed key, digit 0 = MISSING, else digit - 1
// + min; SENTINEL when dead), its lanes from K11's sums (0 when dead),
// min/max +2^62 / -2^62; padding rows to P (SENTINEL keys, zero lanes);
// the meta row [num_groups, spill, 0, 0, pruned = P, total count, total
// samples].
//
// Bound: memory.  The table is S x (K+2+5A) words (100,000 slots by
// default), written once and its prefix copied; the pair sections read
// one byte of hp_mask per row and write Hcap x W words; the prune reads
// the table's sums once more.  Design: one grid-stride launch for the
// table, the prefix and the meta row (plus one for the prune score and
// totals, per-CTA sums and one atomic each); then, for all histogram
// aggregations at once (gridDim.y), K5's compaction: count the set rows
// per TILE-row tile, scan the counts (one CTA each), rank and write the
// first Hcap rows, then the padding rows.  prune_gather and enum_pack are
// one grid-stride launch each over P rows.

#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "desc.cuh"
#include <math_constants.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 4096;
constexpr int SCAN_THREADS = 1024;
constexpr long long BIG = 1ll << 62;
constexpr long long SENTINEL = 0x7fffffffffffffffll;
constexpr unsigned FULL = 0xffffffffu;

}  // namespace

// Mirrored field for field by SortedPackArgs in ops/scan.py (ctypes).  The
// per-aggregation arrays point into the descriptor block (desc.cuh): no
// fixed cap on their count.
struct SortedPackArgs {
  Desc desc;
  const unsigned long long* sums;       // [S+1, L]
  const long long* mins;                // [S, H]
  const long long* maxs;                // [S, H]
  const long long* keys_tbl;            // [S, K]
  const long long* num_groups;          // [1]
  const long long* spill;               // [1]
  const long long* const* nout;         // [H] [1] per hist agg, or null
  const unsigned char* const* hp_mask;  // [H] [R] per hist agg
  const long long* const* hp_keys;      // [H] [R, K]
  const long long* const* hp_bv;        // [H] [R]
  const long long* const* hp_w;         // [H] [R]
  const long long* const* npairs;       // [H] [1]
  const long long* hp_row;              // [H] first row of each pair section
  const long long* agg_mm;              // [A] hist index of each agg, -1 = none
  const unsigned char* pair_mask;       // [R] K8's distinct pair mask (D > 0)
  const long long* kmat;                // [R, K] sorted group keys
  const long long* dmat;                // [R, D] sorted distinct keys
  long long pair_row;                   // first row of the distinct section
  long long* table;                     // [S, K+2+5A]
  long long* main;                      // [rows, W]
  int* offsets;                         // [H, ntiles + 1] scratch
  void* score;                          // [S] prune score, int64 or f32
  long long R;
  int S;
  int P;                                // table rows in main
  int K;
  int A;
  int L;
  int H;
  int W;
  int Hcap;
  int ntiles;
  int prune;                            // the device prune's form
  int prune_agg;                        // -1: $COUNT, else the agg
  int pruned;                           // min(prune_topk, S, P)
  int D;                                // distinct columns
  int kmax_pairs;                       // rows of the distinct section
  const long long* overflow;            // [1] meta word 3 + H, or null
  int mmw;                              // words in a row of mins and maxs
  int pad_;
};

// Mirrored field for field by EnumPackArgs in ops/scan.py (ctypes).
// pack_min and pack_card point into the descriptor block (desc.cuh), of
// [K] each.
struct EnumPackArgs {
  Desc desc;
  const int* skey;                      // [R] sorted packed key
  const int* gid;                       // [R] K11's segment of each row
  const unsigned long long* sums;       // [Smax, L] K11's segment sums
  const int* widx;                      // [Pk] K12's winners
  const long long* num_groups;          // [1] live segments
  const long long* spill;               // [1]
  const long long* totals;              // [2] total count, total samples
  long long* table;                     // [P, K+2+5A]
  long long* main;                      // [1 + P, W]
  const long long* pack_min;            // [K]
  const long long* pack_card;
  long long R;
  int radix;
  int Pk;
  int P;
  int K;
  int A;
  int L;
  int W;
  int pad_;
};

namespace {

__global__ void __launch_bounds__(THREADS) table_kernel(
    const SortedPackArgs a) {
  const int Wt = a.K + 2 + 5 * a.A;
  const long long n = (long long)a.S * a.W;
  for (long long idx = (long long)blockIdx.x * THREADS + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * THREADS) {
    const long long g = idx / a.W;
    const int c = (int)(idx - g * a.W);
    long long v = 0;
    if (c < Wt) {
      const unsigned long long* s = a.sums + g * a.L;
      if (c < a.K) {
        v = a.keys_tbl[g * a.K + c];
      } else if (c < a.K + 2) {
        v = (long long)s[c - a.K];
      } else {
        const int ai = (c - a.K - 2) / 5, f = (c - a.K - 2) % 5;
        const int mm = (int)desc_at(a.desc, a.agg_mm, ai);
        switch (f) {
          case 0: v = (long long)s[2 + 3 * ai] > 0; break;
          case 1: v = (long long)s[3 + 3 * ai]; break;
          case 2: v = (long long)s[4 + 3 * ai]; break;
          case 3: v = mm >= 0 ? a.mins[g * a.mmw + mm] : BIG; break;
          default: v = mm >= 0 ? a.maxs[g * a.mmw + mm] : -BIG; break;
        }
      }
      a.table[g * Wt + c] = v;
    }
    if (g < a.P && !a.prune) a.main[(1 + g) * a.W + c] = v;
  }
  for (int c = threadIdx.x; blockIdx.x == 0 && c < a.W; c += THREADS) {
    long long v = 0;
    if (c == 0) {
      v = a.num_groups[0];
    } else if (c == 1) {
      v = a.spill[0];
    } else if (c < 2 + a.H) {
      const long long* nout = desc_at(a.desc, a.nout, c - 2);
      v = nout ? nout[0] : 0ll;
    } else if (c == 3 + a.H) {
      v = a.overflow ? a.overflow[0] : 0ll;
    } else if (c == 4 + a.H) {
      v = a.prune ? a.pruned : 0;
    } else if (c >= 7 + a.H && c < 7 + 2 * a.H) {
      v = desc_at(a.desc, a.npairs, c - 7 - a.H)[0];
    }
    a.main[c] = v;
  }
}

// The device prune: each slot's score, and the count and sample totals of
// the [S] table added into meta words 5 + H and 6 + H (zero from
// table_kernel, which runs first on the stream).
__global__ void __launch_bounds__(THREADS) prune_score_kernel(
    const SortedPackArgs a) {
  __shared__ unsigned long long s_count, s_samples;
  if (threadIdx.x == 0) s_count = s_samples = 0ull;
  __syncthreads();
  unsigned long long my_count = 0ull, my_samples = 0ull;
  for (long long g = (long long)blockIdx.x * THREADS + threadIdx.x; g < a.S;
       g += (long long)gridDim.x * THREADS) {
    const unsigned long long* s = a.sums + g * a.L;
    const long long cnt = (long long)s[0], smp = (long long)s[1];
    my_count += s[0];
    my_samples += s[1];
    const bool live = cnt > 0 || smp > 0;
    if (a.prune_agg >= 0) {
      const long long acnt = (long long)s[3 + 3 * a.prune_agg];
      const long long wv = (long long)s[4 + 3 * a.prune_agg];
      static_cast<float*>(a.score)[g] =
          live && acnt > 0
              ? __fdiv_rn(__ll2float_rn(wv),
                          __ll2float_rn(acnt > 1 ? acnt : 1ll))
              : -CUDART_INF_F;
    } else {
      static_cast<long long*>(a.score)[g] = live ? cnt : -1ll;
    }
  }
  if (my_count) atomicAdd(&s_count, my_count);
  if (my_samples) atomicAdd(&s_samples, my_samples);
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long* meta = reinterpret_cast<unsigned long long*>(a.main);
    if (s_count) atomicAdd(meta + 5 + a.H, s_count);
    if (s_samples) atomicAdd(meta + 6 + a.H, s_samples);
  }
}

__global__ void __launch_bounds__(THREADS) prune_gather_kernel(
    const long long* table, const int* pidx, long long* main,
    long long* ptable, int P, int Wt, int W) {
  const long long n = (long long)P * W;
  for (long long idx = (long long)blockIdx.x * THREADS + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * THREADS) {
    const long long j = idx / W;
    const int c = (int)(idx - j * W);
    long long v = 0;
    if (c < Wt) {
      v = table[(long long)pidx[j] * Wt + c];
      ptable[j * Wt + c] = v;
    }
    main[(1 + j) * W + c] = v;
  }
}

__global__ void __launch_bounds__(THREADS) enum_pack_kernel(
    const EnumPackArgs a) {
  const int K = a.K, L = a.L, Wt = a.K + 2 + 5 * a.A;
  for (long long j = (long long)blockIdx.x * THREADS + threadIdx.x; j < a.P;
       j += (long long)gridDim.x * THREADS) {
    bool live = false;
    int key = 0, seg = 0;
    if (j < a.Pk) {
      const long long w = a.widx[j];
      key = a.skey[w];
      live = key < a.radix && (w == a.R - 1 || a.skey[w + 1] != key);
      seg = a.gid[w];
    }
    long long* row = a.table + j * Wt;
    long long g = key;
    for (int k = K - 1; k >= 0; --k) {
      const long long radix = desc_at(a.desc, a.pack_card, k) + 1;
      const long long d = g % radix;
      g /= radix;
      const unsigned long long mn =
          (unsigned long long)desc_at(a.desc, a.pack_min, k);
      row[k] = !live ? SENTINEL
                     : d == 0 ? -1ll
                              : (long long)((unsigned long long)d - 1ull + mn);
    }
    const unsigned long long* s = a.sums + (size_t)seg * L;
    row[K] = live ? (long long)s[0] : 0ll;
    row[K + 1] = live ? (long long)s[1] : 0ll;
    for (int ai = 0; ai < a.A; ++ai) {
      long long* o = row + K + 2 + 5 * ai;
      o[0] = live && (long long)s[2 + 3 * ai] > 0;
      o[1] = live ? (long long)s[3 + 3 * ai] : 0ll;
      o[2] = live ? (long long)s[4 + 3 * ai] : 0ll;
      o[3] = BIG;
      o[4] = -BIG;
    }
    long long* m = a.main + (1 + j) * a.W;
    for (int c = 0; c < a.W; ++c) m[c] = c < Wt ? row[c] : 0ll;
  }
  for (int c = threadIdx.x; blockIdx.x == 0 && c < a.W; c += THREADS) {
    long long v = 0;
    if (c == 0) v = a.num_groups[0];
    else if (c == 1) v = a.spill[0];
    else if (c == 4) v = a.P;
    else if (c == 5) v = a.totals[0];
    else if (c == 6) v = a.totals[1];
    a.main[c] = v;
  }
}

// Section h of the compaction: histogram aggregation h < H, or the
// distinct pairs (h == H).
__device__ __forceinline__ const unsigned char* sec_mask(
    const SortedPackArgs& a, int h) {
  return h < a.H ? desc_at(a.desc, a.hp_mask, h) : a.pair_mask;
}

__device__ __forceinline__ int sec_cap(const SortedPackArgs& a, int h) {
  return h < a.H ? a.Hcap : a.kmax_pairs;
}

__global__ void __launch_bounds__(THREADS) count_tiles(
    const SortedPackArgs a) {
  const unsigned char* mask = sec_mask(a, blockIdx.y);
  const long long lo = (long long)blockIdx.x * TILE;
  int n = 0;
  for (int t = threadIdx.x; t < TILE; t += THREADS) {
    const long long i = lo + t;
    if (i < a.R && mask[i]) ++n;
  }
  n = __reduce_add_sync(FULL, n);
  __shared__ int s_n;
  if (threadIdx.x == 0) s_n = 0;
  __syncthreads();
  if ((threadIdx.x & 31) == 0 && n) atomicAdd(&s_n, n);
  __syncthreads();
  if (threadIdx.x == 0)
    a.offsets[(size_t)blockIdx.y * (a.ntiles + 1) + blockIdx.x] = s_n;
}

__global__ void __launch_bounds__(SCAN_THREADS) scan_tiles(
    const SortedPackArgs a) {
  int* off = a.offsets + (size_t)blockIdx.x * (a.ntiles + 1);
  int carry = 0;
  for (int base = 0; base < a.ntiles; base += SCAN_THREADS) {
    const int t = base + threadIdx.x;
    const int x = t < a.ntiles ? off[t] : 0;
    int total;
    const int pre = block_scan<SCAN_THREADS>(x, &total);
    if (t < a.ntiles) off[t] = carry + pre;
    carry += total;
  }
  if (threadIdx.x == 0) {
    off[a.ntiles] = carry;
    if (blockIdx.x == a.H) a.main[2 + a.H] = carry;  // npairs
  }
}

__device__ __forceinline__ void write_pair(const SortedPackArgs& a, int h,
                                           long long j, long long r,
                                           long long live) {
  if (h == a.H) {  // distinct: [K group keys, D distinct keys, live]
    long long* o = a.main + (a.pair_row + j) * a.W;
    for (int k = 0; k < a.K; ++k) o[k] = a.kmat[r * a.K + k];
    for (int k = 0; k < a.D; ++k) o[a.K + k] = a.dmat[r * a.D + k];
    o[a.K + a.D] = live;
    for (int k = a.K + a.D + 1; k < a.W; ++k) o[k] = 0;
    return;
  }
  long long* o = a.main + (desc_at(a.desc, a.hp_row, h) + j) * a.W;
  const long long* keys = desc_at(a.desc, a.hp_keys, h) + r * a.K;
  for (int k = 0; k < a.K; ++k) o[k] = keys[k];
  o[a.K] = desc_at(a.desc, a.hp_bv, h)[r];
  o[a.K + 1] = desc_at(a.desc, a.hp_w, h)[r];
  o[a.K + 2] = live;
  for (int k = a.K + 3; k < a.W; ++k) o[k] = 0;
}

__global__ void __launch_bounds__(THREADS) write_pairs(
    const SortedPackArgs a) {
  const int h = blockIdx.y;
  const unsigned char* mask = sec_mask(a, h);
  const int cap = sec_cap(a, h);
  const int* off = a.offsets + (size_t)h * (a.ntiles + 1);
  const long long lo = (long long)blockIdx.x * TILE;
  int rank = off[blockIdx.x];
  const int total = off[a.ntiles];
  if (rank < cap) {
    for (int t = 0; t < TILE && rank < cap; t += THREADS) {
      const long long r = lo + t + threadIdx.x;
      const bool set = r < a.R && mask[r];
      int n;
      const int pre = block_scan<THREADS>(set ? 1 : 0, &n);
      if (set && rank + pre < cap) write_pair(a, h, rank + pre, r, 1);
      rank += n;
    }
  }
  for (long long j = (long long)blockIdx.x * THREADS + threadIdx.x;
       j < cap; j += (long long)gridDim.x * THREADS)
    if (j >= total) write_pair(a, h, j, a.R - 1, 0);
}

}  // namespace

// Copies the descriptor block, runs the table launch (and the prune score
// launch under the device prune), then the pair compaction for every
// histogram aggregation, on `stream`.  Returns cudaError_t.
extern "C" int sorted_pack(const SortedPackArgs* args, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const SortedPackArgs& a = *args;
  if (a.W < 7 + 2 * a.H || a.P > a.S ||
      a.ntiles != (int)((a.R + TILE - 1) / TILE) ||
      (a.prune && (a.score == nullptr || a.prune_agg >= a.A)) ||
      (a.D > 0 && (!a.pair_mask || !a.kmat || !a.dmat ||
                   a.W < a.K + a.D + 1)))
    return cudaErrorInvalidValue;
  const long long n = (long long)a.S * a.W;
  const int grid = (int)((n + THREADS - 1) / THREADS < 1024
                             ? (n + THREADS - 1) / THREADS : 1024);
  cudaError_t err = desc_upload(a.desc, s);
  if (err != cudaSuccess) return err;
  table_kernel<<<grid > 0 ? grid : 1, THREADS, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (a.prune) {
    const int g2 = (int)((a.S + THREADS - 1) / THREADS < 264
                             ? (a.S + THREADS - 1) / THREADS : 264);
    prune_score_kernel<<<g2 > 0 ? g2 : 1, THREADS, 0, s>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int nsec = a.H + (a.D > 0 ? 1 : 0);
  if (nsec == 0) return cudaSuccess;
  count_tiles<<<dim3(a.ntiles, nsec), THREADS, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_tiles<<<nsec, SCAN_THREADS, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  write_pairs<<<dim3(a.ntiles, nsec), THREADS, 0, s>>>(a);
  return cudaGetLastError();
}

// The device prune's second launch: main rows 1..P and ptable [P, Wt] =
// table[pidx].  Returns cudaError_t.
extern "C" int prune_gather(const long long* table, const int* pidx,
                            long long* main, long long* ptable, int S, int P,
                            int Wt, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P < 1 || P > S || W < Wt) return cudaErrorInvalidValue;
  const long long n = (long long)P * W;
  const int grid = (int)((n + THREADS - 1) / THREADS < 1024
                             ? (n + THREADS - 1) / THREADS : 1024);
  prune_gather_kernel<<<grid, THREADS, 0, s>>>(table, pidx, main, ptable, P,
                                               Wt, W);
  return cudaGetLastError();
}

// Copies the descriptor block, then writes the enumerated strategy's
// table, meta row and prefix.  Returns cudaError_t.
extern "C" int enum_pack(const EnumPackArgs* args, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const EnumPackArgs& a = *args;
  if (a.K < 1 || a.L != 2 + 3 * a.A ||
      a.Pk < 1 || a.Pk > a.P || a.W < 7 || a.W < a.K + 2 + 5 * a.A)
    return cudaErrorInvalidValue;
  const cudaError_t err = desc_upload(a.desc, s);
  if (err != cudaSuccess) return err;
  const int grid = (a.P + THREADS - 1) / THREADS;
  enum_pack_kernel<<<grid, THREADS, 0, s>>>(a);
  return cudaGetLastError();
}
