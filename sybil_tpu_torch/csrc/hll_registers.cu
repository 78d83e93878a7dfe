// K13 hll_registers: the device HLL's register planes, one 2^14-register
// plane of uint8 per dense slot.
//
// Replaces sybil_tpu/ops/scan.py: _hash_int_col (828-841), _hll_idx_rank
// (844-857), _key_counts (860-889) and _hll_registers (892-943).  For each
// row r of the batch:
//   slot   K2's gid of the row in the full slot space: a matched row's
//          mixed-radix gid, the dead slot slots-1 for an unmatched one
//          (K2 writes the reduce-space gid, whose dead row is Sc-1; the
//          live rows below it map 1:1);
//   hash   an int column: FNV-1a 64 over the 8 little-endian bytes of the
//          value (MISSING = -1, all bytes 0xFF, where it is missing), then
//          the splitmix64 finaliser, in unsigned 64-bit arithmetic; a str
//          column: the bind's per-dict-id hash array (its last entry is the
//          missing value's hash) at clamp(id, 0, nd-1);
//   index  the top 14 bits of the hash;
//   rank   the leading zeros of hash << 14, plus 1, or 51 when that is 0;
// and the register (slot, index) takes the largest rank.  The reference's
// pair-existence form (a one-hot matmul of row counts per (group, id)
// pair, then a scatter-max over the pairs) is a workaround for the TPU's
// serial row scatter and gives the same registers: every pair present in
// the rows updates the register its rows update, with the same rank.
//
// Bound: memory for a str column (per row 4 B of gid and the 9 B of the
// column; the hash array stays in L1), operations for an int column (the
// hash: eight FNV rounds and the finaliser).  The planes written are at
// most 128 slots x 16 KB = 2 MB (the bind caps the dense slots of the
// device HLL at 128).
//
// What a trace of the former design showed (PERF.md §6, K4's and K13's
// redesign): a grid-stride loop of 256-thread CTAs, one row a thread a
// step, whose every row read the 32-bit word of its register in the
// global planes (an L2 round trip after the row's loads) and raised it by
// an atomicCAS loop.  A str column puts all of a slot's rows on a handful
// of registers, so every row read the same few L2 words.
//
// Design: one cooperative launch (its CTAs co-resident, grid-wide
// barriers between the phases), one CTA of TT threads a SM, no memset.
// A register is kept first as a thermometer byte: a rank r of at most 8
// sets bits 0..r-1, so the largest rank is their union (a bitwise OR, one
// atomic with no compare loop and no returned value) and the byte's
// popcount.  A rank past 8 (one row in 256) goes to a 32-bit word of its
// own register by an atomicMax with no returned value; a small per-CTA
// table of the (register, rank) pairs it has sent spares a str column's
// hot registers the repeated adds.
//   phase 0  the CTAs zero the rank words (and the global form's
//            thermometer planes); barrier.
//   phase 1  a warp takes tiles of 32 x TU rows by a grid stride (rows
//            lane + 32u, every load coalesced; the next tile's loads in
//            flight while this one hashes), hashes them and ORs each
//            row's bits into its register's thermometer byte where they
//            are missing.  The int hash multiplies by FNV's prime 2^40 +
//            0x1b3 as a shift, an add and a multiply by a 9-bit constant.
//            The thermometer planes, by their size (the wrapper's choice,
//            ops/scan.py hll_route; both give the same registers):
//              shared  every plane the rows can reach (Sc of them: the
//                      live slots and the dead one) in the CTA's shared
//                      memory, a row's word read first; the CTA then
//                      stores its planes to its own part of a scratch
//                      buffer;
//              global  Sc planes in the scratch for every CTA, each CTA
//                      keeping a cache of the words it has ORed and with
//                      which bits, so a str column's hot words are ORed
//                      once a CTA and an int column's words are not read.
//            barrier.
//   phase 2  each CTA takes a slice of the output words: the OR over
//            every CTA's part (the shared form; its threads split the
//            parts), each byte's popcount, the larger of that and the
//            register's rank word; zeros for the slots no row reaches.
// Tried and dropped on the H100 (the same PERF.md entry; device ms at the
// int hash, 7 planes, and at 128 slots): a CAS a row on the global
// registers in the tiled loop (0.2254 at 128 slots, the parent 0.2065);
// exact bytes raised by a shared CAS, merged by a CAS a word into the
// zeroed global planes (0.1249, the merge 35 µs of it) or by the bytewise
// maximum over the CTAs' parts (0.1473 with a thread a column); ranks
// past 8 raised by a CAS on the output register (0.1297, a warp stalled on
// two L2 round trips); the global form's word read first (0.1707 at 128
// slots) or ORed on every row (str 0.2067 at 128 slots), in place of the
// cache.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TT = 1024;     // threads of the one CTA a SM
constexpr int TU = 4;        // rows a lane a tile: 32 x TU rows a warp
constexpr int HLL_P = 14;
constexpr long long HLL_M = 1ll << HLL_P;
constexpr int PLANE_WORDS = (int)(HLL_M / 4);   // 4 registers a word
constexpr unsigned TH_MAX = 8;                  // ranks a thermometer holds
constexpr int SEEN = 256;                       // the sent-ranks table
constexpr int CACHE = 4096;                     // the ORed-words cache

}  // namespace

// Mirrored field for field by HllArgs in ops/scan.py (ctypes).
struct HllArgs {
  const int* gid;               // [R] K2's reduce-space gid (dead = Sc-1)
  const long long* vals;        // [R] the distinct column
  const unsigned char* valid;   // [R]
  const long long* hashes;      // [nd] per-dict-id hashes, or null (int)
  unsigned int* regs;           // [slots * HLL_M / 4]: 4 registers a word
  unsigned int* scratch;        // [Sc * HLL_M] rank words, then the
                                // thermometer planes: [grid][Sc * HLL_M
                                // / 4] (shared form), [Sc * HLL_M / 4]
  unsigned long long* paths;    // [2] CTAs of each form, or null
  long long R;
  long long nd;                 // hash entries, the missing one included
  int Sc;
  int slots;
};

namespace {

// FNV-1a 64 over the 8 little-endian bytes of v, then splitmix64's
// finaliser (sybil_tpu/query/hll.py hash64 on the int fast path's bytes).
// h * (2^40 + 0x1b3) mod 2^64 = (h << 40) + h * 0x1b3.
__device__ __forceinline__ unsigned long long hash_int(long long v) {
  const unsigned long long u = (unsigned long long)v;
  unsigned long long h = 0xcbf29ce484222325ull;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    h ^= (u >> (8 * i)) & 0xffull;
    h = (h << 40) + h * 0x1b3ull;
  }
  h += 0x9E3779B97F4A7C15ull;
  h = (h ^ (h >> 30)) * 0xBF58476D1CE4E5B9ull;
  h = (h ^ (h >> 27)) * 0x94D049BB133111EBull;
  return h ^ (h >> 31);
}

// The popcount of each byte of x.
__device__ __forceinline__ unsigned byte_popc(unsigned x) {
  x = x - ((x >> 1) & 0x55555555u);
  x = (x & 0x33333333u) + ((x >> 2) & 0x33333333u);
  return (x + (x >> 4)) & 0x0f0f0f0fu;
}

// The global slot of plane p (the dead plane Sc-1 is slot slots-1).
__device__ __forceinline__ long long slot_of(const HllArgs& a, int p) {
  return p == a.Sc - 1 ? a.slots - 1 : p;
}

// A tile's rows as loaded: gid (-1 past R), value, validity.
struct Rows {
  int g[TU];
  long long v[TU];
  bool ok[TU];
};

__device__ __forceinline__ void load_rows(const HllArgs& a, long long r,
                                          Rows& t) {
#pragma unroll
  for (int u = 0; u < TU; ++u) {
    const long long ru = r + 32 * u;
    const bool in = ru < a.R;
    t.g[u] = in ? a.gid[ru] : -1;
    t.v[u] = in ? a.vals[ru] : 0;
    t.ok[u] = in ? a.valid[ru] != 0 : false;
  }
}

// Sends rank `rank` (past TH_MAX) of register `idx` of plane p to its
// rank word, unless this CTA's table says it did so before.
__device__ __forceinline__ void send_high(const HllArgs& a, unsigned* seen,
                                          int p, int idx, unsigned rank) {
  const unsigned key = (((unsigned)p << HLL_P | (unsigned)idx) << 6) | rank;
  unsigned* s = seen + ((key * 2654435761u) >> 24) % SEEN;
  if (*(volatile unsigned*)s == key) return;
  atomicMax(a.scratch + (size_t)p * HLL_M + idx, rank);
  *(volatile unsigned*)s = key;
}

// The plane of output slot s (the dead slot slots-1 is plane Sc-1), or -1
// for a slot no row reaches.
__device__ __forceinline__ int plane_of(const HllArgs& a, int s) {
  return s == a.slots - 1 ? a.Sc - 1 : (s < a.Sc - 1 ? s : -1);
}

template <bool SHARED>
__global__ void __launch_bounds__(TT, 1) hll_tiles(const HllArgs a) {
  // the shared form's planes [Sc][PLANE_WORDS], or the global form's
  // cache of ORed words [CACHE] (word, bits); phase 2's partial ORs after
  extern __shared__ __align__(16) unsigned int s_dyn[];
  __shared__ unsigned s_seen[SEEN];
  cg::grid_group grid = cg::this_grid();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = a.Sc * PLANE_WORDS;          // thermometer words
  const long long gthreads = (long long)gridDim.x * TT;
  const long long gt = (long long)blockIdx.x * TT + threadIdx.x;
  unsigned int* high = a.scratch;             // [Sc * HLL_M] rank words
  unsigned int* therm = a.scratch + (size_t)a.Sc * HLL_M;
  unsigned int* planes = SHARED ? s_dyn : therm;
  uint2* cache = reinterpret_cast<uint2*>(s_dyn);

  // phase 0: zero the rank words, the planes; empty the tables
  uint4* h4 = reinterpret_cast<uint4*>(high);
  for (long long i = gt; i < (long long)nw; i += gthreads)
    h4[i] = make_uint4(0u, 0u, 0u, 0u);     // Sc * HLL_M words, 4 a store
  uint4* p4 = reinterpret_cast<uint4*>(planes);
  if (SHARED) {
    for (int i = threadIdx.x; i < nw / 4; i += TT)
      p4[i] = make_uint4(0u, 0u, 0u, 0u);
  } else {
    for (long long i = gt; i < nw / 4; i += gthreads)
      p4[i] = make_uint4(0u, 0u, 0u, 0u);
    for (int i = threadIdx.x; i < CACHE; i += TT)
      cache[i] = make_uint2(~0u, 0u);
  }
  for (int i = threadIdx.x; i < SEEN; i += TT) s_seen[i] = ~0u;
  grid.sync();

  // phase 1: the rows
  const long long step = gthreads * TU;
  long long r0 = ((long long)blockIdx.x * (TT / 32) + warp) * (32 * TU);
  Rows cur;
  load_rows(a, r0 + lane, cur);
  for (; r0 < a.R; r0 += step) {
    Rows nxt;
    load_rows(a, r0 + step + lane, nxt);  // in flight while these hash
    int idx[TU];
    unsigned rank[TU], wi[TU], old[TU];
#pragma unroll
    for (int u = 0; u < TU; ++u) {
      unsigned long long h;
      if (a.hashes) {
        const long long miss = a.nd - 1;
        long long id = cur.ok[u] ? cur.v[u] : miss;
        id = id < 0 ? 0 : (id > miss ? miss : id);
        h = (unsigned long long)__ldg(a.hashes + id);
      } else {
        h = hash_int(cur.ok[u] ? cur.v[u] : -1ll);
      }
      const unsigned long long rest = h << HLL_P;
      idx[u] = (int)(h >> (64 - HLL_P));
      rank[u] = rest ? __clzll((long long)rest) + 1 : 64 - HLL_P + 1;
      const int p = cur.g[u] < 0 ? 0 : cur.g[u];
      wi[u] = (unsigned)(p * PLANE_WORDS + (idx[u] >> 2));
      if (SHARED) {
        old[u] = *(volatile unsigned int*)(planes + wi[u]);
      } else {
        const uint2 e = cache[(wi[u] * 2654435761u) >> 20];
        old[u] = e.x == wi[u] ? e.y : 0u;
      }
    }
#pragma unroll
    for (int u = 0; u < TU; ++u) {
      if (cur.g[u] < 0) continue;
      const unsigned th =
          (rank[u] >= TH_MAX ? 0xffu : (1u << rank[u]) - 1u) <<
          ((idx[u] & 3) * 8);
      if ((old[u] & th) != th) {
        atomicOr(planes + wi[u], th);
        if (!SHARED)
          cache[(wi[u] * 2654435761u) >> 20] = make_uint2(wi[u], old[u] | th);
      }
      if (rank[u] > TH_MAX) send_high(a, s_seen, cur.g[u], idx[u], rank[u]);
    }
    cur = nxt;
  }
  unsigned int* parts = therm;
  if (SHARED) {
    // the CTA's planes to its part of the scratch
    __syncthreads();
    uint4* mine = reinterpret_cast<uint4*>(parts) +
                  (size_t)blockIdx.x * (nw / 4);
    for (int i = threadIdx.x; i < nw / 4; i += TT) mine[i] = p4[i];
  }
  grid.sync();

  // phase 2: the slots no row reaches zeroed; CTA b takes the 16-byte
  // columns [c0, c1) of the planes, in groups of m columns, G threads a
  // column splitting the parts
  constexpr int PC = PLANE_WORDS / 4;           // columns a plane
  uint4* out = reinterpret_cast<uint4*>(a.regs);
  for (long long i = gt; i < (long long)a.slots * PC; i += gthreads)
    if (plane_of(a, (int)(i / PC)) < 0) out[i] = make_uint4(0u, 0u, 0u, 0u);
  const int ncol = a.Sc * PC;
  const int per = (ncol + gridDim.x - 1) / gridDim.x;
  const int c0 = blockIdx.x * per;
  const int c1 = min(ncol, c0 + per);
  const uint4* src = reinterpret_cast<const uint4*>(parts);
  uint4* part = reinterpret_cast<uint4*>(s_dyn);  // [G][m], free again
  const int nparts = SHARED ? gridDim.x : 1;
  const int t = threadIdx.x;
  for (int cb = c0; cb < c1; cb += TT) {
    const int m = min(TT, c1 - cb);
    const int G = min(TT / m, nparts);
    __syncthreads();                              // part is free
    if (t < G * m) {
      const int c = cb + t % m;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 4
      for (int s = t / m; s < nparts; s += G) {
        const uint4 y = __ldcg(src + (size_t)s * ncol + c);
        x.x |= y.x;
        x.y |= y.y;
        x.z |= y.z;
        x.w |= y.w;
      }
      part[t] = x;
    }
    __syncthreads();
    if (t < m) {
      uint4 x = part[t];
      for (int s = 1; s < G; ++s) {
        const uint4 y = part[s * m + t];
        x.x |= y.x;
        x.y |= y.y;
        x.z |= y.z;
        x.w |= y.w;
      }
      const int c = cb + t;
      const int p = c / PC;
      // the column's 16 registers' rank words, four to an output word
      const uint4* hw = reinterpret_cast<const uint4*>(high) + (size_t)c * 4;
      unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint4 r = __ldcg(hw + k);
        w[k] = __vmaxu4(byte_popc(w[k]),
                        r.x | (r.y << 8) | (r.z << 16) | (r.w << 24));
      }
      out[slot_of(a, p) * PC + (c - p * PC)] = make_uint4(w[0], w[1], w[2],
                                                          w[3]);
    }
  }
  if (a.paths && t == 0) atomicAdd(a.paths + (SHARED ? 0 : 1), 1ull);
}

}  // namespace

// One cooperative launch on `stream` of `grid` CTAs of TT threads (at most
// the CTAs that can be resident at once): the shared form (shared != 0:
// Sc planes in each CTA's shared memory, Sc * 16 KB of it; a scratch of
// Sc * 64 KB of rank words and grid * Sc * 16 KB of planes) or the global
// form (a scratch of Sc * 64 KB and Sc * 16 KB).  No memset: the kernel
// writes every output register.  Takes fewer than 2^31 rows.  Returns
// cudaError_t.
extern "C" int hll_registers(const HllArgs* args, int shared, int grid,
                             void* stream) {
  const HllArgs& a = *args;
  if (a.slots < 1 || a.Sc < 1 || a.Sc > a.slots || a.slots > 512 ||
      a.R >= (1ll << 31) || (a.hashes != nullptr && a.nd < 1) ||
      grid < 1 || !a.scratch)
    return cudaErrorInvalidValue;
  // the cache, and phase 2's partial ORs (16 KB), in the global form
  const size_t shm = shared ? (size_t)a.Sc * HLL_M : CACHE * sizeof(uint2);
  void* kernel = shared ? (void*)hll_tiles<true> : (void*)hll_tiles<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
  if (err != cudaSuccess) return err;
  HllArgs copy = a;
  void* params[] = {&copy};
  return cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(TT), params,
                                     shm, static_cast<cudaStream_t>(stream));
}
