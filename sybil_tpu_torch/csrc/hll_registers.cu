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
// Bound: memory.  Per row: 4 B of gid, the 9 B of the distinct column
// (plus an 8 B hash gather for a str column), and one register read; the
// planes (at most 128 slots x 16 KB = 2 MB, since the bind caps the dense
// slots of the device HLL at 128) stay in L2.  CUDA has no byte atomicMax:
// a thread reads the 32-bit word that holds its register and returns when
// its rank does not exceed the register, which after the first rows of a
// slot is almost always (a rank r has probability 2^-r); otherwise it
// raises the byte with an atomicCAS loop on the word.  Exact and order
// free: the registers only grow.  One grid-stride pass.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int HLL_P = 14;
constexpr long long HLL_M = 1ll << HLL_P;

}  // namespace

// Mirrored field for field by HllArgs in ops/scan.py (ctypes).
struct HllArgs {
  const int* gid;               // [R] K2's reduce-space gid (dead = Sc-1)
  const long long* vals;        // [R] the distinct column
  const unsigned char* valid;   // [R]
  const long long* hashes;      // [nd] per-dict-id hashes, or null (int)
  unsigned int* regs;           // [slots * HLL_M / 4]: 4 registers a word
  long long R;
  long long nd;                 // hash entries, the missing one included
  int Sc;
  int slots;
};

namespace {

// FNV-1a 64 over the 8 little-endian bytes of v, then splitmix64's
// finaliser (sybil_tpu/query/hll.py hash64 on the int fast path's bytes).
__device__ __forceinline__ unsigned long long hash_int(long long v) {
  const unsigned long long u = (unsigned long long)v;
  unsigned long long h = 0xcbf29ce484222325ull;
#pragma unroll
  for (int i = 0; i < 8; ++i) h = (h ^ ((u >> (8 * i)) & 0xffull)) *
                                  0x100000001b3ull;
  h += 0x9E3779B97F4A7C15ull;
  h = (h ^ (h >> 30)) * 0xBF58476D1CE4E5B9ull;
  h = (h ^ (h >> 27)) * 0x94D049BB133111EBull;
  return h ^ (h >> 31);
}

__global__ void __launch_bounds__(THREADS) hll_kernel(const HllArgs a) {
  for (long long r = (long long)blockIdx.x * THREADS + threadIdx.x; r < a.R;
       r += (long long)gridDim.x * THREADS) {
    const int g = a.gid[r];
    const long long slot = g == a.Sc - 1 ? a.slots - 1 : g;
    unsigned long long h;
    if (a.hashes) {
      const long long miss = a.nd - 1;
      long long id = a.valid[r] ? a.vals[r] : miss;
      id = id < 0 ? 0 : (id > miss ? miss : id);
      h = (unsigned long long)a.hashes[id];
    } else {
      h = hash_int(a.valid[r] ? a.vals[r] : -1ll);
    }
    const long long idx = (long long)(h >> (64 - HLL_P));
    const unsigned long long rest = h << HLL_P;
    const unsigned rank = rest ? __clzll((long long)rest) + 1 : 64 - HLL_P + 1;
    const long long o = slot * HLL_M + idx;
    unsigned int* word = a.regs + (o >> 2);
    const int shift = (int)(o & 3) * 8;
    unsigned int old = *(volatile unsigned int*)word;
    while (((old >> shift) & 0xffu) < rank) {
      const unsigned int nw = (old & ~(0xffu << shift)) | (rank << shift);
      const unsigned int prev = atomicCAS(word, old, nw);
      if (prev == old) break;
      old = prev;
    }
  }
}

}  // namespace

// Zeroes the planes on `stream`, then one grid-stride pass.  Returns
// cudaError_t.
extern "C" int hll_registers(const HllArgs* args, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const HllArgs& a = *args;
  if (a.slots < 1 || a.Sc < 1 || a.Sc > a.slots ||
      (a.hashes != nullptr && a.nd < 1))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(a.regs, 0, (size_t)a.slots * HLL_M, s);
  if (err != cudaSuccess) return err;
  hll_kernel<<<grid, THREADS, 0, s>>>(a);
  return cudaGetLastError();
}
