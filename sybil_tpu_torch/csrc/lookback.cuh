// The pieces of a one-launch pass over tiles that each publish a word
// for the tiles after them (as in Merrill and Garland's decoupled
// look-back, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// 2016), shared by K10's pair sections (sorted_pack.cu), K5
// (outlier_compact.cu) and K9's hist_pairs (hist_pairs.cu): a byte mask
// read 16 bytes at a time, and the words' stores and loads.  A tile
// publishes its word with st.release; a reader takes a window of words
// with relaxed loads, all in flight at once (an acquire load waits for
// the one before it), and where it reads data published beside a word it
// fences after the window (fence_acquire).  Each kernel keeps its own
// word format.
#pragma once

#include <cstdint>

namespace lookback {

constexpr unsigned FULL = 0xffffffffu;
constexpr int VEC = 16;                       // mask bytes a vector load
constexpr int VECS = 4;                       // vectors a thread a tile
constexpr int ROWS_T = VEC * VECS;            // mask rows a thread

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

// After relaxed loads that saw released words: the data published before
// them is visible to this thread's loads that follow.
__device__ __forceinline__ void fence_acquire() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// The thread's ROWS_T mask rows [r0, r0 + ROWS_T) as bits, row r0 + i at
// bit i: four 16-byte loads, or byte loads where the mask is not 16-byte
// aligned or R leaves a tail.
__device__ __forceinline__ unsigned long long mask_bits(
    const unsigned char* mask, long long r0, long long R) {
  unsigned long long bits = 0ull;
  if (r0 >= R) return 0ull;
  if (r0 + ROWS_T <= R && ((uintptr_t)(mask + r0) & (VEC - 1)) == 0) {
    const uint4* p = reinterpret_cast<const uint4*>(mask + r0);
    uint4 q[VECS];
#pragma unroll
    for (int k = 0; k < VECS; ++k) q[k] = __ldcs(p + k);
#pragma unroll
    for (int k = 0; k < VECS; ++k) {
      const unsigned w[4] = {q[k].x, q[k].y, q[k].z, q[k].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // 0x80 in each byte that is not zero
        const unsigned nz = __vcmpne4(w[i], 0u) & 0x80808080u;
        // gather the four flags into bits 0..3
        const unsigned b = ((nz >> 7) & 1u) | ((nz >> 14) & 2u) |
                           ((nz >> 21) & 4u) | ((nz >> 28) & 8u);
        bits |= (unsigned long long)b << (16 * k + 4 * i);
      }
    }
    return bits;
  }
  const int n = (int)(R - r0 < ROWS_T ? R - r0 : ROWS_T);
  for (int i = 0; i < n; ++i)
    if (mask[r0 + i]) bits |= 1ull << i;
  return bits;
}

}  // namespace lookback
