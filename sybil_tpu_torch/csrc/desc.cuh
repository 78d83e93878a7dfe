// Descriptor blocks, shared by the kernels whose per-key, per-aggregation
// and per-filter words (column pointers, bounds, op codes) have no fixed
// count.  The wrapper packs a launch's words into one block of int64
// words; the argument struct holds a pointer per descriptor array, at its
// first word.  A block of at most DESC_HEAD words rides in the kernel
// parameters (`head`), as the fixed arrays of the structs did, and is
// read from the constant bank; the pointers then hold byte offsets into
// it and `dev` is null.  A longer block is copied whole to its device
// buffer `dev` on the launch's stream (desc_upload), and the pointers
// point there.
#pragma once

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

constexpr int DESC_HEAD = 256;  // words in the kernel parameters (2 KB)

// Mirrored by Desc in ops/scan.py (ctypes).
struct Desc {
  const long long* dev;   // the whole block on the device, or null
  const long long* host;  // the whole block in host memory
  long long n;            // words
  long long head[DESC_HEAD];  // the block's first words
};

// Copies a block longer than its head to the device on `s`.  The host
// words may be freed when this returns.
inline cudaError_t desc_upload(const Desc& d, cudaStream_t s) {
  if (d.n <= DESC_HEAD) return cudaSuccess;
  if (d.dev == nullptr) return cudaErrorInvalidValue;
  return cudaMemcpyAsync(const_cast<long long*>(d.dev), d.host,
                         (size_t)d.n * sizeof(long long),
                         cudaMemcpyHostToDevice, s);
}

// Entry i of the descriptor array `p` (a field of the struct).  A block
// that fits its head (HEAD) is read from the kernel parameters, where `p`
// holds the array's byte offset in the block; a longer one from its
// device copy, where `p` points.  Kernels that read the words on every
// row take HEAD as a template parameter, so each read is one load.
template <bool HEAD, class T>
__device__ __forceinline__ T desc_at(const Desc& d, const T* p, int i) {
  static_assert(sizeof(T) == sizeof(long long), "descriptor words are 8 B");
  if (!HEAD) return p[i];
  // a 32-bit index: a kernel hoists each array's offset out of its row
  // loop, one register each
  const long long v =
      d.head[(unsigned)((uintptr_t)p / sizeof(long long)) + (unsigned)i];
  T out;
  memcpy(&out, &v, sizeof(T));
  return out;
}

// The same, with the block's place chosen at run time.
template <class T>
__device__ __forceinline__ T desc_at(const Desc& d, const T* p, int i) {
  return d.dev ? desc_at<false>(d, p, i) : desc_at<true>(d, p, i);
}
