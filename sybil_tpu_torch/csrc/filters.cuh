// The front end's row tests over a warp's tile, shared by K2
// (dense_scan.cu) and K7 (sorted_front.cu): the N rows r + 32u (u < N;
// N = 1 is one row), one bit a row, so a warp's loads of one column are
// coalesced.  Args is the kernel's argument struct, whose f_op, f_vals,
// f_valid, f_bits and f_bits_len point into its descriptor block
// (desc.cuh).  Op codes: 0 gt, 1 lt, 2 eq, 3 neq, 4 re, 5 nre, 6 never,
// 7 set in, 8 set nin.  A filter never passes on a missing value; re/nre
// read the regex bitset at clamp(v, 0, len-1); a set filter has no
// validity lane: its f_valid and f_vals words hold K14's `has` and `hit`
// row bitmasks (in: has & hit, nin: has & ~hit), so the op is read first;
// any other op never matches.
#pragma once

#include "desc.cuh"

constexpr int FV_SMEM = 16;  // filter constants staged in shared memory

// The tile's rows inside [0, R) (*inr) and, of those, the rows inside
// their block's record count (the result).
template <int N>
__device__ __forceinline__ unsigned tile_in_range(const int* nrec,
                                                  long long R, int log2C,
                                                  long long r,
                                                  unsigned* inr) {
  const long long cmask = (1ll << log2C) - 1;
  unsigned in = 0u, live = 0u;
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const long long ru = r + 32 * u;
    if (ru < R) {
      in |= 1u << u;
      live |= (unsigned)((ru & cmask) < nrec[ru >> log2C]) << u;
    }
  }
  *inr = in;
  return live;
}

// `live` less the rows that fail a filter, a filter at a time: each
// filter's N rows (of `inr`) are loaded together, before any is used.
// The first FV_SMEM filter constants come from shared memory (s_fv), the
// rest from a.filter_vals.
template <bool HEAD, int N, class Args>
__device__ __forceinline__ unsigned tile_filters(const Args& a, long long r,
                                                 unsigned inr, unsigned live,
                                                 const long long* s_fv) {
  for (int i = 0; i < a.nfilters; ++i) {
    const long long fv = i < FV_SMEM ? s_fv[i] : a.filter_vals[i];
    const long long op = desc_at<HEAD>(a.desc, a.f_op, i);
    unsigned pass = 0u;
    if (op >= 7) {  // a set filter: K14's bitmasks, no validity lane
      const unsigned* has = reinterpret_cast<const unsigned*>(
          desc_at<HEAD>(a.desc, a.f_valid, i));
      const unsigned* hit = reinterpret_cast<const unsigned*>(
          desc_at<HEAD>(a.desc, a.f_vals, i));
#pragma unroll
      for (int u = 0; u < N; ++u) {
        const long long ru = r + 32 * u;
        if (!((inr >> u) & 1u)) continue;
        const unsigned bit = 1u << (ru & 31);
        const bool h = (hit[ru >> 5] & bit) != 0u;
        pass |= (unsigned)((has[ru >> 5] & bit) && (op == 7 ? h : !h)) << u;
      }
    } else {
      const long long* vals = desc_at<HEAD>(a.desc, a.f_vals, i);
      const unsigned char* valid = desc_at<HEAD>(a.desc, a.f_valid, i);
      long long v[N];
      unsigned ok = 0u;
#pragma unroll
      for (int u = 0; u < N; ++u) {
        const long long ru = r + 32 * u;
        v[u] = 0;
        if ((inr >> u) & 1u) {
          ok |= (unsigned)(valid[ru] != 0) << u;
          v[u] = vals[ru];
        }
      }
      if (op == 4 || op == 5) {
        const unsigned char* bits = desc_at<HEAD>(a.desc, a.f_bits, i);
        const long long n = desc_at<HEAD>(a.desc, a.f_bits_len, i);
#pragma unroll
        for (int u = 0; u < N; ++u) {
          if (!((ok >> u) & 1u)) continue;
          const long long j = v[u] < 0 ? 0 : (v[u] > n - 1 ? n - 1 : v[u]);
          const bool h = bits[j] != 0;
          pass |= (unsigned)(op == 4 ? h : !h) << u;
        }
      } else {
#pragma unroll
        for (int u = 0; u < N; ++u) {
          const bool p = op == 0 ? v[u] > fv : op == 1 ? v[u] < fv
                       : op == 2 ? v[u] == fv : op == 3 ? v[u] != fv : false;
          pass |= (unsigned)p << u;
        }
      }
      pass &= ok;
    }
    live &= pass;
  }
  return live;
}
