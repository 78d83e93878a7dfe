// One filter of the front end, shared by K2 (dense_scan.cu) and K7
// (sorted_front.cu): Args is the kernel's argument struct, whose f_op,
// f_vals, f_valid, f_bits and f_bits_len point into its descriptor block
// (desc.cuh).  Op codes: 0 gt, 1 lt, 2 eq, 3 neq, 4 re, 5 nre, 6 never,
// 7 set in, 8 set nin.  A set filter has no validity lane: its f_valid
// and f_vals words hold K14's `has` and `hit` row bitmasks, so the op is
// read before any validity read.
#pragma once

#include "desc.cuh"

template <bool HEAD, class Args>
__device__ __forceinline__ bool passes(const Args& a, int i, long long r,
                                       long long fv) {
  const long long op = desc_at<HEAD>(a.desc, a.f_op, i);
  if (op >= 7) {  // a set filter: K14's bitmasks, no validity lane
    const unsigned bit = 1u << (r & 31);
    const unsigned* has =
        reinterpret_cast<const unsigned*>(desc_at<HEAD>(a.desc, a.f_valid, i));
    if (!(has[r >> 5] & bit)) return false;
    const unsigned* hit =
        reinterpret_cast<const unsigned*>(desc_at<HEAD>(a.desc, a.f_vals, i));
    const bool h = (hit[r >> 5] & bit) != 0u;
    return op == 7 ? h : !h;
  }
  if (!desc_at<HEAD>(a.desc, a.f_valid, i)[r]) return false;
  const long long v = desc_at<HEAD>(a.desc, a.f_vals, i)[r];
  switch (op) {
    case 0: return v > fv;
    case 1: return v < fv;
    case 2: return v == fv;
    case 3: return v != fv;
    case 4:
    case 5: {
      const long long n = desc_at<HEAD>(a.desc, a.f_bits_len, i);
      const long long j = v < 0 ? 0 : (v > n - 1 ? n - 1 : v);
      const bool hit = desc_at<HEAD>(a.desc, a.f_bits, i)[j] != 0;
      return op == 4 ? hit : !hit;
    }
    default: return false;
  }
}
