// The dense strategy's slot -> key decode: the keys of K15's payload rows
// from a dense shard's table.
//
// Replaces sybil_tpu/ops/scan.py:_dense_decode_keys (608-626): the slot
// index is a mixed-radix number over the key bounds (min, card), the last
// key least significant; digit 0 is MISSING (-1) and digit d the value
// d - 1 + min, except the time key (at tpos), whose value is
// (d - 1 + min) * tb.  A scan without keys has one key, 0.
#pragma once

#include "desc.cuh"

__device__ __forceinline__ long long dense_key(const Desc& desc,
                                               const long long* kb_min,
                                               const long long* kb_card,
                                               int nkb, int tpos,
                                               long long tb, long long slot,
                                               int k) {
  long long sid = slot, val = 0;
  for (int i = nkb - 1; i >= k; --i) {
    const long long mn = desc_at(desc, kb_min, i);
    const long long card = desc_at(desc, kb_card, i);
    const long long digit = sid % (card + 1);
    sid /= card + 1;
    if (i == k)
      val = i == tpos ? (digit - 1 + mn) * tb
                      : (digit == 0 ? -1ll : digit - 1 + mn);
  }
  return val;
}
