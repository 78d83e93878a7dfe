// Go's truncating division and the time key, shared by the kernels that
// bucket a row's time: K2 (dense_scan.cu), K5 (outlier_compact.cu), K7
// (sorted_front.cu) and K8 (segment_reduce.cu).
#pragma once

// The reference's _trunc_div for d > 0, in the width of T: q = |x| // d
// (floor division; |x| wraps at T's minimum as jnp.abs does), then
// x >= 0 ? q : -q, wrapping.
template <typename T, typename U>
__device__ __forceinline__ T go_trunc_div(T x, T d) {
  const T ax = x < 0 ? static_cast<T>(U(0) - static_cast<U>(x)) : x;
  T q = ax / d;
  if (ax < 0 && q * d != ax) --q;  // floor for the one negative |x|
  return x >= 0 ? q : static_cast<T>(U(0) - static_cast<U>(q));
}

// The time key of time value t (the reference's _front_end 412-422):
// trunc_div(t, tb) * tb, in int32 arithmetic when the bind proved the
// column and the bucket fit it (time_i32), else in int64, wrapping.
__device__ __forceinline__ long long time_key(long long t, long long tb,
                                              int time_i32) {
  if (time_i32) {
    const int tb32 = static_cast<int>(tb);
    const int q = go_trunc_div<int, unsigned>(static_cast<int>(t), tb32);
    return static_cast<int>(static_cast<unsigned>(q) *
                            static_cast<unsigned>(tb32));
  }
  const long long q = go_trunc_div<long long, unsigned long long>(t, tb);
  return (long long)((unsigned long long)q * (unsigned long long)tb);
}
