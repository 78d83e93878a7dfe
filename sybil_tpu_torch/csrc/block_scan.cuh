// Block-wide exclusive scan of one int per thread, shared by the kernels
// that rank rows or segments inside a CTA.  Warp scans by shuffles, then
// one warp scans the warp totals held in shared memory.
#pragma once

// Returns the thread's exclusive prefix and writes the block total to
// *total.  NT is the block's thread count (a multiple of 32, at most
// 1024); all NT threads must call it.
template <int NT>
__device__ int block_scan(int x, int* total) {
  __shared__ int s_warp[NT / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < NT / 32 ? s_warp[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < NT / 32) s_warp[lane] = w;  // inclusive warp totals
  }
  __syncthreads();
  const int before = warp ? s_warp[warp - 1] : 0;
  *total = s_warp[NT / 32 - 1];
  __syncthreads();
  return before + inc - x;
}
