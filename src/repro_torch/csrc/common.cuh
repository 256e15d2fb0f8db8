// Shared device helpers of the port's hand-written Hopper kernels.
//
// The bucket formulas of paper C1 as a range of values (frontier
// membership and next-bucket candidate), and the warp- and block-wide
// scans the kernels are built from. Tent values are any int32, with
// INF32 = 2^31 - 1; the launchers pass bucket i as the half-open value
// range [lo, hi) clamped to [INT32_MIN, INF] (scan_range in
// kernels/bucket_scan/bucket_scan.py), so no element is divided: the one
// division of a call floors the minimum candidate (rt_floor_div).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define RT_INF32 0x7fffffff
#define RT_IMAX 0x7fffffff
#define RT_FULL 0xffffffffu

// f = t < e & lo <= t < hi (frontier of the bucket); m takes t where
// t < e & t >= hi (a candidate for the next bucket). As e <= INF, t < e
// implies t < INF.
__device__ __forceinline__ void rt_range_one(int t, int e, int lo, int hi,
                                             unsigned &f, int &m) {
  const bool unsettled = t < e;
  f = unsettled && t >= lo && t < hi;
  if (unsettled && t >= hi) m = min(m, t);
}

// floor(m / delta) for delta >= 1, negative m included (the reference's
// //); floor division is monotone, so this of the minimum candidate is
// the minimum of the candidates' buckets
__device__ __forceinline__ int rt_floor_div(int m, int delta) {
  int q = m / delta;
  if (q * delta != m && m < 0) --q;
  return q;
}

// Inclusive prefix sum over the 32 lanes of a warp.
__device__ __forceinline__ int rt_warp_inclusive_scan(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(RT_FULL, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Exclusive prefix sum over the block (thread order); *total receives
// the block sum. s_warp holds 32 ints of shared memory. Every thread
// must call it.
__device__ __forceinline__ int rt_block_exclusive_scan(int v, int *s_warp,
                                                       int *total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int x = rt_warp_inclusive_scan(v);
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int s = rt_warp_inclusive_scan(lane < nw ? s_warp[lane] : 0);
    s_warp[lane] = s;
  }
  __syncthreads();
  const int res = (warp > 0 ? s_warp[warp - 1] : 0) + x - v;
  *total = s_warp[nw - 1];
  __syncthreads();  // s_warp may be reused by the caller's next call
  return res;
}

static inline unsigned rt_blocks(long long work, int threads, int cap_blocks) {
  long long b = (work + threads - 1) / threads;
  if (b < 1) b = 1;
  if (b > cap_blocks) b = cap_blocks;
  return (unsigned)b;
}
