// Shared device helpers of the port's hand-written Hopper kernels.
//
// The bucket formulas of paper C1 (frontier membership and next-bucket
// candidate), and the block-wide reductions and scans the kernels are
// built from. Tent values are non-negative int32 with INF32 = 2^31 - 1;
// the division runs on finite values only.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define RT_INF32 0x7fffffff
#define RT_IMAX 0x7fffffff
#define RT_FULL 0xffffffffu

// frontier[v] = t < INF & t / delta == i & t < e
// next-bucket candidate = t / delta where that bucket is > i and t < e,
// else IMAX (the identity of the min)
__device__ __forceinline__ void rt_scan_formulas(int t, int e, int i,
                                                 int delta, bool &f,
                                                 int &nb) {
  const bool fin = t < RT_INF32;
  const int b = fin ? t / delta : RT_IMAX;
  const bool unsettled = t < e;
  f = fin && b == i && unsettled;
  nb = (fin && b > i && unsettled) ? b : RT_IMAX;
}

// OR and MIN over the block, then one atomic of each into the outputs.
// Both are order-free, so concurrent blocks give the same bits as the
// TPU's sequential grid. Call once per kernel, from every thread;
// blockDim.x must be a multiple of 32.
__device__ __forceinline__ void rt_block_or_min(int any, int nb, int *any_out,
                                                int *next_out) {
  __shared__ int s_any[32];
  __shared__ int s_nb[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  any = (int)__reduce_or_sync(RT_FULL, (unsigned)any);
  nb = __reduce_min_sync(RT_FULL, nb);
  if (lane == 0) {
    s_any[warp] = any;
    s_nb[warp] = nb;
  }
  __syncthreads();
  if (warp == 0) {
    any = lane < nw ? s_any[lane] : 0;
    nb = lane < nw ? s_nb[lane] : RT_IMAX;
    any = (int)__reduce_or_sync(RT_FULL, (unsigned)any);
    nb = __reduce_min_sync(RT_FULL, nb);
    if (lane == 0) {
      if (any) atomicOr(any_out, 1);
      if (nb < RT_IMAX) atomicMin(next_out, nb);
    }
  }
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
