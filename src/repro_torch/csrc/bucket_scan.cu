// Hand-written Hopper kernel: fused dense-bucket scan (paper C1).
//
// Replaces the TPU kernel src/repro/kernels/bucket_scan/bucket_scan.py:
// bucket_scan_kernel (entry bucket_scan_pallas). One pass over tent and
// explored yields the frontier flags of bucket i, their OR, and the
// next-bucket minimum over unsettled vertices:
//   frontier[v] = t < INF & t // delta == i & t < e
//   any         = OR of frontier
//   next        = min of t // delta over t < INF, t // delta > i, t < e,
//                 else IMAX
// (// floors, as the reference's; t = tent[v], e = explored[v]).
//
// What bounds it on the H100: bytes. It reads 8 bytes and writes 1 per
// vertex and does a handful of integer operations on them: at n = 1 M,
// 9 MB, 0.0027 ms at 3.35 TB/s. The design, point by point against what
// held the first version at a fifth of that bound:
// 1. No division per element. The launcher passes the bucket as the
//    half-open range [lo, hi) of values, computed on the host in Python
//    integers and clamped to [INT32_MIN, INF] (scan_range in
//    kernels/bucket_scan/bucket_scan.py), so any int32 i is taken,
//    negative and past-int32 ranges included. As e <= INF, t < e implies
//    t < INF, so the frontier is lo <= t < hi & t < e, and the next
//    bucket's candidates are t >= hi & t < e. Floor division is
//    monotone, so next = floor(min t / delta) over the candidates: the
//    one division of the call, made by the last block, flooring for
//    negative t as the reference does.
// 2. One device kernel per call. The launcher allocates the outputs with
//    torch.empty; nothing is filled before the launch and nothing is
//    computed after it. The two scalars are reduced across blocks inside
//    the kernel by a "last block done" reduction: thread 0 of every
//    block folds its block's OR and min into two accumulators of a
//    scratch buffer with one atomic each (the min as an order-reversing
//    unsigned key, so that a zeroed buffer holds both identities), and
//    takes a ticket with one more, acquire-release, atomic; the thread
//    that takes the last ticket reads the accumulators, writes any and
//    next, and zeroes the buffer for the next launch. The scratch is the one
//    state that lives across calls: the launcher keeps one buffer per
//    (device, stream), zeroed when it is made, so launches that share a
//    buffer are ordered by their stream and never overlap.
// 3. Vector accesses. Where tent and explored are 16-byte aligned and
//    frontier 4-byte aligned, each thread loads 4 elements of each with
//    one 16-byte load and stores their 4 flags as one 4-byte word; the
//    n % 4 tail and unaligned views take the scalar path (4-byte loads,
//    1-byte stores). The launcher chooses (scan_vector_path).
// 4. Few blocks, loads first. Blocks of 256 threads, at most 4 per SM
//    (528 in all), each thread issuing the loads of 2 vectors before it
//    uses them. At n = 1 M the pass is as short as the launch and the
//    final reduction around it; in a trial of variants on the H100
//    (threads per block, blocks per SM, vectors per thread, per-block
//    partials against atomics) no other choice was faster at 1 M or 9 M.
#include <cuda/atomic>

#include "common.cuh"

#define BS_THREADS 256
#define BS_UNROLL 2                 // 16-byte vectors per thread at a time
#define BS_MAX_BLOCKS (132 * 4)
// scratch ints: the ticket, the OR accumulator, the min accumulator
#define BS_SCRATCH_INTS 3

// m as an order-reversing unsigned key whose identity (m = INF) is 0, so
// a zeroed accumulator holds the identity and atomicMax takes the min
__device__ __forceinline__ unsigned bs_key(int m) {
  return ~((unsigned)m ^ 0x80000000u);
}

__device__ __forceinline__ int bs_unkey(unsigned key) {
  return (int)(~key ^ 0x80000000u);
}

template <bool VEC>
__global__ void __launch_bounds__(BS_THREADS)
    bucket_scan_kernel(const int *__restrict__ tent,
                       const int *__restrict__ explored, long long n, int lo,
                       int hi, int delta, uint8_t *__restrict__ frontier,
                       uint8_t *__restrict__ any_out,
                       int *__restrict__ next_out, int *scratch) {
  int any = 0;
  int m = RT_INF32;  // min candidate t; INF: none (a candidate is < INF)
  const long long gtid = (long long)blockIdx.x * BS_THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * BS_THREADS;
  long long scalar_from = 0;
  if (VEC) {
    const long long nv = n >> 2;
    const int4 *t4 = reinterpret_cast<const int4 *>(tent);
    const int4 *e4 = reinterpret_cast<const int4 *>(explored);
    unsigned *f4 = reinterpret_cast<unsigned *>(frontier);
    for (long long v0 = gtid; v0 < nv; v0 += stride * BS_UNROLL) {
      int4 t[BS_UNROLL], e[BS_UNROLL];
#pragma unroll
      for (int u = 0; u < BS_UNROLL; ++u) {  // all loads first
        const long long v = v0 + u * stride;
        if (v < nv) {
          t[u] = t4[v];
          e[u] = e4[v];
        }
      }
#pragma unroll
      for (int u = 0; u < BS_UNROLL; ++u) {
        const long long v = v0 + u * stride;
        if (v < nv) {
          unsigned f0, f1, f2, f3;
          rt_range_one(t[u].x, e[u].x, lo, hi, f0, m);
          rt_range_one(t[u].y, e[u].y, lo, hi, f1, m);
          rt_range_one(t[u].z, e[u].z, lo, hi, f2, m);
          rt_range_one(t[u].w, e[u].w, lo, hi, f3, m);
          const unsigned word = f0 | (f1 << 8) | (f2 << 16) | (f3 << 24);
          f4[v] = word;  // little-endian: element 4v + j in byte j
          any |= word != 0;
        }
      }
    }
    scalar_from = nv << 2;
  }
  for (long long v = scalar_from + gtid; v < n; v += stride) {
    unsigned f;
    rt_range_one(tent[v], explored[v], lo, hi, f, m);
    frontier[v] = (uint8_t)f;
    any |= (int)f;
  }

  // OR and MIN over the block, into thread 0
  __shared__ int s_any[BS_THREADS / 32];
  __shared__ int s_m[BS_THREADS / 32];
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  any = (int)__reduce_or_sync(RT_FULL, (unsigned)any);
  m = __reduce_min_sync(RT_FULL, m);
  if (lane == 0) {
    s_any[warp] = any;
    s_m[warp] = m;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < BS_THREADS / 32; ++w) {
    any |= s_any[w];
    m = min(m, s_m[w]);
  }

  // across blocks: accumulate, then take a ticket; the last block
  // finishes. Only thread 0 of each block is still running. The ticket's
  // acq_rel add releases this block's accumulator updates and, in the
  // last block, acquires every other block's (the adds form one release
  // sequence), so the relaxed loads below see them all.
  int *ticket = scratch;
  int *acc_any = scratch + 1;
  unsigned *acc_key = reinterpret_cast<unsigned *>(scratch + 2);
  if (any) atomicOr(acc_any, 1);
  if (m < RT_INF32) atomicMax(acc_key, bs_key(m));
  if (cuda::atomic_ref<int, cuda::thread_scope_device>(*ticket).fetch_add(
          1, cuda::memory_order_acq_rel) != (int)gridDim.x - 1)
    return;
  any = cuda::atomic_ref<int, cuda::thread_scope_device>(*acc_any).load(
      cuda::memory_order_relaxed);
  m = bs_unkey(cuda::atomic_ref<unsigned, cuda::thread_scope_device>(
                   *acc_key).load(cuda::memory_order_relaxed));
  int nb = RT_IMAX;
  if (m < RT_INF32) nb = rt_floor_div(m, delta);
  *any_out = (uint8_t)(any != 0);
  *next_out = nb;
  *acc_any = 0;  // ready for the next launch on this stream
  *acc_key = 0;
  *ticket = 0;
}

extern "C" int bucket_scan_scratch_ints() { return BS_SCRATCH_INTS; }

// lo, hi: the bucket's value range clamped to [INT32_MIN, INF]; delta >=
// 1; scratch: BS_SCRATCH_INTS zeroed ints, used by no launch that may
// run at the same time.
extern "C" int bucket_scan_launch(const void *tent, const void *explored,
                                  long long n, int lo, int hi, int delta,
                                  int vec, void *frontier, void *any_out,
                                  void *next_out, void *scratch,
                                  void *stream) {
  const long long work = vec ? (n >> 2) : n;
  const unsigned blocks = rt_blocks(work, BS_THREADS, BS_MAX_BLOCKS);
  if (vec)
    bucket_scan_kernel<true><<<blocks, BS_THREADS, 0, (cudaStream_t)stream>>>(
        (const int *)tent, (const int *)explored, n, lo, hi, delta,
        (uint8_t *)frontier, (uint8_t *)any_out, (int *)next_out,
        (int *)scratch);
  else
    bucket_scan_kernel<false><<<blocks, BS_THREADS, 0,
                                (cudaStream_t)stream>>>(
        (const int *)tent, (const int *)explored, n, lo, hi, delta,
        (uint8_t *)frontier, (uint8_t *)any_out, (int *)next_out,
        (int *)scratch);
  return (int)cudaGetLastError();
}
