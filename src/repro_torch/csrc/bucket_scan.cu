// Hand-written Hopper kernel: fused dense-bucket scan (paper C1).
//
// Replaces the TPU kernel src/repro/kernels/bucket_scan/bucket_scan.py:
// bucket_scan_kernel (entry bucket_scan_pallas). One pass over tent and
// explored yields the frontier flags of bucket i, their OR, and the
// next-bucket minimum over unsettled vertices.
//
// Bound on the H100: bytes. It reads 8 bytes and writes 1 byte per
// vertex and does a handful of integer operations on them, far below
// the card's operations-per-byte balance. Design: one thread per vertex
// in a grid-stride loop (coalesced 4-byte loads, 1-byte stores), the
// two scalars reduced in registers, then across the block with warp
// reductions, then one atomicOr/atomicMin per block. The TPU kernel
// carries the scalars across its sequential grid; Hopper blocks run
// concurrently, and OR/MIN are order-free, so the bits are the same.
#include "common.cuh"

__global__ void bucket_scan_kernel(const int *__restrict__ tent,
                                   const int *__restrict__ explored,
                                   long long n, int i, int delta,
                                   uint8_t *__restrict__ frontier,
                                   int *any_out, int *next_out) {
  int any = 0;
  int nb = RT_IMAX;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < n;
       v += stride) {
    bool f;
    int b;
    rt_scan_formulas(tent[v], explored[v], i, delta, f, b);
    frontier[v] = f;
    any |= f;
    nb = min(nb, b);
  }
  rt_block_or_min(any, nb, any_out, next_out);
}

// any_out must hold 0 and next_out IMAX before the launch.
extern "C" int bucket_scan_launch(const void *tent, const void *explored,
                                  long long n, int i, int delta,
                                  void *frontier, void *any_out,
                                  void *next_out, void *stream) {
  const int threads = 256;
  bucket_scan_kernel<<<rt_blocks(n, threads, 132 * 16), threads, 0,
                       (cudaStream_t)stream>>>(
      (const int *)tent, (const int *)explored, n, i, delta,
      (uint8_t *)frontier, (int *)any_out, (int *)next_out);
  return (int)cudaGetLastError();
}
