// Hand-written Hopper kernel: relaxation candidates of compacted ELL rows.
//
// Replaces the TPU kernel src/repro/kernels/ell_relax/ell_relax.py:
// ell_relax_kernel (entries ell_relax_pallas, blocked, and
// ell_relax_row_gather_pallas, scalar-prefetch row DMA):
//   cand[j, k] = dist[fidx[j]] + w_ell[fidx[j], k]  where both are finite,
//   INF otherwise; fidx == n (padding) reads the all-INF row n.
//
// Bound on the H100: bytes. Per output element it reads one weight and
// writes one candidate (plus one distance and one index per row), with
// one add. Design: one thread per (j, k) in a grid-stride loop, so the
// threads of a warp read neighbouring weights of one row and write
// neighbouring candidates. On the TPU the blocked variant left the row
// gather to XLA; here the gather is the kernel's own work. The mask is
// applied before the add, and the add wraps like int32 on the TPU, so
// INF + w never appears.
#include "common.cuh"

__global__ void ell_relax_kernel(const int *__restrict__ fidx,
                                 const int *__restrict__ dist,
                                 const int *__restrict__ w_ell, int n,
                                 long long cap, int D,
                                 int *__restrict__ out) {
  const long long total = cap * D;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const long long j = idx / D;
    const int k = (int)(idx - j * D);
    const int f = fidx[j];
    const bool in = (unsigned)f < (unsigned)n;
    const int d = in ? dist[f] : RT_INF32;
    const int w = w_ell[(long long)(in ? f : n) * D + k];
    const bool valid = (w < RT_INF32) && (d < RT_INF32);
    out[idx] = valid ? (int)((unsigned)d + (unsigned)w) : RT_INF32;
  }
}

extern "C" int ell_relax_launch(const void *fidx, const void *dist,
                                const void *w_ell, int n, long long cap,
                                int D, void *out, void *stream) {
  const int threads = 256;
  ell_relax_kernel<<<rt_blocks(cap * D, threads, 132 * 16), threads, 0,
                     (cudaStream_t)stream>>>(
      (const int *)fidx, (const int *)dist, (const int *)w_ell, n, cap, D,
      (int *)out);
  return (int)cudaGetLastError();
}
