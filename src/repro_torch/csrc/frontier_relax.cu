// Hand-written Hopper kernels: fused frontier scan + ordered compaction
// + ELL row gather of one bucket.
//
// Replaces the TPU kernel
// src/repro/kernels/frontier_relax/frontier_relax.py: frontier_relax_kernel
// (entry frontier_relax_pallas). That kernel is one grid step with a
// scalar loop over every flag and every slot, leaning on VMEM residency
// of the whole tent slice and ELL block. Hopper has neither a
// sequential grid nor a VMEM that holds a million-vertex slice, so the
// same function is four short launches on one stream:
//
//   A  fr_flags:   frontier flags of bucket i (the bucket_scan formulas),
//                  one population count per 1024-vertex tile, and the
//                  any / next-bucket scalars by block reduction + atomics;
//   B1 fr_scan:    one block scans the tile counts into tile offsets and
//                  writes the untruncated population `count`;
//   B2 fr_scatter: each tile ranks its flags (warp ballot + block scan of
//                  warp counts) and writes ascending vertex ids into the
//                  slots below cap — the order of jnp.nonzero(size=cap);
//   C  fr_gather:  every slot j < cap reads row lidx[j] of nbr / w_ell,
//                  or the all-sentinel row S where j >= min(count, cap),
//                  and writes fidx = lidx + base (sentinel `sent`).
//
// Bound on the H100: bytes. Phase A/B read dist and explored (twice: the
// flags are recomputed in B2 instead of stored), phase C writes
// 2 * cap * D ints of gathered rows and reads the frontier's rows. The
// design keeps every pass coalesced and skips, in B2, tiles that hold no
// flag or start past cap; the population never leaves the device, so no
// host synchronisation happens inside the step.
#include "common.cuh"

#define FR_TILE 1024  // vertices per block in A / B2; blockDim.x == FR_TILE

__global__ void fr_flags_kernel(const int *__restrict__ dist,
                                const int *__restrict__ explored, int S, int i,
                                int delta, int *__restrict__ tile_counts,
                                int *any_out, int *next_out) {
  const int v = blockIdx.x * FR_TILE + threadIdx.x;
  bool f = false;
  int nb = RT_IMAX;
  if (v < S) rt_scan_formulas(dist[v], explored[v], i, delta, f, nb);
  const int c = __syncthreads_count(f);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = c;
  rt_block_or_min(f, nb, any_out, next_out);
}

__global__ void fr_scan_kernel(const int *__restrict__ tile_counts,
                               int n_tiles, int *__restrict__ tile_offsets,
                               int *count_out) {
  __shared__ int s_warp[32];
  int carry = 0;  // every thread keeps the same running total
  for (int base = 0; base < n_tiles; base += blockDim.x) {
    const int t = base + threadIdx.x;
    const int c = t < n_tiles ? tile_counts[t] : 0;
    int total;
    const int excl = rt_block_exclusive_scan(c, s_warp, &total);
    if (t < n_tiles) tile_offsets[t] = carry + excl;
    carry += total;
  }
  if (threadIdx.x == 0) *count_out = carry;
}

__global__ void fr_scatter_kernel(const int *__restrict__ dist,
                                  const int *__restrict__ explored, int S,
                                  int i, int delta,
                                  const int *__restrict__ tile_counts,
                                  const int *__restrict__ tile_offsets,
                                  int cap, int *__restrict__ lidx) {
  __shared__ int s_warp[32];
  const int off = tile_offsets[blockIdx.x];
  if (tile_counts[blockIdx.x] == 0 || off >= cap) return;  // whole block
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int v = blockIdx.x * FR_TILE + threadIdx.x;
  bool f = false;
  int nb;
  if (v < S) rt_scan_formulas(dist[v], explored[v], i, delta, f, nb);
  const unsigned m = __ballot_sync(RT_FULL, f);
  if (lane == 0) s_warp[warp] = __popc(m);
  __syncthreads();
  if (warp == 0) {
    const int c = lane < nw ? s_warp[lane] : 0;
    s_warp[lane] = rt_warp_inclusive_scan(c) - c;
  }
  __syncthreads();
  if (f) {
    const int pos = off + s_warp[warp] + __popc(m & ((1u << lane) - 1u));
    if (pos < cap) lidx[pos] = v;
  }
}

__global__ void fr_gather_kernel(const int *__restrict__ lidx,
                                 const int *__restrict__ count, int cap,
                                 int D, int S, int base, int sent,
                                 const int *__restrict__ nbr,
                                 const int *__restrict__ w_ell,
                                 int *__restrict__ fidx,
                                 int *__restrict__ rows_n,
                                 int *__restrict__ rows_w) {
  const int filled = min(*count, cap);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long j = first; j < cap; j += stride) {
    const int l = j < filled ? lidx[j] : S;
    fidx[j] = l < S ? l + base : sent;
  }
  const long long total = (long long)cap * D;
  for (long long idx = first; idx < total; idx += stride) {
    const long long j = idx / D;
    const int k = (int)(idx - j * D);
    const int l = j < filled ? lidx[j] : S;
    const long long src = (long long)l * D + k;
    rows_n[idx] = nbr[src];
    rows_w[idx] = w_ell[src];
  }
}

// tile_counts / tile_offsets hold n_tiles = max(1, ceil(S / 1024)) ints;
// lidx holds cap ints; any_out must hold 0 and next_out IMAX before the
// launch. count_out receives the untruncated population.
extern "C" int frontier_relax_launch(
    const void *dist, const void *explored, int S, int i, int delta,
    const void *nbr, const void *w_ell, int D, int cap, int base, int sent,
    void *tile_counts, void *tile_offsets, int n_tiles, void *lidx,
    void *fidx, void *rows_n, void *rows_w, void *count_out, void *any_out,
    void *next_out, void *stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int err;
  fr_flags_kernel<<<n_tiles, FR_TILE, 0, st>>>(
      (const int *)dist, (const int *)explored, S, i, delta,
      (int *)tile_counts, (int *)any_out, (int *)next_out);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  fr_scan_kernel<<<1, 1024, 0, st>>>((const int *)tile_counts, n_tiles,
                                     (int *)tile_offsets, (int *)count_out);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  fr_scatter_kernel<<<n_tiles, FR_TILE, 0, st>>>(
      (const int *)dist, (const int *)explored, S, i, delta,
      (const int *)tile_counts, (const int *)tile_offsets, cap, (int *)lidx);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  const int threads = 256;
  const long long work = (long long)cap * (D > 1 ? D : 1);
  fr_gather_kernel<<<rt_blocks(work, threads, 132 * 16), threads, 0, st>>>(
      (const int *)lidx, (const int *)count_out, cap, D, S, base, sent,
      (const int *)nbr, (const int *)w_ell, (int *)fidx, (int *)rows_n,
      (int *)rows_w);
  return (int)cudaGetLastError();
}
