// Hand-written Hopper kernel: masked 8-neighbour min-plus stencil of the
// game-map Δ-stepping sweep (paper §4, "Game Maps").
//
// Replaces the TPU kernel src/repro/kernels/grid_relax/grid_relax.py:
// grid_relax_kernel (entry grid_relax_pallas):
//   out[r,c] = free[r,c] ? min(tent[r,c], best[r,c]) : INF
//   best     = min over the phase's moves (dr, dc, cost) of
//              frontier(v) ? v + cost : INF,   v = tent[r+dr, c+dc]
//   frontier(v) = v < INF && floor(v / delta) == i
// with INF for every neighbour past the grid edge (no wrap-around
// between rows). The phase's move classes arrive as two flags computed
// on the host: a class is on iff (cost <= delta) == light.
//
// Bound on the H100: bytes. Per cell it reads 4 bytes of tent and 1 of
// free and writes 4, against a few dozen integer operations. Design:
// one block of 32 x 8 threads per 32 x 32 output tile (four rows per
// thread). The block stages the tile's (32 + 2)^2 halo of tent in
// shared memory once, already mapped to frontier(v) ? v : INF, so each
// of the <= 8 moves is one shared-memory read, one add and one min.
// Neighbouring threads take neighbouring columns, so global loads and
// stores are coalesced. The TPU kernel reads five full-width strips
// per row block; a 2-D tile reads each halo cell ~1.13 times instead.
//
// Every neighbour comes from the input tent (out of place), so the
// sweep is Jacobi like the reference's and the solve's counters match.
// v + cost wraps like int32 on the TPU (unsigned add); the division is
// floored, so a negative tent (a wrapped earlier sum) divides as in
// the reference.
#include "common.cuh"

#define GR_TC 32  // tile columns = blockDim.x
#define GR_TR 32  // tile rows
#define GR_BY 8   // blockDim.y; GR_TR / GR_BY rows per thread
#define GR_HC (GR_TC + 2)
#define GR_HR (GR_TR + 2)

__device__ __forceinline__ int gr_floordiv(int v, int d) {
  return v >= 0 ? v / d : -(-(v + 1) / d) - 1;
}

__device__ __forceinline__ int gr_cand(int fv, int cost) {
  return fv < RT_INF32 ? (int)((unsigned)fv + (unsigned)cost) : RT_INF32;
}

__global__ void __launch_bounds__(GR_TC *GR_BY)
    grid_relax_kernel(const int *__restrict__ tent,
                      const uint8_t *__restrict__ free_mask, int H, int W,
                      int tiles_x, int i, int delta, int cs, int cd,
                      int straight_on, int diag_on, int *__restrict__ out) {
  __shared__ int s[GR_HR][GR_HC];
  const int b = (int)blockIdx.x;
  const int tr = b / tiles_x;
  const int tc = b - tr * tiles_x;
  const int r0 = tr * GR_TR, c0 = tc * GR_TC;
  const int tid = threadIdx.y * GR_TC + threadIdx.x;

  for (int k = tid; k < GR_HR * GR_HC; k += GR_TC * GR_BY) {
    const int lr = k / GR_HC, lc = k - lr * GR_HC;
    const int gr = r0 + lr - 1, gc = c0 + lc - 1;
    int v = RT_INF32;
    if (gr >= 0 && gr < H && gc >= 0 && gc < W)
      v = tent[(long long)gr * W + gc];
    s[lr][lc] =
        (v < RT_INF32 && gr_floordiv(v, delta) == i) ? v : RT_INF32;
  }
  __syncthreads();

  const int c = c0 + threadIdx.x;
  if (c >= W) return;
  const int lc = threadIdx.x + 1;
  for (int rr = threadIdx.y; rr < GR_TR; rr += GR_BY) {
    const int r = r0 + rr;
    if (r >= H) break;
    const int lr = rr + 1;
    int best = RT_INF32;
    if (straight_on) {
      best = min(best, gr_cand(s[lr - 1][lc], cs));
      best = min(best, gr_cand(s[lr + 1][lc], cs));
      best = min(best, gr_cand(s[lr][lc - 1], cs));
      best = min(best, gr_cand(s[lr][lc + 1], cs));
    }
    if (diag_on) {
      best = min(best, gr_cand(s[lr - 1][lc - 1], cd));
      best = min(best, gr_cand(s[lr - 1][lc + 1], cd));
      best = min(best, gr_cand(s[lr + 1][lc - 1], cd));
      best = min(best, gr_cand(s[lr + 1][lc + 1], cd));
    }
    const long long idx = (long long)r * W + c;
    out[idx] = free_mask[idx] ? min(tent[idx], best) : RT_INF32;
  }
}

// tent int32[H, W], free_mask uint8[H, W] (0 = blocked), out int32[H, W];
// H, W >= 1.
extern "C" int grid_relax_launch(const void *tent, const void *free_mask,
                                 int H, int W, int i, int delta, int cs,
                                 int cd, int straight_on, int diag_on,
                                 void *out, void *stream) {
  const int tiles_x = (W + GR_TC - 1) / GR_TC;
  const long long tiles =
      (long long)tiles_x * ((H + GR_TR - 1) / GR_TR);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  grid_relax_kernel<<<(unsigned)tiles, dim3(GR_TC, GR_BY), 0,
                      (cudaStream_t)stream>>>(
      (const int *)tent, (const uint8_t *)free_mask, H, W, tiles_x, i, delta,
      cs, cd, straight_on, diag_on, (int *)out);
  return (int)cudaGetLastError();
}
