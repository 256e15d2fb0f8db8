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
// What bounds it on the H100: bytes. Per cell it reads 4 bytes of tent
// and 1 of free and writes 4: at 3000 x 3000, 81 MB, 0.024 ms at
// 3.35 TB/s. It issues about 15 integer instructions per cell, about
// 5 us of the SMs' issue time at that size.
//
// The design, point by point against what held the first (shared-tile)
// version at half of that bound:
// 1. No division. The launcher passes the bucket as the half-open range
//    [lo, hi) = [min(i*delta, INF), min((i+1)*delta, INF)), computed
//    once on the host in Python integers (bucket_range in
//    kernels/grid_relax/grid_relax.py). frontier(v) is lo <= v < hi: two
//    compares, equal to the floored test for every int32 v (negative
//    and INF included) and every i >= 0, i*delta past int32 included.
// 2. Registers, not a shared-memory tile. A warp owns a strip of 128
//    columns, 4 consecutive cells per lane, and walks down GR_ROWS rows.
//    Each loaded row is turned once into its phase candidates
//    (frontier(v) ? v + cost : INF, per move class on) and three rows
//    r-1, r, r+1 stay in registers: vertical neighbours are registers,
//    the horizontal and diagonal neighbours of a lane's end cells come
//    from the next lane by one shuffle each way, and lanes 0 and 31 load
//    the strip's two outer columns. Each tent cell is read about once
//    (2 halo rows per GR_ROWS rows, 2 columns per 128); the centre's raw
//    value comes from the same registers; no shared memory, no barrier.
// 3. Loads in flight. Before row r is computed, the loads of row
//    r + 1 + GR_AHEAD are issued, so each warp keeps GR_AHEAD rows
//    (~0.65 KB each: 512 B of tent, 128 of free, 2 outer cells)
//    outstanding. At 3000 x 3000 the grid is 24 strips x 94 bands =
//    2256 warps of GR_ROWS = 32 rows, all resident at once (~17 per SM
//    at 58-70 registers a thread in the map's two phases), ~22 KB in
//    flight per SM against Little's ~15-20 KB (3.35 TB/s x ~0.6-0.8 us
//    over 132 SMs). 32 rows keep the halo re-read at 6 %; 4 warps per
//    block sit side by side on one row band, so neighbouring strips
//    share their halo sectors in L2. Measured on an H100 SXM (700 W) at
//    3000 x 3000, inside the solve: 1 row ahead 0.031 ms, 2-4 rows
//    0.0285-0.0287; bands of 16 rows 0.030, 24-32 rows 0.0284-0.0285,
//    48-64 rows 0.031-0.042 (too few warps); 2 or 8 warps per block as 4.
// 4. Any H x W. The vector path (one 16-byte int4 load of tent, one
//    4-byte word of free, one int4 store per lane and row) needs W % 4
//    == 0, tent and out 16-byte aligned and free 4-byte aligned; the
//    launcher takes the scalar path of the same template (4 masked
//    4-byte loads and stores per lane) for every other width or offset.
//
// Every neighbour comes from the input tent (out of place), so the sweep
// is Jacobi like the reference's and the solve's counters match.
// v + cost wraps like int32 on the TPU (unsigned add).
#include "common.cuh"

#define GR_ROWS 32   // output rows per warp
#define GR_AHEAD 2   // rows whose loads are in flight ahead of row r + 1
#define GR_WARPS 4   // warps per block, side by side on one row band
#define GR_STRIP 128 // columns per warp: 4 per lane

// One row as a lane loads it.
struct GrRaw {
  int v[4];     // tent of the lane's 4 cells (INF past an edge)
  int el, er;   // lane 0: the cell left of the strip; lane 31: right of it
  unsigned fw;  // the 4 cells' free bytes, cell j in byte j
};

// One row's phase candidates: [0] the cell left of the lane's first cell,
// [1..4] the lane's cells, [5] the cell right of its last.
struct GrCand {
  int s[6];  // straight moves (INF where the class is off)
  int d[6];  // diagonal moves
};

template <bool VEC>
__device__ __forceinline__ GrRaw gr_load(const int *__restrict__ tent,
                                         const uint8_t *__restrict__ free_mask,
                                         int H, int W, int r, int c0, int c,
                                         int lane) {
  GrRaw o;
#pragma unroll
  for (int j = 0; j < 4; ++j) o.v[j] = RT_INF32;
  o.el = RT_INF32;
  o.er = RT_INF32;
  o.fw = 0u;
  if (r < 0 || r >= H) return o;  // uniform over the warp
  const long long base = (long long)r * W;
  if (VEC) {
    if (c < W) {  // W % 4 == 0: the lane's 4 cells are all in or all out
      const int4 t = __ldg(reinterpret_cast<const int4 *>(tent + base + c));
      o.v[0] = t.x;
      o.v[1] = t.y;
      o.v[2] = t.z;
      o.v[3] = t.w;
      o.fw = __ldg(reinterpret_cast<const unsigned *>(free_mask + base + c));
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + j < W) {
        o.v[j] = __ldg(tent + base + c + j);
        o.fw |= (unsigned)__ldg(free_mask + base + c + j) << (8 * j);
      }
  }
  if (lane == 0 && c0 > 0) o.el = __ldg(tent + base + c0 - 1);
  if (lane == 31 && c0 + GR_STRIP < W)
    o.er = __ldg(tent + base + c0 + GR_STRIP);
  return o;
}

// Every lane of the warp calls it (the shuffles need all 32).
template <bool S, bool D>
__device__ __forceinline__ GrCand gr_cands(const GrRaw &x, int lo, int hi,
                                           int cs, int cd, int lane) {
  int left = __shfl_up_sync(RT_FULL, x.v[3], 1);
  int right = __shfl_down_sync(RT_FULL, x.v[0], 1);
  if (lane == 0) left = x.el;
  if (lane == 31) right = x.er;
  const int w[6] = {left, x.v[0], x.v[1], x.v[2], x.v[3], right};
  GrCand o;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const bool f = lo <= w[k] && w[k] < hi;
    o.s[k] = (S && f) ? (int)((unsigned)w[k] + (unsigned)cs) : RT_INF32;
    o.d[k] = (D && f) ? (int)((unsigned)w[k] + (unsigned)cd) : RT_INF32;
  }
  return o;
}

// Cell j of the lane in row r, from the candidates of rows r-1 (P), r (C)
// and r+1 (N) and row r's raw tent and free bytes.
template <bool S, bool D>
__device__ __forceinline__ int gr_out(const GrCand &P, const GrCand &C,
                                      const GrCand &N, int t, unsigned fw,
                                      int j) {
  int best = RT_INF32;
  if (S) best = min(min(P.s[j + 1], N.s[j + 1]), min(C.s[j], C.s[j + 2]));
  if (D)
    best = min(best, min(min(P.d[j], P.d[j + 2]), min(N.d[j], N.d[j + 2])));
  return (fw & (0xffu << (8 * j))) ? min(t, best) : RT_INF32;
}

template <bool VEC, bool S, bool D>
__global__ void __launch_bounds__(GR_WARPS * 32)
    grid_relax_kernel(const int *__restrict__ tent,
                      const uint8_t *__restrict__ free_mask, int H, int W,
                      int groups_x, int lo, int hi, int cs, int cd,
                      int *__restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int b = (int)blockIdx.x;
  const int chunk = b / groups_x;
  const int strip = (b - chunk * groups_x) * GR_WARPS + (threadIdx.x >> 5);
  const int c0 = strip * GR_STRIP;
  if (c0 >= W) return;  // the whole warp: no shuffle is left waiting
  const int c = c0 + 4 * lane;
  const int r0 = chunk * GR_ROWS;

  const GrRaw above = gr_load<VEC>(tent, free_mask, H, W, r0 - 1, c0, c, lane);
  GrRaw cur = gr_load<VEC>(tent, free_mask, H, W, r0, c0, c, lane);
  GrRaw ahead[GR_AHEAD];
#pragma unroll
  for (int k = 0; k < GR_AHEAD; ++k)
    ahead[k] = gr_load<VEC>(tent, free_mask, H, W,
                            k + 1 <= GR_ROWS ? r0 + 1 + k : -1, c0, c, lane);
  GrCand P = gr_cands<S, D>(above, lo, hi, cs, cd, lane);
  GrCand C = gr_cands<S, D>(cur, lo, hi, cs, cd, lane);

#pragma unroll
  for (int rr = 0; rr < GR_ROWS; ++rr) {
    const int r = r0 + rr;
    if (r >= H) break;
    const GrRaw nxt = ahead[0];
#pragma unroll
    for (int k = 0; k + 1 < GR_AHEAD; ++k) ahead[k] = ahead[k + 1];
    // row r + 1 + GR_AHEAD, unless it lies past the band's lower halo
    ahead[GR_AHEAD - 1] = gr_load<VEC>(
        tent, free_mask, H, W,
        rr + 1 + GR_AHEAD <= GR_ROWS ? r + 1 + GR_AHEAD : -1, c0, c, lane);
    const GrCand N = gr_cands<S, D>(nxt, lo, hi, cs, cd, lane);
    int o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[j] = gr_out<S, D>(P, C, N, cur.v[j], cur.fw, j);
    const long long base = (long long)r * W;
    if (VEC) {
      if (c < W)
        *reinterpret_cast<int4 *>(out + base + c) =
            make_int4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < W) out[base + c + j] = o[j];
    }
    P = C;
    C = N;
    cur = nxt;
  }
}

template <bool VEC, bool S, bool D>
static int gr_launch(const void *tent, const void *free_mask, int H, int W,
                     int lo, int hi, int cs, int cd, void *out,
                     cudaStream_t stream) {
  const int strips = (W + GR_STRIP - 1) / GR_STRIP;
  const int groups_x = (strips + GR_WARPS - 1) / GR_WARPS;
  const long long blocks =
      (long long)groups_x * ((H + GR_ROWS - 1) / GR_ROWS);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  grid_relax_kernel<VEC, S, D><<<(unsigned)blocks, GR_WARPS * 32, 0, stream>>>(
      (const int *)tent, (const uint8_t *)free_mask, H, W, groups_x, lo, hi,
      cs, cd, (int *)out);
  return (int)cudaGetLastError();
}

template <bool VEC>
static int gr_launch_phase(const void *tent, const void *free_mask, int H,
                           int W, int lo, int hi, int cs, int cd,
                           int straight_on, int diag_on, void *out,
                           cudaStream_t stream) {
  if (straight_on && diag_on)
    return gr_launch<VEC, true, true>(tent, free_mask, H, W, lo, hi, cs, cd,
                                      out, stream);
  if (straight_on)
    return gr_launch<VEC, true, false>(tent, free_mask, H, W, lo, hi, cs, cd,
                                       out, stream);
  if (diag_on)
    return gr_launch<VEC, false, true>(tent, free_mask, H, W, lo, hi, cs, cd,
                                       out, stream);
  return gr_launch<VEC, false, false>(tent, free_mask, H, W, lo, hi, cs, cd,
                                      out, stream);
}

// tent int32[H, W], free_mask uint8[H, W] (0 = blocked), out int32[H, W];
// H, W >= 1; the bucket as [lo, hi) with 0 <= lo <= hi <= INF. vec asks
// for the vector path, which needs W % 4 == 0, tent and out 16-byte
// aligned and free_mask 4-byte aligned (refused otherwise).
extern "C" int grid_relax_launch(const void *tent, const void *free_mask,
                                 int H, int W, int lo, int hi, int cs, int cd,
                                 int straight_on, int diag_on, int vec,
                                 void *out, void *stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    if (W % 4 != 0 || (uintptr_t)tent % 16 != 0 || (uintptr_t)out % 16 != 0 ||
        (uintptr_t)free_mask % 4 != 0)
      return (int)cudaErrorInvalidValue;
    return gr_launch_phase<true>(tent, free_mask, H, W, lo, hi, cs, cd,
                                 straight_on, diag_on, out, s);
  }
  return gr_launch_phase<false>(tent, free_mask, H, W, lo, hi, cs, cd,
                                straight_on, diag_on, out, s);
}
