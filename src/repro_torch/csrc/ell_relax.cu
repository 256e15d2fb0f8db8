// Hand-written Hopper kernel: relaxation candidates of compacted ELL rows.
//
// Replaces the TPU kernel src/repro/kernels/ell_relax/ell_relax.py:
// ell_relax_kernel (entries ell_relax_pallas, blocked, and
// ell_relax_row_gather_pallas, scalar-prefetch row DMA):
//   cand[j, k] = dist[fidx[j]] + w_ell[fidx[j], k]  where both are finite,
//   INF otherwise; fidx == n (padding) reads the all-INF row n.
//
// What bounds it on the H100: bytes. Per output element it reads at most
// one weight and writes one candidate (plus one index and one distance
// per row), with one add: on the 1 M small-world sweep (cap = 1 M rows
// of D = 19), 116 MB, 0.035 ms at 3.35 TB/s. The design, point by point
// against what held the first version (one thread per output word, a
// 64-bit division and a chain of three dependent loads each) at half of
// that bound:
// 1. Rows, not a flat index. A warp owns a chunk of 32 consecutive rows.
//    Lane r loads fidx and dist of row r of the chunk (one coalesced
//    load, one gather), then the warp walks the chunk's 32 * D outputs in
//    order, 32 at a time, so its stores are contiguous; each lane takes
//    its row's index and distance from the row's lane by a shuffle. A
//    lane's (row, column) advances by constants the launcher computes
//    (32 * split = q * D + rem), so nothing is divided per output word;
//    one 32-bit division per thread places its first word.
// 2. Padding and INF rows read no weights. A row whose fidx lies outside
//    [0, n) (the sentinel n included) or whose distance is INF writes
//    INF: bitwise the reference, whose sentinel row is all INF and whose
//    mask needs a finite distance. At cap = n most rows are padding, and
//    the compacted frontier puts them together: a chunk of 32 such rows
//    is written with 16-byte stores whatever D is.
// 3. Loads in flight. The walk takes BATCH steps at a time: their weight
//    loads first, then their stores, so a warp has BATCH loads in flight.
//    One warp per chunk (no grid-stride loop), so the block scheduler
//    balances chunks of frontier rows against chunks of padding. Where
//    the chunks are too few to fill the card (a capped frontier), split
//    warps share a chunk's walk, each taking every split-th step.
// 4. Streaming cache hints. The candidates are written, and the weight
//    rows read, once per call and are larger than the L2: both go with
//    evict-first hints (__stcs, __ldcs), which leave the L2 to fidx and
//    dist.
// 5. Vector accesses. Where D % 4 == 0 and w_ell is 16-byte aligned,
//    the same walk moves 16-byte units (4 columns) with one load and one
//    store each; otherwise 4-byte words (on the H100 a walk of 16-byte
//    stores straddling rows, with 4-byte weight loads, was slower for
//    D = 19 than the word walk). The launcher chooses the walk, BATCH
//    and split (relax_layout in kernels/ell_relax/ell_relax.py).
//
// The mask is applied before the add, and the add wraps like int32 on
// the TPU (unsigned), so INF + w never appears.
#include "common.cuh"

#define ER_THREADS 256

__device__ __forceinline__ int er_cand(int d, int w) {
  return w < RT_INF32 ? (int)((unsigned)d + (unsigned)w) : RT_INF32;
}

__device__ __forceinline__ int4 er_cand(int d, int4 w) {
  return make_int4(er_cand(d, w.x), er_cand(d, w.y), er_cand(d, w.z),
                   er_cand(d, w.w));
}

template <typename U>
__device__ __forceinline__ U er_inf() {
  return RT_INF32;
}

template <>
__device__ __forceinline__ int4 er_inf<int4>() {
  return make_int4(RT_INF32, RT_INF32, RT_INF32, RT_INF32);
}

// U: int (one column a unit) or int4 (four); units: units per row, 0 for
// a zero-width block (nothing to write); 2^split_log2 warps share a
// chunk; q, rem: 32 * 2^split_log2 = q * units + rem, 0 <= rem < units.
// out is 16-byte aligned (the launcher's torch.empty).
template <typename U, int BATCH>
__global__ void __launch_bounds__(ER_THREADS)
    ell_relax_kernel(const int *__restrict__ fidx,
                     const int *__restrict__ dist,
                     const U *__restrict__ w_ell, int n, long long cap,
                     int units, int split_log2, int q, int rem,
                     U *__restrict__ out) {
  const long long gw =
      ((long long)blockIdx.x * ER_THREADS + threadIdx.x) >> 5;
  const long long row0 = (gw >> split_log2) << 5;
  if (units == 0 || row0 >= cap) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int part = (int)(gw & ((1 << split_log2) - 1));
  const long long j = row0 + lane;
  const int f = j < cap ? fidx[j] : n;
  const int d = (unsigned)f < (unsigned)n ? dist[f] : RT_INF32;
  const long long rows = cap - row0 < 32 ? cap - row0 : 32;
  const long long step = 32LL << split_log2;
  U *o = out + row0 * units;
  if (rows == 32 && __all_sync(RT_FULL, d == RT_INF32)) {
    // 32 padding or INF rows: 32 * D INF words, 16-byte aligned (a chunk
    // spans 128 * D bytes), in 16-byte stores
    int4 *o4 = reinterpret_cast<int4 *>(o);
    const int quads = (int)(sizeof(U) / sizeof(int)) * 8 * units;
    for (int p = 32 * part + lane; p < quads; p += (int)step)
      __stcs(&o4[p], er_inf<int4>());
    return;
  }
  const long long total = rows * units;
  const int first = 32 * part + lane;
  int r = first / units;  // this lane's first (row, unit) in the chunk
  int k = first - r * units;
  for (long long base = 32LL * part; base < total; base += step * BATCH) {
    U wv[BATCH];
    int dv[BATCH];
#pragma unroll
    for (int s = 0; s < BATCH; ++s) {  // the batch's loads first
      const int fr = __shfl_sync(RT_FULL, f, r & 31);
      const int dr = __shfl_sync(RT_FULL, d, r & 31);
      dv[s] = base + s * step + lane < total ? dr : RT_INF32;
      if (dv[s] < RT_INF32)
        wv[s] = __ldcs(&w_ell[(long long)fr * units + k]);
      k += rem;
      r += q;
      if (k >= units) {
        k -= units;
        ++r;
      }
    }
#pragma unroll
    for (int s = 0; s < BATCH; ++s) {
      const long long p = base + s * step + lane;
      if (p < total)
        __stcs(&o[p],
               dv[s] < RT_INF32 ? er_cand(dv[s], wv[s]) : er_inf<U>());
    }
  }
}

template <typename U, int BATCH>
static void er_launch(const void *fidx, const void *dist, const void *w_ell,
                      int n, long long cap, int units, int split_log2, int q,
                      int rem, void *out, cudaStream_t stream) {
  const long long warps = ((cap + 31) >> 5) << split_log2;
  const unsigned blocks = rt_blocks(warps, ER_THREADS / 32, 0x7fffffff);
  ell_relax_kernel<U, BATCH><<<blocks, ER_THREADS, 0, stream>>>(
      (const int *)fidx, (const int *)dist, (const U *)w_ell, n, cap, units,
      split_log2, q, rem, (U *)out);
}

// units = D (vec 0) or D / 4 (vec 1); batch 1 or 4; split_log2, q, rem
// as the kernel takes them. One launch per call, an empty output
// included.
extern "C" int ell_relax_launch(const void *fidx, const void *dist,
                                const void *w_ell, int n, long long cap,
                                int vec, int units, int batch,
                                int split_log2, int q, int rem, void *out,
                                void *stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (vec && batch == 4)
    er_launch<int4, 4>(fidx, dist, w_ell, n, cap, units, split_log2, q, rem,
                       out, st);
  else if (vec)
    er_launch<int4, 1>(fidx, dist, w_ell, n, cap, units, split_log2, q, rem,
                       out, st);
  else if (batch == 4)
    er_launch<int, 4>(fidx, dist, w_ell, n, cap, units, split_log2, q, rem,
                      out, st);
  else
    er_launch<int, 1>(fidx, dist, w_ell, n, cap, units, split_log2, q, rem,
                      out, st);
  return (int)cudaGetLastError();
}
