// Hand-written Hopper kernels: fused frontier scan + ordered compaction
// + ELL row gather of one bucket.
//
// Replaces the TPU kernel
// src/repro/kernels/frontier_relax/frontier_relax.py: frontier_relax_kernel
// (entry frontier_relax_pallas). That kernel is one grid step with a
// scalar loop over every flag and every slot, leaning on VMEM residency
// of the whole tent slice and ELL block. Hopper has neither a
// sequential grid nor a VMEM that holds a million-vertex slice. The
// function:
//   frontier[v] = t < e & t // delta == i    (t = dist[v], e = explored[v])
//   lidx        = ascending v with frontier[v], truncated at cap, padded
//                 with S (the order of jnp.nonzero(size=cap, fill=S))
//   fidx[j]     = lidx[j] + base, or sent where lidx[j] == S
//   rows_n/w[j] = row lidx[j] of nbr / w_ell (row S: the sentinel row)
//   count       = population of frontier (untruncated: count > cap is
//                 the caller's overflow signal); any = count > 0
//   next        = min of t // delta over t < e & t // delta > i, else IMAX
//
// What bounds it on the H100: bytes. It reads dist and explored once (8
// bytes a vertex), the frontier's rows, and writes cap * (2D + 1) ints:
// at the 1 M small-world step with cap = n and D = 19, ~209 MB, 0.0625
// ms at 3.35 TB/s, of which the two [cap, D] outputs are 152 MB. With a
// small cap (4096, 64) the bound is the 8 MB pass, ~0.0025 ms, and a
// call is as short as two dependent launches. Two kernels a call, on one
// stream, and nothing else (no fill, no compare): the compaction needs
// every tile's population before any slot is known, and the second
// kernel is that one grid-wide dependency.
//
//   K1 frontier_scan_kernel: one pass over dist/explored, 16-byte loads
//      where both are 16-byte aligned (4-byte loads on the ragged last
//      tile and on unaligned views), two tiles' loads issued before
//      either is used. The bucket is the value range [lo, hi) from the
//      launcher (rt_range_one): no division per element, and every
//      int32 bucket and value the reference takes, negative and
//      past-int32 buckets included. Each 1024-vertex tile stores 32
//      ballot words (one bit a vertex, n / 8 bytes in all) and its
//      population; each block keeps its minimum next-bucket candidate.
//      Blocks finish with a "last block done" ticket (as in
//      bucket_scan.cu): the block that takes the last ticket scans the
//      tile populations into tile offsets (4 tiles a thread, one 16-byte
//      load), writes count, any and next = floor(min candidate / delta)
//      (the one division), and resets the ticket. The ticket is the one
//      state that lives across calls, in the launcher's scratch buffer
//      per (device, stream), zeroed when it is made; launches that share
//      it are ordered by their stream.
//   K2 frontier_gather_kernel: gather blocks, then padding blocks, all
//      resident at once. Gather blocks walk 256-vertex sub-tiles in a
//      grid-stride loop. A sub-tile's first slot is its tile's offset
//      plus the populations of the tile's sub-tiles before it (K1 stores
//      them too); a block fetches, for 32 of its sub-tiles at once, the
//      first slot, the population and the 8 ballot words (one round
//      trip, a word a thread; no second read of dist/explored), skips
//      the empty sub-tiles without a load, and stops at its first
//      sub-tile that starts at or past cap (offsets grow with the
//      sub-tile), so a small cap costs few blocks any work. Per
//      sub-tile it ranks the flags by popcounts, lists the frontier
//      vertices in shared memory in ascending order, writes their fidx
//      and copies their rows into contiguous slots. The copy is
//      row-wise: a group of G lanes (a power of two >= min(D, 32)) owns
//      a row, whose source and destination offsets are computed by one
//      multiplication each; the lanes walk the columns with coalesced
//      stores, FR_BATCH rows' loads issued before their stores.
//      Sub-tiles of 256 rather than whole tiles spread a capped
//      frontier over more warps: the copy is latency-bound, one DRAM
//      round trip per batch of rows. Padding blocks read count on the
//      device (no host synchronisation), stage row S in shared memory
//      (its values are read, never assumed) and write slots
//      [min(count, cap), cap): fidx = sent, and the rows as one flat
//      run of words in 16-byte stores (the outputs are the launcher's
//      torch.empty, 16-byte aligned) with at most 3 words at each end;
//      a thread's column advances by a constant, so nothing is divided
//      per word.
//   Tried on the H100 and not kept: launching K2 as a programmatic
//   dependent launch (faster on some paths, slower on the capped one);
//   8 rows' loads in flight per group (spills at 6 blocks per SM).
//
// Offsets into [cap, D] are 64-bit; vertex ids, slots and columns int32.
#include <cuda/atomic>

#include "common.cuh"

#define FR_THREADS 256
#define FR_TILE 1024                   // K1 tile: vertices, 4 a thread
#define FR_WORDS (FR_TILE / 32)        // ballot words per tile
#define FR_SUB 256                     // K2 sub-tile: vertices
#define FR_SUB_WORDS (FR_SUB / 32)
#define FR_SUBS (FR_TILE / FR_SUB)     // sub-tiles per tile
#define FR_SCAN_MAX_BLOCKS (132 * 4)   // K1 blocks at most (4 per SM)
#define FR_BATCH 4                     // rows a group loads before storing
#define FR_PAD_STAGE_D 1024            // row S staged in shared up to this D

// The scratch buffer, in ints (frontier_relax.py:scratch_ints): [0] the
// ticket, [1, 4) unused; [4, 4 + FR_SCAN_MAX_BLOCKS) each K1 block's
// minimum candidate; then the tile populations and the tile offsets,
// n_tiles rounded up to 4 each; FR_SUBS sub-tile populations per tile;
// FR_WORDS ballot words per tile. Every region starts 16-byte aligned.
struct FrScratch {
  int *ticket, *bmin, *pop, *off, *subpop;
  unsigned *bits;
  __device__ __forceinline__ FrScratch(int *s, int n_tiles)
      : ticket(s), bmin(s + 4), pop(s + 4 + FR_SCAN_MAX_BLOCKS),
        off(pop + ((n_tiles + 3) & ~3)),
        subpop(off + ((n_tiles + 3) & ~3)),
        bits(reinterpret_cast<unsigned *>(subpop + FR_SUBS * n_tiles)) {}
};

// 4 vertices from v on: 16-byte loads where VEC and the 4 lie below S;
// past S t = e = INF, neither a flag nor a candidate
template <bool VEC>
__device__ __forceinline__ void fr_load4(const int *__restrict__ dist,
                                         const int *__restrict__ explored,
                                         long long v, int S, int4 &t,
                                         int4 &e) {
  if (VEC && v + 4 <= S) {
    t = *reinterpret_cast<const int4 *>(dist + v);
    e = *reinterpret_cast<const int4 *>(explored + v);
  } else {
    t.x = v < S ? dist[v] : RT_INF32;
    t.y = v + 1 < S ? dist[v + 1] : RT_INF32;
    t.z = v + 2 < S ? dist[v + 2] : RT_INF32;
    t.w = v + 3 < S ? dist[v + 3] : RT_INF32;
    e.x = v < S ? explored[v] : RT_INF32;
    e.y = v + 1 < S ? explored[v + 1] : RT_INF32;
    e.z = v + 2 < S ? explored[v + 2] : RT_INF32;
    e.w = v + 3 < S ? explored[v + 3] : RT_INF32;
  }
}

// flags of the thread's 4 vertices into their ballot word (vertex
// 4 * threadIdx.x + j of a tile is bit 4 * (lane % 8) + j of word
// threadIdx.x / 8), stored by lane 8g; returns the warp's population
__device__ __forceinline__ int fr_ballot(int4 t, int4 e, int lo, int hi,
                                         int &m, unsigned *tile_bits) {
  const int lane = threadIdx.x & 31;
  unsigned f0, f1, f2, f3;
  rt_range_one(t.x, e.x, lo, hi, f0, m);
  rt_range_one(t.y, e.y, lo, hi, f1, m);
  rt_range_one(t.z, e.z, lo, hi, f2, m);
  rt_range_one(t.w, e.w, lo, hi, f3, m);
  unsigned word = (f0 | f1 << 1 | f2 << 2 | f3 << 3) << (4 * (lane & 7));
  word |= __shfl_xor_sync(RT_FULL, word, 1);
  word |= __shfl_xor_sync(RT_FULL, word, 2);
  word |= __shfl_xor_sync(RT_FULL, word, 4);
  if ((lane & 7) == 0) tile_bits[threadIdx.x >> 3] = word;
  return __reduce_add_sync(RT_FULL, (lane & 7) == 0 ? __popc(word) : 0);
}

template <bool VEC>
__global__ void __launch_bounds__(FR_THREADS)
    frontier_scan_kernel(const int *__restrict__ dist,
                         const int *__restrict__ explored, int S, int n_tiles,
                         int lo, int hi, int delta, int *scratch,
                         int *__restrict__ count_out,
                         uint8_t *__restrict__ any_out,
                         int *__restrict__ next_out) {
  const FrScratch sc(scratch, n_tiles);
  __shared__ int s_pop[2][FR_THREADS / 32];  // two tiles an iteration
  __shared__ int s_sub[2 * FR_SUBS];
  __shared__ int s_warp[32];
  __shared__ int s_last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int m = RT_INF32;  // min candidate t; INF: none (a candidate is < INF)
  for (int tile = blockIdx.x; tile < n_tiles; tile += 2 * gridDim.x) {
    const int tile2 = tile + gridDim.x;  // both tiles' loads first
    const long long v = (long long)tile * FR_TILE + 4 * threadIdx.x;
    const long long v2 = (long long)tile2 * FR_TILE + 4 * threadIdx.x;
    int4 t, e, t2, e2;
    fr_load4<VEC>(dist, explored, v, S, t, e);
    if (tile2 < n_tiles) fr_load4<VEC>(dist, explored, v2, S, t2, e2);
    const int c = fr_ballot(t, e, lo, hi, m,
                            sc.bits + (long long)tile * FR_WORDS);
    if (lane == 0) s_pop[0][warp] = c;
    if (tile2 < n_tiles) {
      const int c2 = fr_ballot(t2, e2, lo, hi, m,
                               sc.bits + (long long)tile2 * FR_WORDS);
      if (lane == 0) s_pop[1][warp] = c2;
    }
    __syncthreads();
    if (threadIdx.x < 2 * FR_SUBS) {  // the sub-tiles' populations:
      const int k = threadIdx.x % FR_SUBS;  // warps 2k and 2k + 1
      const int *sp = s_pop[threadIdx.x / FR_SUBS];
      s_sub[threadIdx.x] = sp[2 * k] + sp[2 * k + 1];
    }
    __syncthreads();
    if (threadIdx.x < 2 && (threadIdx.x == 0 || tile2 < n_tiles)) {
      const int *q = s_sub + FR_SUBS * threadIdx.x;
      const int tl = threadIdx.x == 0 ? tile : tile2;
      sc.pop[tl] = q[0] + q[1] + q[2] + q[3];
      reinterpret_cast<int4 *>(sc.subpop)[tl] =
          make_int4(q[0], q[1], q[2], q[3]);
    }
    __syncthreads();  // s_pop, s_sub are rewritten by the next iteration
  }

  // the block's minimum candidate, then a ticket; the last block
  // finishes. Threads 0 and 1 wrote this block's populations and each
  // fences them at device scope before the barrier; thread 0 writes its
  // minimum before its acq_rel ticket add, which releases them and, in
  // the last block, acquires every other block's (the adds form one
  // release sequence).
  if (threadIdx.x < 2) __threadfence();
  m = __reduce_min_sync(RT_FULL, m);
  if (lane == 0) s_warp[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < FR_THREADS / 32; ++w) m = min(m, s_warp[w]);
    sc.bmin[blockIdx.x] = m;
    s_last = cuda::atomic_ref<int, cuda::thread_scope_device>(*sc.ticket)
                 .fetch_add(1, cuda::memory_order_acq_rel) ==
             (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // the last block: min over the block minima (at most 3 a thread) and
  // exclusive scan of the tile populations (4 consecutive tiles a
  // thread, one 16-byte load); the first chunk's loads and the minima's
  // are issued together
  int carry = 0;
  int mm = RT_INF32;
  for (int base = 0; base < n_tiles; base += 4 * FR_THREADS) {
    const int k = base + 4 * threadIdx.x;
    int4 p = make_int4(0, 0, 0, 0);
    if (k < n_tiles)  // entries past n_tiles are padding: taken as 0
      p = __ldcg(reinterpret_cast<const int4 *>(sc.pop + k));
    if (base == 0) {
      const int b = threadIdx.x, g = gridDim.x;
      const int m0 = b < g ? __ldcg(&sc.bmin[b]) : RT_INF32;
      const int m1 = b + FR_THREADS < g ? __ldcg(&sc.bmin[b + FR_THREADS])
                                        : RT_INF32;
      const int m2 = b + 2 * FR_THREADS < g
                         ? __ldcg(&sc.bmin[b + 2 * FR_THREADS])
                         : RT_INF32;
      mm = min(m0, min(m1, m2));
    }
    if (k + 1 >= n_tiles) p.y = 0;
    if (k + 2 >= n_tiles) p.z = 0;
    if (k + 3 >= n_tiles) p.w = 0;
    int total;
    const int x = carry + rt_block_exclusive_scan(p.x + p.y + p.z + p.w,
                                                  s_warp, &total);
    if (k < n_tiles)
      *reinterpret_cast<int4 *>(sc.off + k) =
          make_int4(x, x + p.x, x + p.x + p.y, x + p.x + p.y + p.z);
    carry += total;
  }
  mm = __reduce_min_sync(RT_FULL, mm);
  if (lane == 0) s_warp[warp] = mm;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < FR_THREADS / 32; ++w) mm = min(mm, s_warp[w]);
    *count_out = carry;
    *any_out = (uint8_t)(carry != 0);
    *next_out = mm < RT_INF32 ? rt_floor_div(mm, delta) : RT_IMAX;
    *sc.ticket = 0;  // ready for the next launch on this stream
  }
}

// The frontier rows of sub-tiles gb_i, gb_i + gb, ...: each into its
// contiguous slots below cap. The block fetches, for FR_PREFETCH of its
// sub-tiles at once, each one's first slot (its tile's offset plus the
// populations of the tile's sub-tiles before it), population and 8
// ballot words: one round trip, a word a thread. It then walks them
// with no further load but the rows', skipping the empty ones; offsets
// grow with the sub-tile, so it stops at its first sub-tile that starts
// at or past cap.
#define FR_PREFETCH (FR_THREADS / FR_SUB_WORDS)  // 32 sub-tiles
__device__ __forceinline__ void fr_gather(
    const FrScratch &sc, int gb_i, int gb, int n_subs, int D, int cap,
    int base, int group_log2, const int *__restrict__ nbr,
    const int *__restrict__ w_ell, int *__restrict__ fidx,
    int *__restrict__ rows_n, int *__restrict__ rows_w) {
  __shared__ int s_soff[FR_PREFETCH], s_spop[FR_PREFETCH];
  __shared__ unsigned s_bits[FR_PREFETCH][FR_SUB_WORDS];
  __shared__ int s_list[FR_SUB];  // sub-tile-local vertex of each row
  const int G = 1 << group_log2;
  const int lg = threadIdx.x & (G - 1);
  const int ng = FR_THREADS >> group_log2;
  const int mine = gb_i < n_subs ? (n_subs - gb_i + gb - 1) / gb : 0;
  for (int j0 = 0; j0 < mine; j0 += FR_PREFETCH) {
    {
      const int j = j0 + threadIdx.x / FR_SUB_WORDS;
      const int wi = threadIdx.x % FR_SUB_WORDS;
      unsigned w = 0;
      int o = 0;
      int4 q = make_int4(0, 0, 0, 0);
      if (j < mine) {
        const int st = gb_i + j * gb;
        w = __ldcg(&sc.bits[(long long)st * FR_SUB_WORDS + wi]);
        if (wi == 0) {
          o = __ldcg(&sc.off[st / FR_SUBS]);
          q = __ldcg(reinterpret_cast<const int4 *>(sc.subpop) +
                     st / FR_SUBS);
        }
      }
      s_bits[threadIdx.x / FR_SUB_WORDS][wi] = w;
      if (wi == 0) {  // past the block's sub-tiles: a stop
        const int part = (gb_i + j * gb) % FR_SUBS;
        s_soff[threadIdx.x / FR_SUB_WORDS] =
            j < mine ? o + (part > 0 ? q.x : 0) + (part > 1 ? q.y : 0) +
                           (part > 2 ? q.z : 0)
                     : cap;
        s_spop[threadIdx.x / FR_SUB_WORDS] =
            part == 0 ? q.x : part == 1 ? q.y : part == 2 ? q.z : q.w;
      }
    }
    __syncthreads();
    const int jn = min(FR_PREFETCH, mine - j0);
    for (int jj = 0; jj < jn; ++jj) {
      const int off = s_soff[jj];
      if (off >= cap) return;  // this and every later sub-tile: the block
      const int pop = s_spop[jj];
      if (pop == 0) continue;
      const int rows = min(pop, cap - off);
      {
        const unsigned *bw = s_bits[jj];  // one vertex a thread
        const int wi = threadIdx.x >> 5, b = threadIdx.x & 31;
        const unsigned w = bw[wi];
        if ((w >> b) & 1u) {
          int r = __popc(w & ((1u << b) - 1u));
          for (int k = 0; k < wi; ++k) r += __popc(bw[k]);
          if (r < rows) s_list[r] = threadIdx.x;
        }
      }
      __syncthreads();
      const int v0 = (gb_i + (j0 + jj) * gb) * FR_SUB;
      if ((int)threadIdx.x < rows)
        fidx[off + threadIdx.x] =
            (int)((unsigned)(v0 + s_list[threadIdx.x]) + (unsigned)base);
      if (D > 0) {
        for (int r0 = threadIdx.x >> group_log2; r0 < rows;
             r0 += ng * FR_BATCH) {
          int v[FR_BATCH];  // each row's vertex, -1 past the last row
#pragma unroll
          for (int s = 0; s < FR_BATCH; ++s) {
            const int r = r0 + s * ng;
            v[s] = r < rows ? v0 + s_list[r] : -1;
          }
          for (int k = lg; k < D; k += G) {  // one step where D <= G
            int a[FR_BATCH], c[FR_BATCH];
#pragma unroll
            for (int s = 0; s < FR_BATCH; ++s)  // the batch's loads first
              if (v[s] >= 0) {
                const long long src = (long long)v[s] * D + k;
                a[s] = __ldcs(nbr + src);
                c[s] = __ldcs(w_ell + src);
              }
#pragma unroll
            for (int s = 0; s < FR_BATCH; ++s)
              if (v[s] >= 0) {
                const long long dst = (long long)(off + r0 + s * ng) * D + k;
                __stcs(rows_n + dst, a[s]);
                __stcs(rows_w + dst, c[s]);
              }
          }
        }
      }
      __syncthreads();  // s_list: the next sub-tile's
    }
    __syncthreads();  // s_soff, s_spop, s_bits: the next prefetch's
  }
}

// Padding slots [min(count, cap), cap), by padding block pb of npb.
__device__ __forceinline__ void fr_pad(int pb, int npb, int S, int D,
                                       int cap, int sent,
                                       const int *__restrict__ nbr,
                                       const int *__restrict__ w_ell,
                                       const int *__restrict__ count,
                                       int *__restrict__ fidx,
                                       int *__restrict__ rows_n,
                                       int *__restrict__ rows_w) {
  __shared__ int s_rn[FR_PAD_STAGE_D + 3];
  __shared__ int s_rw[FR_PAD_STAGE_D + 3];
  const int filled = min(__ldcg(count), cap);
  const int t = pb * FR_THREADS + threadIdx.x;
  const int T = npb * FR_THREADS;
  for (long long j = filled + t; j < cap; j += T) fidx[j] = sent;
  const long long wlo = (long long)filled * D;
  const long long whi = (long long)cap * D;
  if (wlo >= whi) return;  // the whole block (D == 0 included)
  const int *rsn = nbr + (long long)S * D;
  const int *rsw = w_ell + (long long)S * D;
  // row S in shared memory, extended by 3 words (word j holds column
  // j % D), so that columns k .. k + 3 of a 16-byte store are contiguous;
  // a wider row is read from device memory, with one wrap (D > 4)
  const bool staged = D <= FR_PAD_STAGE_D;
  if (staged) {
    for (int j = threadIdx.x; j < D + 3; j += FR_THREADS) {
      s_rn[j] = rsn[j % D];
      s_rw[j] = rsw[j % D];
    }
    __syncthreads();
  }
  const long long qa = (wlo + 3) >> 2;  // whole 16-byte units [qa, qb)
  const long long qb = whi >> 2;
  long long q = qa + t;
  if (q < qb) {
    int k = (int)((q << 2) % D);           // column of word 4q
    const int dk = (int)((4LL * T) % D);   // its advance per step
    int4 *on = reinterpret_cast<int4 *>(rows_n);
    int4 *ow = reinterpret_cast<int4 *>(rows_w);
    for (; q < qb; q += T) {
      int4 a, c;
      if (staged) {
        a = make_int4(s_rn[k], s_rn[k + 1], s_rn[k + 2], s_rn[k + 3]);
        c = make_int4(s_rw[k], s_rw[k + 1], s_rw[k + 2], s_rw[k + 3]);
      } else {
        const int k1 = k + 1 < D ? k + 1 : k + 1 - D;
        const int k2 = k + 2 < D ? k + 2 : k + 2 - D;
        const int k3 = k + 3 < D ? k + 3 : k + 3 - D;
        a = make_int4(rsn[k], rsn[k1], rsn[k2], rsn[k3]);
        c = make_int4(rsw[k], rsw[k1], rsw[k2], rsw[k3]);
      }
      __stcs(on + q, a);
      __stcs(ow + q, c);
      k += dk;
      if (k >= D) k -= D;
    }
  }
  // the words before unit qa and from unit qb on: at most 3 each, by the
  // first padding block (all of them where the run lies in one unit)
  if (pb == 0 && threadIdx.x < 8) {
    const long long w = threadIdx.x < 4 ? wlo + threadIdx.x
                                         : (qb << 2) + (threadIdx.x - 4);
    const bool mine = threadIdx.x < 4 ? w < min(qa << 2, whi)
                                      : qa <= qb && w < whi;
    if (mine) {
      const int k = (int)(w % D);
      rows_n[w] = rsn[k];
      rows_w[w] = rsw[k];
    }
  }
}

// blocks [0, gb) gather, [gb, gridDim.x) pad
__global__ void __launch_bounds__(FR_THREADS, 6)
    frontier_gather_kernel(int *scratch, int n_tiles, int gb, int S, int D,
                           int cap, int base, int sent, int group_log2,
                           const int *__restrict__ nbr,
                           const int *__restrict__ w_ell,
                           const int *__restrict__ count,
                           int *__restrict__ fidx, int *__restrict__ rows_n,
                           int *__restrict__ rows_w) {
  const FrScratch sc(scratch, n_tiles);
  if ((int)blockIdx.x < gb)
    fr_gather(sc, blockIdx.x, gb, n_tiles * FR_SUBS, D, cap, base,
              group_log2, nbr, w_ell, fidx, rows_n, rows_w);
  else
    fr_pad(blockIdx.x - gb, gridDim.x - gb, S, D, cap, sent, nbr, w_ell,
           count, fidx, rows_n, rows_w);
}

// lo, hi: bucket i as a value range clamped to [INT32_MIN, INF]; delta
// >= 1; vec: dist and explored 16-byte aligned; n_tiles = max(1,
// ceil(S / 1024)); 1 <= scan_blocks <= min(n_tiles, 528); 1 <=
// gather_blocks <= 4 * n_tiles; pad_blocks >= 1; group_log2 in [0, 5];
// scratch: frontier_relax.py:scratch_ints(S) ints, 16-byte aligned,
// whose first is 0, used by no launch that may run at the same time;
// fidx, rows_n, rows_w 16-byte aligned. Two launches on stream;
// returns cudaErrorInvalidValue on arguments outside these ranges.
extern "C" int frontier_relax_launch(
    const void *dist, const void *explored, int S, int lo, int hi,
    int delta, int vec, const void *nbr, const void *w_ell, int D, int cap,
    int base, int sent, int n_tiles, int scan_blocks, int gather_blocks,
    int pad_blocks, int group_log2, void *scratch, void *fidx,
    void *rows_n, void *rows_w, void *count_out, void *any_out,
    void *next_out, void *stream) {
  const int want_tiles = S > 0 ? (int)((S + (long long)FR_TILE - 1) / FR_TILE)
                               : 1;
  if (S < 0 || D < 0 || cap < 0 || delta < 1 || n_tiles != want_tiles ||
      scan_blocks < 1 || scan_blocks > n_tiles ||
      scan_blocks > FR_SCAN_MAX_BLOCKS || gather_blocks < 1 ||
      (long long)gather_blocks > (long long)n_tiles * FR_SUBS ||
      pad_blocks < 1 || group_log2 < 0 || group_log2 > 5 ||
      (long long)gather_blocks + pad_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    frontier_scan_kernel<true><<<scan_blocks, FR_THREADS, 0, st>>>(
        (const int *)dist, (const int *)explored, S, n_tiles, lo, hi, delta,
        (int *)scratch, (int *)count_out, (uint8_t *)any_out,
        (int *)next_out);
  else
    frontier_scan_kernel<false><<<scan_blocks, FR_THREADS, 0, st>>>(
        (const int *)dist, (const int *)explored, S, n_tiles, lo, hi, delta,
        (int *)scratch, (int *)count_out, (uint8_t *)any_out,
        (int *)next_out);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  frontier_gather_kernel<<<gather_blocks + pad_blocks, FR_THREADS, 0, st>>>(
      (int *)scratch, n_tiles, gather_blocks, S, D, cap, base, sent,
      group_log2, (const int *)nbr, (const int *)w_ell,
      (const int *)count_out, (int *)fidx, (int *)rows_n, (int *)rows_w);
  return (int)cudaGetLastError();
}
