"""Launcher of the CUDA ``frontier_relax`` kernels
(``csrc/frontier_relax.cu``), the Hopper counterpart of the TPU kernel
``src/repro/kernels/frontier_relax/frontier_relax.py:
frontier_relax_kernel``.

One call is one fused step in two device kernels on the current stream,
and nothing else: a scan of ``dist``/``explored`` (ballot words, tile
populations and offsets, ``count``/``any``/``next``, read once, no
division per element), then the ordered compaction with its row gather
and padding. The launcher hands the kernels the bucket as a range of
values (``scan_range``, shared with ``bucket_scan``), allocates the
outputs with ``torch.empty``, keeps the kernels' temporaries in one
scratch buffer per (device, stream) that grows with ``S``, and sizes the
grids (``gather_layout``). Bound on the H100 by bytes; the source note
in ``frontier_relax.cu`` gives the design and why two launches.
``frontier_relax_cuda.launches`` counts calls (+1 per call).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bucket_scan.bucket_scan import scan_range

THREADS = 256              # threads per block of both kernels
TILE = 1024                # vertices per scan tile (FR_TILE)
TILE_WORDS = TILE // 32    # ballot words per tile
SUB = 256                  # vertices per gather sub-tile (FR_SUB)
SCAN_MAX_BLOCKS = 132 * 4  # scan blocks at most (FR_SCAN_MAX_BLOCKS)
# gather and padding blocks at most, 4 and 2 per SM: all resident at
# once (the gather kernel fits 6 blocks per SM). The copy of frontier
# rows is latency-bound and takes the larger share; the padding's
# 16-byte stores reach the write rate with fewer blocks.
GATHER_MAX_BLOCKS = 132 * 4
PAD_MAX_BLOCKS = 132 * 2
PAD_STEPS = 4              # padding units per thread the grid is sized for

# (device index, stream handle) -> the kernels' scratch; its first int,
# the scan's ticket, is 0 between launches
_scratch: dict[tuple[int, int], torch.Tensor] = {}


def n_tiles(s: int) -> int:
    """Tiles of ``TILE`` vertices over ``S`` (one for ``S == 0``)."""
    return max(1, -(-s // TILE))


def scratch_ints(s: int) -> int:
    """Scratch ints for a slice of ``S`` vertices: the ticket and 3
    unused, one minimum per scan block, the tile populations and the
    tile offsets (``n_tiles`` rounded up to 4 each, so that every region
    starts 16-byte aligned), and per tile its 4 sub-tile populations and
    its 32 ballot words."""
    tiles = n_tiles(s)
    return 4 + SCAN_MAX_BLOCKS + 2 * (-(-tiles // 4) * 4) \
        + (TILE // SUB + TILE_WORDS) * tiles


def gather_layout(s: int, cap: int,
                  d: int) -> tuple[int, int, int, int, int]:
    """``(n_tiles, scan_blocks, gather_blocks, pad_blocks,
    group_log2)``: the scan's grid (a block per tile up to
    ``SCAN_MAX_BLOCKS``, then two tiles an iteration in a grid-stride
    loop); the gather's blocks, one per sub-tile of ``SUB`` vertices up
    to ``GATHER_MAX_BLOCKS`` (then sub-tiles in a grid-stride loop),
    followed by its padding blocks, enough for the most padding a call
    can have (``cap`` slots: ``cap`` ids and ``cap * D / 4`` 16-byte
    units of each block) at ``PAD_STEPS`` units a thread, at most
    ``PAD_MAX_BLOCKS``; and the lanes that own a frontier row,
    ``2**group_log2`` = the least power of two >= ``min(D, 32)``."""
    tiles = n_tiles(s)
    units = max(cap, cap * d // 4)
    per_block = THREADS * PAD_STEPS
    pad_blocks = min(PAD_MAX_BLOCKS, max(1, -(-units // per_block)))
    gather_blocks = min(tiles * (TILE // SUB), GATHER_MAX_BLOCKS)
    group_log2 = max(0, min(d, 32) - 1).bit_length()
    return (tiles, min(tiles, SCAN_MAX_BLOCKS), gather_blocks, pad_blocks,
            group_log2)


def vector_path(dist: torch.Tensor, explored: torch.Tensor) -> bool:
    """Whether the scan may load ``dist``/``explored`` in 16-byte units:
    both start 16-byte aligned (a view such as ``t[1:]`` does not)."""
    return dist.data_ptr() % 16 == 0 and explored.data_ptr() % 16 == 0


def _scratch_of(device: torch.device, stream: int, ints: int) -> int:
    """This (device, stream)'s scratch, grown (zeroed) where it holds
    fewer than ``ints``. A buffer replaced while a launch that uses it is
    queued is freed to the caching allocator on its own stream, which
    reuses it only after that launch."""
    key = (device.index, stream)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < ints:
        buf = torch.zeros(ints, dtype=torch.int32, device=device)
        _scratch[key] = buf
    return buf.data_ptr()


def frontier_relax_cuda(dist: torch.Tensor, explored: torch.Tensor,
                        bucket_i, nbr: torch.Tensor, w_ell: torch.Tensor, *,
                        delta: int, cap: int, base: int = 0,
                        sent: int | None = None):
    """dist/explored int32[S], nbr/w_ell int32[S+1, D] on one CUDA
    device → ``(fidx int32[cap], rows_n int32[cap, D], rows_w
    int32[cap, D], count int32, any bool, next int32)``, all on the
    device; no synchronisation. Any int32 ``bucket_i`` and any int32
    ``dist``/``explored``, negative included."""
    lo, hi = scan_range(bucket_i, delta)
    dev = dist.device
    for name, t, nd in (("dist", dist, 1), ("explored", explored, 1),
                        ("nbr", nbr, 2), ("w_ell", w_ell, 2)):
        _build.require_cuda_int32(name, t, dev, nd)
    s = dist.shape[0]
    d = w_ell.shape[1]
    if explored.shape[0] != s or nbr.shape != (s + 1, d) \
            or w_ell.shape[0] != s + 1:
        raise ValueError(f"shapes disagree: S={s}, nbr {tuple(nbr.shape)}, "
                         f"w_ell {tuple(w_ell.shape)}")
    cap = int(cap)
    sent = s if sent is None else int(sent)
    tiles, scan_blocks, gather_blocks, pad_blocks, group_log2 = \
        gather_layout(s, cap, d)
    lib = _build.load().lib
    fidx = torch.empty(cap, dtype=torch.int32, device=dev)
    rows_n = torch.empty((cap, d), dtype=torch.int32, device=dev)
    rows_w = torch.empty((cap, d), dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    any_ = torch.empty((), dtype=torch.bool, device=dev)
    nxt = torch.empty((), dtype=torch.int32, device=dev)
    with _build.on_device(dev):
        stream = _build.stream_of(dev)
        err = lib.frontier_relax_launch(
            dist.data_ptr(), explored.data_ptr(), s, lo, hi, int(delta),
            int(vector_path(dist, explored)), nbr.data_ptr(),
            w_ell.data_ptr(), d, cap, int(base), sent, tiles, scan_blocks,
            gather_blocks, pad_blocks, group_log2,
            _scratch_of(dev, stream, scratch_ints(s)),
            fidx.data_ptr(), rows_n.data_ptr(), rows_w.data_ptr(),
            count.data_ptr(), any_.data_ptr(), nxt.data_ptr(), stream)
    _build.check(err, "frontier_relax")
    frontier_relax_cuda.launches += 1
    return fidx, rows_n, rows_w, count, any_, nxt


frontier_relax_cuda.launches = 0
