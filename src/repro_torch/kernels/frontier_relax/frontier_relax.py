"""Launcher of the CUDA ``frontier_relax`` kernels
(``csrc/frontier_relax.cu``), the Hopper counterpart of the TPU kernel
``src/repro/kernels/frontier_relax/frontier_relax.py:
frontier_relax_kernel``.

One call is one fused step: flags + tile populations, a scan of the
tile populations, the ordered scatter into ``cap`` slots and the row
gather — four launches on the current stream, counted as one launch of
the fused kernel in ``frontier_relax_cuda.launches``. Bound on the H100
by bytes; the source note in ``frontier_relax.cu`` gives the design.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_IMAX = 2**31 - 1
TILE = 1024   # vertices per block of the flag and scatter passes


def frontier_relax_cuda(dist: torch.Tensor, explored: torch.Tensor,
                        bucket_i, nbr: torch.Tensor, w_ell: torch.Tensor, *,
                        delta: int, cap: int, base: int = 0,
                        sent: int | None = None):
    """dist/explored int32[S], nbr/w_ell int32[S+1, D] on one CUDA
    device → ``(fidx int32[cap], rows_n int32[cap, D], rows_w
    int32[cap, D], count int32, any bool, next int32)``, all on the
    device; no synchronisation."""
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
    sent = s if sent is None else int(sent)
    n_tiles = max(1, -(-s // TILE))
    lib = _build.load().lib
    tile_counts = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    tile_offsets = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    lidx = torch.empty(cap, dtype=torch.int32, device=dev)
    fidx = torch.empty(cap, dtype=torch.int32, device=dev)
    rows_n = torch.empty((cap, d), dtype=torch.int32, device=dev)
    rows_w = torch.empty((cap, d), dtype=torch.int32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    any_ = torch.full((1,), 0, dtype=torch.int32, device=dev)
    nxt = torch.full((1,), _IMAX, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.frontier_relax_launch(
            dist.data_ptr(), explored.data_ptr(), s, int(bucket_i),
            int(delta), nbr.data_ptr(), w_ell.data_ptr(), d, int(cap),
            int(base), sent, tile_counts.data_ptr(), tile_offsets.data_ptr(),
            n_tiles, lidx.data_ptr(), fidx.data_ptr(), rows_n.data_ptr(),
            rows_w.data_ptr(), count.data_ptr(), any_.data_ptr(),
            nxt.data_ptr(), _build.stream_of(dev))
    _build.check(err, "frontier_relax")
    frontier_relax_cuda.launches += 1
    return fidx, rows_n, rows_w, count[0], any_[0] != 0, nxt[0]


frontier_relax_cuda.launches = 0
