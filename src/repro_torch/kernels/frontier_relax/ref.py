"""Plain PyTorch twin of ``frontier_relax`` (counterpart of
``repro.kernels.frontier_relax.ref``): the three fused phases as the
separate tensor operations they replace."""
from __future__ import annotations

import torch

_INF = 2**31 - 1
_IMAX = 2**31 - 1


def compact_ref(mask: torch.Tensor, cap: int, fill: int) -> torch.Tensor:
    """``jnp.nonzero(mask, size=cap, fill_value=fill)[0]`` as int32: the
    ascending indices of the set flags, truncated at ``cap``, padded
    with ``fill``. Rank by running count, scatter the first ``cap``
    ranks into their slots; the rest land in a discarded slot ``cap``.
    No host synchronisation. Over ``[B, n]`` lanes each lane is
    compacted on its own (the reference's ``vmap``)."""
    n = mask.shape[-1]
    rank = torch.cumsum(mask, -1, dtype=torch.int32) - 1
    slot = torch.where(mask & (rank < cap), rank, cap).to(torch.int64)
    buf = torch.full(mask.shape[:-1] + (cap + 1,), fill, dtype=torch.int32,
                     device=mask.device)
    buf.scatter_(-1, slot, torch.arange(n, dtype=torch.int32,
                                        device=mask.device).expand(mask.shape))
    return buf[..., :cap]


def frontier_relax_ref(dist, explored, bucket_i, nbr, w_ell, *, delta: int,
                       cap: int, base: int = 0, sent: int | None = None):
    """dist/explored: int32[S] (a tent slice); nbr/w_ell: int32[S+1, D]
    ELL block with all-sentinel row S. Returns ``(fidx int32[cap],
    rows_n int32[cap, D], rows_w int32[cap, D], count int32, any bool,
    next int32)`` — ``fidx`` carries global ids (``base`` + local,
    padding sentinel ``sent``, default S); ``count`` is the untruncated
    frontier population, so ``count > cap`` is the overflow signal."""
    s = dist.shape[0]
    sent = s if sent is None else sent
    fin = dist < _INF
    b = torch.where(fin, dist // delta, _IMAX)
    unsettled = dist < explored
    f = fin & (b == bucket_i) & unsettled
    nxt = torch.where((b > bucket_i) & unsettled, b, _IMAX).min()
    lidx = compact_ref(f, cap, s)
    fidx = torch.where(lidx < s, lidx + base, sent).to(torch.int32)
    rows_n = nbr[lidx]                      # row s is all-sentinel
    rows_w = w_ell[lidx]
    return (fidx, rows_n, rows_w, f.sum().to(torch.int32), f.any(),
            nxt.to(torch.int32))
