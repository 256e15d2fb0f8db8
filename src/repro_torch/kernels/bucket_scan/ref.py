"""Plain PyTorch twin of ``bucket_scan`` (counterpart of
``repro.kernels.bucket_scan.ref``)."""
from __future__ import annotations

import torch

_INF = 2**31 - 1
_IMAX = 2**31 - 1


def bucket_scan_ref(tent: torch.Tensor, explored: torch.Tensor, bucket_i,
                    *, delta: int):
    """tent/explored int32[n] → (frontier bool[n], any bool, next int32).

    The next-bucket minimum counts unsettled vertices only
    (``tent < explored``); must stay in lockstep with
    ``core.backends.scan_bucket`` and the CUDA kernel."""
    fin = tent < _INF
    b = torch.where(fin, tent // delta, _IMAX)
    unsettled = tent < explored
    frontier = fin & (b == bucket_i) & unsettled
    nxt = torch.where((b > bucket_i) & unsettled, b, _IMAX).min()
    return frontier, frontier.any(), nxt
