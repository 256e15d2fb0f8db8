"""Plain PyTorch twin of ``ell_relax`` (counterpart of
``repro.kernels.ell_relax.ref``)."""
from __future__ import annotations

import torch

_INF = 2**31 - 1


def ell_relax_ref(fidx: torch.Tensor, dist: torch.Tensor,
                  w_ell: torch.Tensor) -> torch.Tensor:
    """fidx int32[cap] (sentinel n = padding), dist int32[n] tent,
    w_ell int32[n+1, D] (INF = padding slot) → candidates int32[cap, D].
    The sentinel reads an explicit INF slot appended to ``dist``."""
    d_ext = torch.cat([dist, dist.new_full((1,), _INF)])
    d_f = d_ext[fidx][:, None]                                  # [cap, 1]
    rows_w = w_ell[fidx]                                        # [cap, D]
    valid = (rows_w < _INF) & (d_f < _INF)
    cand = torch.where(valid, d_f, 0) + torch.where(valid, rows_w, 0)
    return torch.where(valid, cand, _INF)
