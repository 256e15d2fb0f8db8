"""Launcher of the CUDA ``ell_relax`` kernel (``csrc/ell_relax.cu``), the
Hopper counterpart of the TPU kernel
``src/repro/kernels/ell_relax/ell_relax.py: ell_relax_kernel`` (both of
its entry points, blocked and row-gather).

Bound on the H100 by bytes (one weight read and one candidate written
per output slot); the source note in ``ell_relax.cu`` gives the design.
``ell_relax_cuda.launches`` counts the launches of this process.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def ell_relax_cuda(fidx: torch.Tensor, dist: torch.Tensor,
                   w_ell: torch.Tensor) -> torch.Tensor:
    """fidx int32[cap] (values in [0, n], n = padding), dist int32[n],
    w_ell int32[n+1, D] on one CUDA device → candidates int32[cap, D]."""
    dev = dist.device
    _build.require_cuda_int32("fidx", fidx, dev, 1)
    _build.require_cuda_int32("dist", dist, dev, 1)
    _build.require_cuda_int32("w_ell", w_ell, dev, 2)
    n = dist.shape[0]
    if w_ell.shape[0] != n + 1:
        raise ValueError(f"w_ell needs {n + 1} rows (row n all-INF), "
                         f"got {w_ell.shape[0]}")
    cap, d = fidx.shape[0], w_ell.shape[1]
    lib = _build.load().lib
    out = torch.empty((cap, d), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.ell_relax_launch(
            fidx.data_ptr(), dist.data_ptr(), w_ell.data_ptr(), n, cap, d,
            out.data_ptr(), _build.stream_of(dev))
    _build.check(err, "ell_relax")
    ell_relax_cuda.launches += 1
    return out


ell_relax_cuda.launches = 0
