"""Launcher of the CUDA ``ell_relax`` kernel (``csrc/ell_relax.cu``), the
Hopper counterpart of the TPU kernel
``src/repro/kernels/ell_relax/ell_relax.py: ell_relax_kernel`` (both of
its entry points, blocked and row-gather).

Bound on the H100 by bytes (one weight read and one candidate written
per output slot); the source note in ``ell_relax.cu`` gives the design.
The launcher picks the kernel's vector or word walk, its batch and
split, and the constants that step it (``relax_layout``), so the kernel
divides nothing per output word. ``ell_relax_cuda.launches`` counts the
launches of this process.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


# warps that fill the H100 (132 SMs at 32 resident warps each): below
# this many chunks of 32 rows, warps split a chunk's walk between them
_FILL_WARPS = 132 * 32
_MAX_SPLIT_LOG2 = 3


def relax_layout(w_ell: torch.Tensor, cap: int):
    """``(vec, units, batch, split_log2, q, rem)`` of the kernel's walk
    over a ``[cap, D]`` output (16-byte aligned, as ``torch.empty``
    gives it) of the ``D`` columns of ``w_ell``. ``vec`` 1 where
    16-byte units fit (``D % 4 == 0`` and ``w_ell`` 16-byte aligned),
    else 0; ``units`` per row (``D // 4`` or ``D``); ``batch`` steps
    whose loads a warp issues together (4, or 1 where a chunk of 32 rows
    takes fewer than 4 steps); ``2**split_log2`` warps share a chunk
    where the chunks are too few to fill the card; and ``32 *
    2**split_log2 = q * units + rem``, the advance of a lane's (row,
    unit) from one step to its next. A zero-width block gives ``units``
    0 (the kernel writes nothing)."""
    width = w_ell.shape[1]
    vec = int(width > 0 and width % 4 == 0 and w_ell.data_ptr() % 16 == 0)
    units = width // 4 if vec else width
    if units == 0:
        return vec, 0, 1, 0, 0, 0
    batch = 4 if units >= 4 else 1
    chunks = -(-cap // 32)
    split_log2 = 0
    while (split_log2 < _MAX_SPLIT_LOG2
           and chunks << split_log2 < _FILL_WARPS
           and batch << split_log2 < units):
        split_log2 += 1
    q, rem = divmod(32 << split_log2, units)
    return vec, units, batch, split_log2, q, rem


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
    vec, units, batch, split_log2, q, rem = relax_layout(w_ell, cap)
    with _build.on_device(dev):
        err = lib.ell_relax_launch(
            fidx.data_ptr(), dist.data_ptr(), w_ell.data_ptr(), n, cap,
            vec, units, batch, split_log2, q, rem, out.data_ptr(),
            _build.stream_of(dev))
    _build.check(err, "ell_relax")
    ell_relax_cuda.launches += 1
    return out


ell_relax_cuda.launches = 0
