"""Launcher of the CUDA ``grid_relax`` kernel (``csrc/grid_relax.cu``),
the Hopper counterpart of the TPU kernel
``src/repro/kernels/grid_relax/grid_relax.py: grid_relax_kernel``.

Bound on the H100 by bytes (4 read of ``tent``, 1 of ``free`` and 4
written per cell); the source note in ``grid_relax.cu`` gives the
design. The kernel takes any H x W: the TPU wrapper's padding to
``block_rows`` x 128 lanes is a TPU layout rule and has no counterpart.
The launcher hands the kernel the bucket as a range of values
(``bucket_range``), so the kernel divides nothing, and picks its
vector or scalar path (``vector_path``).
``grid_relax_cuda.launches`` counts the launches of this process.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.grid_relax.ref import phase_moves

_INF = 2**31 - 1


def bucket_range(bucket_i, delta: int) -> tuple[int, int]:
    """Bucket ``i`` as the half-open range of values ``[lo, hi)``: an
    int32 ``v`` lies in the bucket (``v < INF and v // delta == i``) iff
    ``lo <= v < hi``. Computed in Python integers and clipped at INF, so
    both bounds fit int32 also where ``i * delta`` does not. Refuses a
    negative bucket and a ``delta`` below 1."""
    i, d = int(bucket_i), int(delta)
    if i < 0:
        raise ValueError(f"bucket index must be >= 0, got {i}")
    if d < 1:
        raise ValueError(f"delta must be >= 1, got {d}")
    return min(i * d, _INF), min((i + 1) * d, _INF)


def vector_path(tent: torch.Tensor, free: torch.Tensor,
                out: torch.Tensor) -> bool:
    """Whether the kernel may take its vector path: 16-byte loads and
    stores need a width that is a multiple of 4 and ``tent``/``out``
    16-byte aligned, and ``free``'s 4-byte words 4-byte alignment."""
    return (tent.shape[1] % 4 == 0 and tent.data_ptr() % 16 == 0
            and out.data_ptr() % 16 == 0 and free.data_ptr() % 4 == 0)


def grid_relax_cuda(tent: torch.Tensor, free: torch.Tensor, bucket_i, *,
                    delta: int, cost_straight: int, cost_diag: int,
                    light: bool) -> torch.Tensor:
    """tent int32[H, W] and free bool[H, W] on one CUDA device →
    int32[H, W] on the device; no synchronisation. ``bucket_i`` >= 0."""
    lo, hi = bucket_range(bucket_i, delta)
    dev = tent.device
    _build.require_cuda_int32("tent", tent, dev, 2)
    if free.device != dev or free.dtype != torch.bool:
        raise TypeError(f"free must be a bool tensor on {dev}, got "
                        f"{free.dtype} on {free.device}")
    if free.shape != tent.shape or not free.is_contiguous():
        raise ValueError(f"free must be a contiguous {tuple(tent.shape)} "
                         f"mask, got {tuple(free.shape)}")
    h, w = tent.shape
    out = torch.empty_like(tent)
    if tent.numel() == 0:
        return out
    straight, diag = phase_moves(delta, cost_straight, cost_diag, light)
    lib = _build.load().lib
    with torch.cuda.device(dev):
        err = lib.grid_relax_launch(
            tent.data_ptr(), free.data_ptr(), h, w, lo, hi,
            int(cost_straight), int(cost_diag), int(straight), int(diag),
            int(vector_path(tent, free, out)), out.data_ptr(),
            _build.stream_of(dev))
    _build.check(err, "grid_relax")
    grid_relax_cuda.launches += 1
    return out


grid_relax_cuda.launches = 0
