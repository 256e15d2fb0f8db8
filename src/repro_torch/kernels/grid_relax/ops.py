"""Dispatcher of ``grid_relax``: a CPU tensor goes to the plain twin, a
CUDA tensor to the hand-written kernel (no fallback)."""
from __future__ import annotations

from repro_torch.kernels.grid_relax.grid_relax import grid_relax_cuda
from repro_torch.kernels.grid_relax.ref import grid_relax_ref


def grid_relax(tent, free, bucket_i, *, delta: int = 13,
               cost_straight: int = 10, cost_diag: int = 14, light: bool):
    """One Δ-stepping relaxation sweep over a game-map grid.

    tent: int32[H, W] tentative distances (INF32 = unreached/blocked).
    free: bool[H, W] occupancy mask.
    bucket_i: the current bucket index.
    Returns int32[H, W] on the input's device."""
    kw = dict(delta=delta, cost_straight=cost_straight, cost_diag=cost_diag,
              light=light)
    if tent.device.type == "cpu":
        return grid_relax_ref(tent, free, bucket_i, **kw)
    return grid_relax_cuda(tent, free, bucket_i, **kw)
