"""Game-map Δ-stepping on the occupancy grid itself (paper §4 'Game
Maps'), the port's counterpart of ``repro.core.grid``.

The regular 8-neighbour structure needs no preprocessing (a move's
light/heavy class is known from its cost), and the relaxation is the
masked min-plus stencil ``kernels/grid_relax``: the hand-written CUDA
kernel on a CUDA tensor, its plain twin on a CPU tensor. With straight
cost 10 and diagonal cost 14 under the paper's Δ = 13, the light phase
sweeps straight moves to a fixpoint and one heavy pass relaxes the
diagonals. There is no explored/S bookkeeping: re-relaxing an unchanged
cell is idempotent, so the fixpoint test is "did the sweep change
anything".

``lax.while_loop`` becomes a host loop: one host synchronisation per
sweep of the light phase (its change flag) and one per bucket (the next
bucket index).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graphs.structures import INF32
from repro_torch.kernels.grid_relax import grid_relax

_INF = int(INF32)
_IMAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class GridDeltaConfig:
    """The reference's ``GridDeltaConfig`` field for field, so one config
    drives both packages. Every sweep goes through the ``grid_relax``
    dispatcher, which picks by device alone: the hand-written CUDA kernel
    on a CUDA tensor, the plain twin on a CPU tensor. ``backend`` is
    checked to be ``'pallas'`` or ``'ref'`` and otherwise has no effect,
    like ``block_rows`` and ``interpret``: the CUDA kernel takes any
    H x W, and there is no interpreter."""

    delta: int = 13
    cost_straight: int = 10
    cost_diag: int = 14
    backend: str = "ref"        # 'pallas' | 'ref'
    block_rows: int = 64
    interpret: bool = False


def free_mask_tensor(free_mask, device) -> torch.Tensor:
    """The occupancy mask as a contiguous bool tensor on ``device``."""
    if isinstance(free_mask, torch.Tensor):
        return free_mask.to(device=device, dtype=torch.bool).contiguous()
    return torch.as_tensor(np.asarray(free_mask, bool),
                           device=device).contiguous()


class GridSSSPResult(NamedTuple):
    dist: torch.Tensor       # int32[H, W]; INF32 = unreachable/blocked
    outer_iters: int
    inner_iters: int


def _solve_grid(free: torch.Tensor, source_rc, cfg: GridDeltaConfig):
    if cfg.backend not in ("pallas", "ref"):
        raise ValueError(f"unknown backend {cfg.backend!r}")
    delta = cfg.delta

    def sweep(tent, i, light):
        return grid_relax(tent, free, i, delta=delta,
                          cost_straight=cfg.cost_straight,
                          cost_diag=cfg.cost_diag, light=light)

    r0, c0 = source_rc
    tent = torch.full(free.shape, _INF, dtype=torch.int32,
                      device=free.device)
    tent[r0, c0] = 0
    tent = torch.where(free, tent, _INF)
    i, outer, inner = 0, 0, 0
    while True:                   # outer_cond (i < IMAX) holds for i = 0
        changed = True
        while changed:
            new = sweep(tent, i, True)
            changed = bool((new != tent).any())
            tent = new
            inner += 1
        tent = sweep(tent, i, False)          # heavy pass from B_i
        b = torch.where(tent < _INF, tent // delta, _IMAX)
        i = int(torch.where(b > i, b, _IMAX).min())
        outer += 1
        if i >= _IMAX:
            break
    return tent, outer, inner


class GridDeltaSolver:
    """Standalone grid driver. ``device=None`` means CUDA, as for
    ``Engine``; ``device="cpu"`` runs the twin."""

    def __init__(self, free_mask, cfg: GridDeltaConfig = GridDeltaConfig(),
                 *, device=None):
        self.free = free_mask_tensor(free_mask, resolve_device(device))
        self.cfg = cfg

    def solve(self, source_rc: Tuple[int, int]) -> GridSSSPResult:
        return GridSSSPResult(*_solve_grid(self.free, source_rc, self.cfg))


__all__ = ["GridDeltaConfig", "GridDeltaSolver", "GridSSSPResult",
           "free_mask_tensor"]
