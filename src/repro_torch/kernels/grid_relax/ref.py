"""Plain PyTorch twin of ``grid_relax`` (counterpart of
``repro.kernels.grid_relax.ref``)."""
from __future__ import annotations

import torch

_INF = 2**31 - 1


def _neighbor(tent: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """tent value of the (dr, dc) neighbour, INF past the grid edge."""
    v = tent
    if dr == -1:
        v = torch.cat([v.new_full((1, v.shape[1]), _INF), v[:-1]], dim=0)
    elif dr == 1:
        v = torch.cat([v[1:], v.new_full((1, v.shape[1]), _INF)], dim=0)
    if dc == -1:
        v = torch.cat([v.new_full((v.shape[0], 1), _INF), v[:, :-1]], dim=1)
    elif dc == 1:
        v = torch.cat([v[:, 1:], v.new_full((v.shape[0], 1), _INF)], dim=1)
    return v


def phase_moves(delta: int, cost_straight: int, cost_diag: int,
                light: bool):
    """The phase's move classes: a class is relaxed in the light phase
    iff its cost is <= Δ (paper Alg. 1 lines 3-5). Returns
    ``(straight_on, diag_on)``."""
    return ((cost_straight <= delta) == light,
            (cost_diag <= delta) == light)


def grid_relax_ref(tent: torch.Tensor, free: torch.Tensor, bucket_i, *,
                   delta: int, cost_straight: int, cost_diag: int,
                   light: bool) -> torch.Tensor:
    """One masked min-plus sweep: tent int32[H, W], free bool[H, W] →
    int32[H, W]. The add wraps like int32 on the TPU."""
    straight, diag = phase_moves(delta, cost_straight, cost_diag, light)
    moves = []
    if straight:
        moves += [(-1, 0, cost_straight), (1, 0, cost_straight),
                  (0, -1, cost_straight), (0, 1, cost_straight)]
    if diag:
        moves += [(-1, -1, cost_diag), (-1, 1, cost_diag),
                  (1, -1, cost_diag), (1, 1, cost_diag)]
    best = torch.full_like(tent, _INF)
    for dr, dc, cost in moves:
        v = _neighbor(tent, dr, dc)
        f = (v < _INF) & (v // delta == bucket_i)
        cand = torch.where(f, v, 0) + cost
        best = torch.minimum(best, torch.where(f, cand, _INF))
    return torch.where(free, torch.minimum(tent, best), _INF)
