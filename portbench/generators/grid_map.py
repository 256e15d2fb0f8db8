"""Game-map occupancy grid, drawn on the device from the seed.

The arithmetic of the port's ``graphs.generators.grid_map``: a cell is
an obstacle with probability ``obstacle_frac``; vertex id ``r * W + c``;
one directed edge for each of the 8 moves between two free cells,
``straight_cost`` straight and ``diag_cost`` diagonal, in the port's
move order. A ``torch.Generator`` on the run's device stands in for
numpy's.
"""
from __future__ import annotations

import torch

from pbcore.instance import Instance


def moves(straight: int, diag: int):
    return [(-1, 0, straight), (1, 0, straight), (0, -1, straight),
            (0, 1, straight), (-1, -1, diag), (-1, 1, diag), (1, -1, diag),
            (1, 1, diag)]


def make(params: dict, seed: int, device: torch.device) -> Instance:
    h, w_ = int(params["height"]), int(params["width"])
    straight, diag = int(params["straight_cost"]), int(params["diag_cost"])
    gen = torch.Generator(device=device).manual_seed(seed)
    free = torch.rand((h, w_), generator=gen, device=device) >= float(
        params["obstacle_frac"])
    idx = torch.arange(h * w_, dtype=torch.int32, device=device).view(h, w_)
    srcs, dsts, ws = [], [], []
    for dr, dc, cost in moves(straight, diag):
        rs = slice(max(0, -dr), h - max(0, dr))
        cs = slice(max(0, -dc), w_ - max(0, dc))
        rs2 = slice(max(0, dr), h + min(0, dr))
        cs2 = slice(max(0, dc), w_ + min(0, dc))
        ok = free[rs, cs] & free[rs2, cs2]
        srcs.append(idx[rs, cs][ok])
        dsts.append(idx[rs2, cs2][ok])
        ws.append(torch.full((srcs[-1].shape[0],), cost, dtype=torch.int32,
                             device=device))
    return Instance(h * w_, torch.cat(srcs), torch.cat(dsts), torch.cat(ws),
                    free=free, costs=(straight, diag))
