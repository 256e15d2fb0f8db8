"""Bellman-Ford over the COO edge list: every round relaxes every edge
(a gather of the tails' distances and a scatter-min into the heads),
until a round changes nothing."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

INF = 2**31 - 1


class Solved(NamedTuple):
    dist: torch.Tensor                 # int32[n], INF where unreachable
    rounds: int                        # rounds that changed some value
    changed_at: Optional[torch.Tensor]  # int32[n]: last round that changed it


def solve(inst, source: int, max_rounds: Optional[int] = None,
          track: bool = False) -> Solved:
    """Exact distances from ``source``; ``max_rounds`` stops early (the
    control's truncated answer), ``track`` records in which round each
    vertex last changed."""
    dev = inst.src.device
    src, dst, w = inst.src.long(), inst.dst.long(), inst.w
    d = torch.full((inst.n,), INF, dtype=torch.int32, device=dev)
    d[source] = 0
    last = torch.zeros_like(d) if track else None
    rounds = 0
    while max_rounds is None or rounds < max_rounds:
        du = d[src]
        fin = du < INF
        cand = torch.where(fin, torch.where(fin, du, 0) + w, INF)
        nd = d.scatter_reduce(0, dst, cand, "amin", include_self=True)
        changed = nd != d
        if not bool(changed.any()):
            break
        rounds += 1
        if track:
            last = torch.where(changed, rounds, last)
        d = nd
    return Solved(d, rounds, last)
