"""Bellman-Ford over the occupancy grid: every round takes, for every
free cell, the least of its own distance and each of its 8 neighbours'
plus the move's cost (an obstacle keeps no finite distance, so a move
to or from one never counts), until a round changes nothing. The same
graph as the COO of ``generators/grid_map.py``, without its edge list,
so that a 9 M-cell map solves in about a second on the card."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

INF = 2**31 - 1
_BIG = 2**30          # unreachable inside the loop: _BIG + cost stays int32
_CHECK_EVERY = 32     # rounds between reads of the change flag


class Solved(NamedTuple):
    dist: torch.Tensor                 # int32[n], INF where unreachable
    rounds: int                        # rounds that changed some value
    changed_at: Optional[torch.Tensor]  # int32[n]: last round that changed it


def solve(inst, source: int, max_rounds: Optional[int] = None,
          track: bool = False) -> Solved:
    """Exact distances from ``source``; ``max_rounds`` stops early (the
    control's truncated answer), ``track`` records in which round each
    cell last changed."""
    free = inst.free
    straight, diag = inst.costs
    h, w = free.shape
    dev = free.device
    pad = torch.full((h + 2, w + 2), _BIG, dtype=torch.int32, device=dev)
    pad[1 + source // w, 1 + source % w] = 0
    inner = pad[1:-1, 1:-1]
    blocked = ~free
    last = torch.zeros((h, w), dtype=torch.int32, device=dev) if track \
        else None
    n_changed = torch.zeros((), dtype=torch.int64, device=dev)
    r = 0
    while max_rounds is None or r < max_rounds:
        st = torch.minimum(torch.minimum(pad[:-2, 1:-1], pad[2:, 1:-1]),
                           torch.minimum(pad[1:-1, :-2], pad[1:-1, 2:]))
        st += straight
        dg = torch.minimum(torch.minimum(pad[:-2, :-2], pad[:-2, 2:]),
                           torch.minimum(pad[2:, :-2], pad[2:, 2:]))
        dg += diag
        new = torch.minimum(torch.minimum(st, dg), inner)
        new.masked_fill_(blocked, _BIG)
        new[source // w, source % w] = 0
        changed = new != inner
        any_ = changed.any()
        n_changed += any_
        r += 1
        if track:
            last = torch.where(changed, r, last)
        inner.copy_(new)
        if r % _CHECK_EVERY == 0 and not bool(any_):
            break
    dist = torch.where(inner >= _BIG, INF, inner).reshape(-1)
    return Solved(dist, int(n_changed), None if last is None
                  else last.reshape(-1))
