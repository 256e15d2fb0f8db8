"""The predecessor tree and the paths the configurations state, from
the reference's own distances and the benchmark's COO."""
from __future__ import annotations

import torch

INF = 2**31 - 1
_IMAX = 2**31 - 1


def argmin_pred(inst, dist: torch.Tensor, source: int) -> torch.Tensor:
    """For every reachable vertex the smallest id ``u`` of an edge
    ``(u, v, w)`` with ``dist[u] + w == dist[v]``; -1 at the source and
    where unreachable (``pred_mode='argmin'``)."""
    du = dist[inst.src.long()]
    dv = dist[inst.dst.long()]
    fin = (du < INF) & (dv < INF)
    tight = fin & (torch.where(fin, du, 0) + inst.w == dv)
    p = torch.full((inst.n,), _IMAX, dtype=torch.int32, device=dist.device)
    p.scatter_reduce_(0, inst.dst.long()[tight], inst.src[tight], "amin")
    pred = torch.where(p < _IMAX, p, -1).to(torch.int32)
    pred[source] = -1
    return pred


class EdgeTable:
    """The least weight of each (tail, head) pair of the COO, sorted by
    ``tail * n + head``, to look up the steps of a path."""

    def __init__(self, inst):
        self.n = inst.n
        key = inst.src.long() * inst.n + inst.dst.long()
        w, order = torch.sort(inst.w.long(), stable=True)
        key = key[order]
        key, order = torch.sort(key, stable=True)
        w = w[order]
        first = torch.ones_like(key, dtype=torch.bool)
        first[1:] = key[1:] != key[:-1]
        self.key, self.w = key[first], w[first]

    def path_length(self, path) -> int | None:
        """The summed least weights of the path's steps, or None where a
        step is no edge of the graph."""
        p = torch.as_tensor(path, dtype=torch.int64, device=self.key.device)
        if p.numel() < 2:
            return 0
        k = p[:-1] * self.n + p[1:]
        idx = torch.searchsorted(self.key, k).clamp(max=self.key.numel() - 1)
        if not bool((self.key[idx] == k).all()):
            return None
        return int(self.w[idx].sum())


def path_is_shortest(table: EdgeTable, path, source: int, target: int,
                     distance: int) -> bool:
    """``path`` runs from ``source`` to ``target`` over edges of the
    graph and its weights sum to ``distance`` (the reference's); an
    unreachable target has no path."""
    if distance >= INF:
        return path is None
    if path is None or len(path) == 0:
        return False
    if int(path[0]) != source or int(path[-1]) != target:
        return False
    return table.path_length(path) == distance
