"""Weight-update application for dynamic graphs (counterpart of
``repro.dynamic.update``).

Topology is immutable (the game-map/traffic workload changes edge
*costs*, not the road network), so an update batch is a pure function
``COOGraph -> COOGraph`` swapping entries of the weight array. The new
graph shares ``src``/``dst`` with the old one and holds a new ``w``
tensor: the old tensor is never written, because a plan's resident
snapshot (and its overflow twin) still hold it and diff against it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.graphs.structures import COOGraph, INF32


def apply_weight_update(graph: COOGraph, edge_ids, new_weights) -> COOGraph:
    """New ``COOGraph`` with ``w[edge_ids] = new_weights``, on the
    graph's device.

    Validated on the host, as the reference does: out-of-range ids or
    negative/INF weights would otherwise corrupt the engine's
    non-negative int32 invariant. Duplicate ids within one batch
    resolve last-wins (the reference's numpy fancy-assignment order);
    the write itself goes through the last occurrence of each id only,
    since a device scatter with repeated indices has no defined order.
    """
    ids = np.asarray(edge_ids, dtype=np.int64).ravel()
    w_new = np.asarray(new_weights, dtype=np.int64).ravel()
    if ids.shape != w_new.shape:
        raise ValueError(
            f"edge_ids and new_weights disagree: {ids.shape} vs {w_new.shape}"
        )
    m = graph.n_edges
    if ids.size:
        if int(ids.min()) < 0 or int(ids.max()) >= m:
            raise ValueError(f"edge_ids out of range for a {m}-edge graph")
        if int(w_new.min()) < 0 or int(w_new.max()) >= int(INF32):
            raise ValueError("new_weights must be non-negative int32 below INF32")
    # last occurrence of each id: the first one in the reversed batch
    _, first = np.unique(ids[::-1], return_index=True)
    last = ids.size - 1 - first
    w = graph.w.clone()
    dev = w.device
    w[torch.from_numpy(ids[last]).to(dev)] = torch.from_numpy(
        w_new[last].astype(np.int32)).to(dev)
    return COOGraph(graph.src, graph.dst, w, graph.n_nodes)


__all__ = ["apply_weight_update"]
