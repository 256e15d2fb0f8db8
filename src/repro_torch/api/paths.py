"""Host-side path recovery from predecessor arrays (counterpart of
``repro.api.paths``).

Walk the predecessor chain target -> source, bounded by ``n_nodes``
hops: a chain that does not reach the source within n hops is either an
unreachable target or an off-tree cycle (``pred_mode='argmin'`` on a
zero-weight tie) and yields ``None`` instead of looping forever.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


def extract_path(pred: np.ndarray, source: int, target: int,
                 n_nodes: int) -> Optional[List[int]]:
    """Source->target vertex list from a predecessor array, or ``None``
    when the chain does not reach the source.

    >>> import numpy as np
    >>> pred = np.array([-1, 0, 1, -1], np.int32)   # tree 0 -> 1 -> 2
    >>> extract_path(pred, 0, 2, 4)
    [0, 1, 2]
    >>> extract_path(pred, 0, 0, 4)                 # source == target
    [0]
    >>> extract_path(pred, 0, 3, 4) is None         # unreachable target
    True
    """
    source, target = int(source), int(target)
    path = [target]
    for _ in range(n_nodes):
        if path[-1] == source:
            return path[::-1]
        p = int(pred[path[-1]])
        if p < 0:
            return None
        path.append(p)
    return path[::-1] if path[-1] == source else None


def stitch_bidirectional_path(
    pred_f: np.ndarray,
    pred_b: np.ndarray,
    source: int,
    target: int,
    meet: int,
    n_nodes: int,
) -> Optional[List[int]]:
    """Full source->target path through the meeting vertex of a
    bidirectional solve (``repro_torch.landmarks``, DESIGN.md §14).
    ``pred_f`` is a forward shortest-path tree rooted at ``source`` on
    the original graph; ``pred_b`` a tree rooted at ``target`` on the
    REVERSED graph, so its root-ward walk from ``meet`` traverses an
    original-direction meet->target path. Both legs go through the same
    cycle-guarded :func:`extract_path`; either leg failing yields
    ``None``.

    >>> import numpy as np
    >>> pf = np.array([-1, 0, 1, -1], np.int32)     # 0 -> 1 -> 2
    >>> pb = np.array([-1, -1, 3, -1], np.int32)    # reversed tree: 3 -> 2
    >>> stitch_bidirectional_path(pf, pb, 0, 3, 2, 4)
    [0, 1, 2, 3]
    >>> stitch_bidirectional_path(pf, pb, 0, 3, 0, 4) is None
    True
    """
    fwd = extract_path(pred_f, source, meet, n_nodes)
    bwd = extract_path(pred_b, target, meet, n_nodes)
    if fwd is None or bwd is None:
        return None
    return fwd + bwd[::-1][1:]


__all__ = ["extract_path", "stitch_bidirectional_path"]
