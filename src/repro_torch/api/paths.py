"""Host-side path recovery from predecessor arrays (counterpart of
``repro.api.paths``; ``stitch_bidirectional_path`` comes with the
landmark modes, ROADMAP Queue 1 item 10).

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


__all__ = ["extract_path"]
