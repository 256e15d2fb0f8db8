"""The one generator of queries. A traffic mix is a data file
(``traffic/<mix>.json``) of parameters that this module reads:

* ``query``: ``single_source`` or ``point_to_point`` (then ``mode``, the
  port's point-to-point mode);
* ``draw``: how endpoints are drawn —
  ``uniform``: a source uniform over the vertices (over the free cells
  of a game map);
  ``anchors``: sources in rotation over fixed strata, each a box of
  ``box`` x ``box`` cells around an anchor given as fractions of the
  map's height and width, a free cell uniform in the box;
  ``octile_bands``: pairs in rotation over bands of octile distance
  (the obstacle-free 8-neighbour cost, ``costs`` straight and
  diagonal), a free source uniform over the map and a free target at a
  distance uniform in the band, in a direction uniform over the
  octants.

``trace_queries`` is how many of the window's first queries a traced run
profiles.

Every stream is a function of the seed alone: stream 0 is the window's
queries, stream 1 the warm-up's (stream 2 draws the sample of answers
compared with the reference), so two runs of one seed ask the same
queries in the same order, and rotations give every seed the same mix.
"""
from __future__ import annotations

from itertools import count
from typing import Iterator, NamedTuple, Optional

import numpy as np

WINDOW, WARMUP, SAMPLE = 0, 1, 2
_BATCH = 1024


class Query(NamedTuple):
    kind: str                 # "single_source" | "point_to_point"
    source: int
    target: Optional[int] = None
    mode: Optional[str] = None


def rng_of(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**64, stream])


def stream(mix: dict, n: int, free: Optional[np.ndarray], seed: int,
           which: int) -> Iterator[Query]:
    """The endless query stream ``which`` of ``mix`` on an instance of
    ``n`` vertices (``free``: the host occupancy grid of a game map).
    The free cells are listed here, before the first query is drawn, so
    that each draw costs the host a fraction of a millisecond."""
    rng = rng_of(seed, which)
    kind = mix["query"]
    cells = None if free is None else np.flatnonzero(free.ravel())
    if kind == "single_source":
        pick = {"uniform": _uniform, "anchors": _anchors}[mix["draw"]]
        return (Query(kind, pick(rng, i, mix, n, free, cells))
                for i in count())
    if kind == "point_to_point":
        pick = {"octile_bands": _octile_pair}[mix["draw"]]
        mode = mix.get("mode", "early_exit")
        return (Query(kind, *pick(rng, i, mix, n, free, cells), mode)
                for i in count())
    raise ValueError(f"unknown query kind {kind!r}")


def _uniform(rng, i, mix, n, free, cells) -> int:
    if cells is None:
        return int(rng.integers(0, n))
    return int(cells[rng.integers(0, cells.shape[0])])


def _anchors(rng, i, mix, n, free, cells) -> int:
    h, w = free.shape
    fr, fc = mix["anchors"][i % len(mix["anchors"])]
    half = min(int(mix["box"]) // 2, (h - 1) // 2, (w - 1) // 2)
    r0 = min(max(int(round(fr * (h - 1))) - half, 0), h - 2 * half - 1)
    c0 = min(max(int(round(fc * (w - 1))) - half, 0), w - 2 * half - 1)
    box = free[r0:r0 + 2 * half + 1, c0:c0 + 2 * half + 1]
    inbox = np.flatnonzero(box.ravel())
    if inbox.shape[0] == 0:
        raise ValueError(f"anchor box at ({r0}, {c0}) holds no free cell")
    k = int(inbox[rng.integers(0, inbox.shape[0])])
    return (r0 + k // box.shape[1]) * w + c0 + k % box.shape[1]


def octile(dr, dc, straight: int, diag: int):
    """The obstacle-free cost of a move of ``(dr, dc)`` cells."""
    a, b = np.abs(dr), np.abs(dc)
    return straight * np.maximum(a, b) + (diag - straight) * np.minimum(a, b)


def _octile_pair(rng, i, mix, n, free, cells) -> tuple[int, int]:
    h, w = free.shape
    straight, diag = mix["costs"]
    lo, hi = mix["bands"][i % len(mix["bands"])]
    for _ in range(1000):
        s = cells[rng.integers(0, cells.shape[0], _BATCH)]
        dist = rng.uniform(lo, hi, _BATCH)
        q = rng.uniform(0.0, 1.0, _BATCH)       # minor / major axis
        major = dist / (straight + (diag - straight) * q)
        a = np.rint(major).astype(np.int64)
        b = np.rint(q * major).astype(np.int64)
        swap = rng.random(_BATCH) < 0.5
        dr, dc = np.where(swap, b, a), np.where(swap, a, b)
        dr = np.where(rng.random(_BATCH) < 0.5, -dr, dr)
        dc = np.where(rng.random(_BATCH) < 0.5, -dc, dc)
        r, c = s // w + dr, s % w + dc
        inside = (r >= 0) & (r < h) & (c >= 0) & (c < w)
        r, c = np.where(inside, r, 0), np.where(inside, c, 0)
        d = octile(dr, dc, straight, diag)
        ok = inside & free[r, c] & (d >= lo) & (d < hi) & ((dr != 0) |
                                                          (dc != 0))
        hit = np.flatnonzero(ok)
        if hit.shape[0]:
            k = hit[0]
            return int(s[k]), int(r[k] * w + c[k])
    raise ValueError(f"no free pair found in octile band [{lo}, {hi})")
