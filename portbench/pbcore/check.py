"""Whether what the timed path produced is correct: the sampled answers
against the plain reference, each number beside its limit.

The configurations state exact answers, so every number counts what is
wrong and every limit is 0:

* ``dist_wrong``: vertices whose distance differs from the reference's,
  summed over the sampled single-source answers;
* ``pred_wrong``: vertices whose predecessor differs from the
  reference's smallest-id tight parent (``pred_mode='argmin'``);
* ``distance_gap``: the widest gap between a sampled point-to-point
  distance and the reference's;
* ``path_bad``: sampled point-to-point answers whose path is not a
  shortest path of the graph from the source to the target.
"""
from __future__ import annotations

LIMITS = {"dist_wrong": 0, "pred_wrong": 0, "distance_gap": 0,
          "path_bad": 0}


def compare(kind: str, solver, tree, inst, samples) -> dict:
    """The numbers compared for ``samples``: ``(query, dist, pred)`` of
    single-source answers or ``(query, distance, path)`` of
    point-to-point ones, solved again by the reference ``solver``."""
    if kind == "single_source":
        dist_wrong = pred_wrong = 0
        for q, dist, pred in samples:
            ref = solver.solve(inst, q.source).dist
            ref_pred = tree.argmin_pred(inst, ref, q.source)
            dist_wrong += _wrong(dist, ref, inst.n)
            pred_wrong += _wrong(pred, ref_pred, inst.n)
        return {"dist_wrong": dist_wrong, "pred_wrong": pred_wrong}
    table = tree.EdgeTable(inst)
    gap = bad = 0
    for q, distance, path in samples:
        d = int(solver.solve(inst, q.source).dist[q.target])
        gap = max(gap, abs(int(distance) - d))
        bad += not tree.path_is_shortest(table, path, q.source, q.target, d)
    return {"distance_gap": gap, "path_bad": bad}


def _wrong(got, ref, n: int) -> int:
    if tuple(got.shape) != tuple(ref.shape):
        return n
    return int((got.to(ref.device) != ref).sum())


def verdict(compared: dict) -> bool:
    return all(v <= LIMITS[k] for k, v in compared.items())
