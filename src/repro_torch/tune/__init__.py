"""Tuning subsystem of the PyTorch port. Only the estimator is ported
(the landmark store keys on its fingerprint); the measured search and
the tuning cache are ROADMAP Queue 1 item 2."""
from repro_torch.tune.estimator import (
    DEFAULT_DELTA,
    DELTA_C,
    GraphStats,
    estimate_delta,
    fingerprint,
    graph_stats,
)

__all__ = [
    "DEFAULT_DELTA",
    "DELTA_C",
    "GraphStats",
    "estimate_delta",
    "fingerprint",
    "graph_stats",
]
