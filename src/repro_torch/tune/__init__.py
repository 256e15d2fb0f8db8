"""Auto-tuning subsystem of the PyTorch port (counterpart of
``repro.tune``, DESIGN.md §7). Three layers:

* ``estimator`` — zero-measurement heuristic: graph statistics → Δ,
  and the fingerprint (with the device term) that keys the cache and
  the landmark store.
* ``search`` — the measured (Δ, strategy, frontier cap, policy) search
  with successive-halving pruning, returning a ``TuningRecord``, and
  ``tune_p2p``'s point-to-point mode search.
* ``cache`` — the persistent JSON store of ``TuningRecord``s, in the
  reference's schema.

``resolve_record`` is the one resolution point ``Engine(...,
tuning=...)`` consults (and, through it, the deprecated solver shims,
``make_backend(g, "auto")``, the launchers and ``serve.Server``); it
returns the concrete config and the record it came from.
``resolve_config`` is the config-only wrapper.
"""
from repro_torch.tune.cache import TuningCache
from repro_torch.tune.estimator import (
    DEFAULT_DELTA,
    DELTA_C,
    GraphStats,
    estimate_delta,
    fingerprint,
    graph_stats,
)
from repro_torch.tune.search import (
    TuningRecord,
    build_safe_solver,
    candidate_configs,
    default_policies,
    default_strategies,
    heuristic_record,
    resolve_config,
    resolve_record,
    tune,
    tune_p2p,
)

__all__ = [
    "DEFAULT_DELTA",
    "DELTA_C",
    "GraphStats",
    "TuningCache",
    "TuningRecord",
    "build_safe_solver",
    "candidate_configs",
    "default_policies",
    "default_strategies",
    "estimate_delta",
    "fingerprint",
    "graph_stats",
    "heuristic_record",
    "resolve_config",
    "resolve_record",
    "tune",
    "tune_p2p",
]
