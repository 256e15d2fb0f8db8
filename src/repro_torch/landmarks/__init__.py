"""Goal-directed (point-to-point) query subsystem of the PyTorch port
(counterpart of ``repro.landmarks``): landmark tables, ALT potentials,
bidirectional Δ-stepping (DESIGN.md §14).

Consumed through the Plan façade (``api.PointToPoint(mode=...)``,
``Plan.prepare_landmarks``); everything here is also usable directly.
"""
from repro_torch.landmarks.alt import (
    LANDMARK_MODES,
    LandmarkSpec,
    LandmarkState,
    P2PSolve,
    POTENTIAL_CLIP,
    potentials,
    reduce_forward,
    reduce_union,
    require_canonical,
)
from repro_torch.landmarks.store import LandmarkStore
from repro_torch.landmarks.tables import (
    LandmarkTables,
    SELECT_STRATEGIES,
    build_tables,
    graph_whash,
    select_landmarks,
)

__all__ = [
    "LANDMARK_MODES",
    "LandmarkSpec",
    "LandmarkState",
    "LandmarkStore",
    "LandmarkTables",
    "P2PSolve",
    "POTENTIAL_CLIP",
    "SELECT_STRATEGIES",
    "build_tables",
    "graph_whash",
    "potentials",
    "reduce_forward",
    "reduce_union",
    "require_canonical",
    "select_landmarks",
]
