"""Query/Plan façade of the PyTorch port.

    from repro_torch.api import (BoundedRadius, Engine, PointToPoint,
                                 SingleSource)
    from repro_torch.core import DeltaConfig
    from repro_torch.graphs import grid_map

    plan = Engine(graph, DeltaConfig(delta=10, strategy="fused")).plan()
    res = plan.solve(SingleSource(0))     # dist/pred + telemetry, on CUDA

    # game maps: the grid stencil, and the queries a game asks
    g, free = grid_map(300, 300, 0.1, seed=0)
    plan = Engine(g, DeltaConfig(delta=13, strategy="pallas"),
                  free_mask=free).plan()
    plan.solve(PointToPoint(0, g.n_nodes - 1)).path
    plan.solve(BoundedRadius(0, 1000)).dist

    # goal-directed point to point: landmark tables, then ALT and/or
    # bidirectional search (same distance as early exit)
    plan.prepare_landmarks(k=4)
    plan.solve(PointToPoint(0, g.n_nodes - 1, mode="alt_bidirectional"))
"""
from repro_torch.api.engine import Engine, LandmarkRefused, Plan, UpdateRefused
from repro_torch.api.paths import extract_path, stitch_bidirectional_path
from repro_torch.api.queries import (
    BoundedRadius,
    BoundedRadiusResult,
    ManyToMany,
    ManyToManyResult,
    MultiSource,
    MultiSourceResult,
    PointToPoint,
    PointToPointResult,
    Query,
    Result,
    SingleSource,
    SingleSourceResult,
    Telemetry,
    UpdateBatch,
)

__all__ = [
    "BoundedRadius",
    "BoundedRadiusResult",
    "Engine",
    "LandmarkRefused",
    "ManyToMany",
    "ManyToManyResult",
    "MultiSource",
    "MultiSourceResult",
    "Plan",
    "PointToPoint",
    "PointToPointResult",
    "Query",
    "Result",
    "SingleSource",
    "SingleSourceResult",
    "Telemetry",
    "UpdateBatch",
    "UpdateRefused",
    "extract_path",
    "stitch_bidirectional_path",
]
