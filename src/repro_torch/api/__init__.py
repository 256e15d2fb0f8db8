"""Query/Plan façade of the PyTorch port.

    from repro_torch.api import Engine, SingleSource
    from repro_torch.core import DeltaConfig

    plan = Engine(graph, DeltaConfig(delta=10, strategy="fused")).plan()
    res = plan.solve(SingleSource(0))     # dist/pred + telemetry, on CUDA
"""
from repro_torch.api.engine import Engine, Plan
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
]
