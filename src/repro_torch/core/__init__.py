"""Core of the PyTorch port: the Δ-stepping engine, its backends (the
sharded ones over ``torch.distributed``), the distributed engine
(``core.distributed``), the standalone game-map grid solver, the
value-word packing and the host oracles."""
from repro_torch.core.backends import (
    EdgeBackend,
    EllBackend,
    FusedBackend,
    GridPallasBackend,
    PallasEllBackend,
    RelaxBackend,
    ShardedEdgeBackend,
    ShardedEllBackend,
    ShardedFusedBackend,
    edge_sweep,
    make_backend,
    resolve_n_shards,
    scan_bucket,
)
from repro_torch.core.delta_stepping import (
    P2P_MODES,
    POLICIES,
    DeltaConfig,
    DeltaSteppingSolver,
    SSSPResult,
    delta_stepping,
    pred_argmin,
)
from repro_torch.core.policies import (
    DeltaPolicy,
    RadiiStore,
    RadiusPolicy,
    RhoPolicy,
    compute_radii,
    make_policy,
)
from repro_torch.core.grid import (
    GridDeltaConfig,
    GridDeltaSolver,
    GridSSSPResult,
)
from repro_torch.core.ref import (
    bellman_ford,
    dijkstra,
    validate_pred_tree,
    walk_pred_tree,
)

__all__ = [
    "P2P_MODES",
    "POLICIES",
    "DeltaConfig",
    "DeltaSteppingSolver",
    "SSSPResult",
    "delta_stepping",
    "DeltaPolicy",
    "RhoPolicy",
    "RadiusPolicy",
    "RadiiStore",
    "compute_radii",
    "make_policy",
    "edge_sweep",
    "pred_argmin",
    "RelaxBackend",
    "EdgeBackend",
    "EllBackend",
    "FusedBackend",
    "GridPallasBackend",
    "PallasEllBackend",
    "ShardedEdgeBackend",
    "ShardedEllBackend",
    "ShardedFusedBackend",
    "resolve_n_shards",
    "GridDeltaConfig",
    "GridDeltaSolver",
    "GridSSSPResult",
    "make_backend",
    "scan_bucket",
    "dijkstra",
    "bellman_ford",
    "validate_pred_tree",
    "walk_pred_tree",
]
