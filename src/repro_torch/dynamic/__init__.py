"""Dynamic-graph update subsystem of the PyTorch port: warm-start
re-solves after edge-cost changes (counterpart of ``repro.dynamic``,
DESIGN.md §11).

    plan = Engine(graph, config).plan()
    plan.solve(SingleSource(0))            # establishes residency
    plan.update(edge_ids, new_weights)     # swap weights, keep topology
    res = plan.resolve(warm=True)          # bounded repair, not a re-solve

``update.apply_weight_update`` is the pure graph transform;
``repair.plan_repair`` diffs the plan's weights against the resident
snapshot and builds the warm ``(tent0, explored0)`` entry state of the
bucket loop. Warm results are bitwise identical to a cold solve of the
updated graph; updates outside the warm contract fall back to a cold
re-solve.
"""

from repro_torch.dynamic.repair import (
    RepairPlan,
    Resident,
    plan_repair,
    resident_words,
)
from repro_torch.dynamic.update import apply_weight_update

__all__ = [
    "RepairPlan",
    "Resident",
    "apply_weight_update",
    "plan_repair",
    "resident_words",
]
