from repro_torch.kernels.frontier_relax.frontier_relax import (
    frontier_relax_cuda,
)
from repro_torch.kernels.frontier_relax.ops import frontier_relax
from repro_torch.kernels.frontier_relax.ref import (
    compact_ref,
    frontier_relax_ref,
)

__all__ = ["compact_ref", "frontier_relax", "frontier_relax_cuda",
           "frontier_relax_ref"]
