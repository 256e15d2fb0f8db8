from repro_torch.kernels.grid_relax.grid_relax import grid_relax_cuda
from repro_torch.kernels.grid_relax.ops import grid_relax
from repro_torch.kernels.grid_relax.ref import grid_relax_ref

__all__ = ["grid_relax", "grid_relax_cuda", "grid_relax_ref"]
