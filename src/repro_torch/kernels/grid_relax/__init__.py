from repro_torch.kernels.grid_relax.grid_relax import (bucket_range,
                                                       grid_relax_cuda,
                                                       vector_path)
from repro_torch.kernels.grid_relax.ops import grid_relax
from repro_torch.kernels.grid_relax.ref import grid_relax_ref

__all__ = ["bucket_range", "grid_relax", "grid_relax_cuda", "grid_relax_ref",
           "vector_path"]
