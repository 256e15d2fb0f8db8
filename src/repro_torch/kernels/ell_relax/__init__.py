from repro_torch.kernels.ell_relax.ell_relax import ell_relax_cuda
from repro_torch.kernels.ell_relax.ops import ell_relax
from repro_torch.kernels.ell_relax.ref import ell_relax_ref

__all__ = ["ell_relax", "ell_relax_cuda", "ell_relax_ref"]
