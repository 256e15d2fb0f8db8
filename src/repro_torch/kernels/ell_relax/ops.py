"""Dispatcher of ``ell_relax``: a CPU tensor goes to the plain twin, a
CUDA tensor to the hand-written kernel (no fallback)."""
from __future__ import annotations

from repro_torch.kernels.ell_relax.ell_relax import ell_relax_cuda
from repro_torch.kernels.ell_relax.ref import ell_relax_ref


def ell_relax(fidx, dist, w_ell):
    """Relaxation candidates for a compacted frontier.

    fidx: int32[cap] frontier vertex ids (n = padding sentinel).
    dist: int32[n] tentative distances.
    w_ell: int32[n+1, D] ELL weights (row n all-INF).
    Returns int32[cap, D] candidate distances (INF where invalid).

    The reference's two kernel entries (blocked and row gather) compute
    this one function; the port has one CUDA kernel for both."""
    if dist.device.type == "cpu":
        return ell_relax_ref(fidx, dist, w_ell)
    return ell_relax_cuda(fidx, dist, w_ell)
