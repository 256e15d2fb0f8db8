"""Dispatcher of ``frontier_relax``: a CPU tensor goes to the plain twin,
a CUDA tensor to the hand-written kernels (no fallback)."""
from __future__ import annotations

from repro_torch.kernels.frontier_relax.frontier_relax import (
    frontier_relax_cuda,
)
from repro_torch.kernels.frontier_relax.ref import frontier_relax_ref


def frontier_relax(dist, explored, bucket_i, nbr, w_ell, *, delta: int,
                   cap: int, base: int = 0, sent: int | None = None):
    """Fused frontier scan + compaction + ELL row gather of one bucket.

    dist/explored: int32[S]; nbr/w_ell: int32[S + 1, D] ELL block (row S
    all-sentinel). Returns ``(fidx int32[cap], rows_n int32[cap, D],
    rows_w int32[cap, D], count int32, any bool, next int32)`` with
    ``fidx`` in global ids (``base`` + local index; padding slots carry
    ``sent``, default S). ``count > cap`` is the caller's overflow flag.

    A zero-width ELL block (D == 0) runs the kernel too on CUDA: its
    scan and compaction still hold, and the row gather writes nothing."""
    if dist.device.type == "cpu":
        return frontier_relax_ref(dist, explored, bucket_i, nbr, w_ell,
                                  delta=delta, cap=cap, base=base, sent=sent)
    return frontier_relax_cuda(dist, explored, bucket_i, nbr, w_ell,
                               delta=delta, cap=cap, base=base, sent=sent)
