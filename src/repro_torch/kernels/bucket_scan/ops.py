"""Dispatcher of ``bucket_scan``: a CPU tensor goes to the plain twin, a
CUDA tensor to the hand-written kernel (which raises on anything it
does not take — there is no fallback)."""
from __future__ import annotations

from repro_torch.kernels.bucket_scan.bucket_scan import bucket_scan_cuda
from repro_torch.kernels.bucket_scan.ref import bucket_scan_ref


def bucket_scan(tent, explored, bucket_i, *, delta: int):
    """Fused frontier mask + frontier-any + next-bucket scan.

    tent, explored: int32[n]. Returns (frontier bool[n], any bool,
    next_bucket int32), as tensors on the input's device."""
    if tent.device.type == "cpu":
        return bucket_scan_ref(tent, explored, bucket_i, delta=delta)
    return bucket_scan_cuda(tent, explored, bucket_i, delta=delta)
