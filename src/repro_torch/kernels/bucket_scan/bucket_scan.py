"""Launcher of the CUDA ``bucket_scan`` kernel (``csrc/bucket_scan.cu``),
the Hopper counterpart of the TPU kernel
``src/repro/kernels/bucket_scan/bucket_scan.py: bucket_scan_kernel``.

Bound on the H100 by bytes (8 read + 1 written per vertex); the source
note in ``bucket_scan.cu`` gives the design. ``bucket_scan_cuda.launches``
counts the launches of this process.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_IMAX = 2**31 - 1


def bucket_scan_cuda(tent: torch.Tensor, explored: torch.Tensor, bucket_i,
                     *, delta: int):
    """tent/explored int32[n] on one CUDA device → (frontier bool[n],
    any bool, next int32), all on the device; no synchronisation."""
    dev = tent.device
    _build.require_cuda_int32("tent", tent, dev, 1)
    _build.require_cuda_int32("explored", explored, dev, 1)
    n = tent.shape[0]
    if explored.shape[0] != n:
        raise ValueError("tent and explored differ in length")
    lib = _build.load().lib
    frontier = torch.empty(n, dtype=torch.bool, device=dev)
    any_ = torch.full((1,), 0, dtype=torch.int32, device=dev)
    nxt = torch.full((1,), _IMAX, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.bucket_scan_launch(
            tent.data_ptr(), explored.data_ptr(), n, int(bucket_i), int(delta),
            frontier.data_ptr(), any_.data_ptr(), nxt.data_ptr(),
            _build.stream_of(dev))
    _build.check(err, "bucket_scan")
    bucket_scan_cuda.launches += 1
    return frontier, any_[0] != 0, nxt[0]


bucket_scan_cuda.launches = 0
