"""Launcher of the CUDA ``bucket_scan`` kernel (``csrc/bucket_scan.cu``),
the Hopper counterpart of the TPU kernel
``src/repro/kernels/bucket_scan/bucket_scan.py: bucket_scan_kernel``.

Bound on the H100 by bytes (8 read + 1 written per vertex); the source
note in ``bucket_scan.cu`` gives the design. One call is one device
kernel: the launcher hands it the bucket as a range of values
(``scan_range``), so the kernel divides nothing per element, picks its
vector or scalar path (``scan_vector_path``), and keeps one scratch
buffer per (device, stream) for the kernel's cross-block reduction.
``bucket_scan_cuda.launches`` counts the launches of this process.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_INF = 2**31 - 1
_INT32_MIN = -(2**31)

# (device index, stream handle) -> the kernel's scratch (its ticket and
# two accumulators), all 0 between launches
_scratch: dict[tuple[int, int], torch.Tensor] = {}


def scan_range(bucket_i, delta: int) -> tuple[int, int]:
    """Bucket ``i`` as the half-open range of values ``[lo, hi)`` =
    ``[i * delta, (i + 1) * delta)``, computed in Python integers and
    clamped to ``[INT32_MIN, INF]``. For every int32 ``t`` and any
    integer ``i``, negative or with ``(i + 1) * delta`` past int32:
    ``t < INF and t // delta == i`` iff ``lo <= t < hi`` and ``t < INF``,
    and ``t // delta > i`` iff ``t >= hi``. Refuses a ``delta`` outside
    ``[1, INF]``."""
    i, d = int(bucket_i), int(delta)
    if not 1 <= d <= _INF:
        raise ValueError(f"delta must lie in [1, {_INF}], got {d}")
    return (min(max(i * d, _INT32_MIN), _INF),
            min(max((i + 1) * d, _INT32_MIN), _INF))


def scan_vector_path(tent: torch.Tensor, explored: torch.Tensor,
                     frontier: torch.Tensor) -> bool:
    """Whether the kernel may take its vector path (16-byte loads of
    ``tent``/``explored``, 4-byte stores of four flags, the ``n % 4``
    tail scalar): both inputs 16-byte aligned, ``frontier`` 4-byte
    aligned."""
    return (tent.data_ptr() % 16 == 0 and explored.data_ptr() % 16 == 0
            and frontier.data_ptr() % 4 == 0)


def _scratch_of(lib, device: torch.device, stream: int) -> int:
    key = (device.index, stream)
    buf = _scratch.get(key)
    if buf is None:
        buf = torch.zeros(lib.bucket_scan_scratch_ints(), dtype=torch.int32,
                          device=device)
        _scratch[key] = buf
    return buf.data_ptr()


def bucket_scan_cuda(tent: torch.Tensor, explored: torch.Tensor, bucket_i,
                     *, delta: int):
    """tent/explored int32[n] on one CUDA device → (frontier bool[n],
    any bool, next int32), all on the device; no synchronisation. Any
    int32 ``bucket_i`` and any int32 ``tent``, negative included."""
    lo, hi = scan_range(bucket_i, delta)
    dev = tent.device
    _build.require_cuda_int32("tent", tent, dev, 1)
    _build.require_cuda_int32("explored", explored, dev, 1)
    n = tent.shape[0]
    if explored.shape[0] != n:
        raise ValueError("tent and explored differ in length")
    lib = _build.load().lib
    frontier = torch.empty(n, dtype=torch.bool, device=dev)
    any_ = torch.empty((), dtype=torch.bool, device=dev)
    nxt = torch.empty((), dtype=torch.int32, device=dev)
    with _build.on_device(dev):
        stream = _build.stream_of(dev)
        err = lib.bucket_scan_launch(
            tent.data_ptr(), explored.data_ptr(), n, lo, hi, int(delta),
            int(scan_vector_path(tent, explored, frontier)),
            frontier.data_ptr(), any_.data_ptr(), nxt.data_ptr(),
            _scratch_of(lib, dev, stream), stream)
    _build.check(err, "bucket_scan")
    bucket_scan_cuda.launches += 1
    return frontier, any_, nxt


bucket_scan_cuda.launches = 0
