"""(distance, predecessor) word packing — paper §3 'Data packing'
(counterpart of ``repro.core.pack``).

A 32-bit cost in the high half and a 32-bit vertex id in the low half
of one int64 word: for non-negative costs, integer order on the packed
word equals lexicographic order on (cost, pred), so one scatter-min
updates both consistently and breaks ties towards the smallest
predecessor id. Torch has native int64, so no x64 switch is needed.
"""
from __future__ import annotations

import torch

from repro_torch.graphs.structures import INF32

MASK32 = (1 << 32) - 1
# "infinity" word: INF32 cost, all-ones pred (decodes to pred sentinel -1).
INF_PACKED = (int(INF32) << 32) | MASK32


def pack(dist: torch.Tensor, pred) -> torch.Tensor:
    """dist int32 (>= 0), pred int32 (>= 0) → packed int64."""
    d = dist.to(torch.int64)
    p = torch.as_tensor(pred, device=dist.device).to(torch.int64) & MASK32
    return (d << 32) | p


def unpack_dist(packed: torch.Tensor) -> torch.Tensor:
    # an arithmetic shift of an int64 always lands in int32 range
    return (packed >> 32).to(torch.int32)


def unpack_pred(packed: torch.Tensor) -> torch.Tensor:
    """Low 32 bits read as a signed int32 — the reference's
    ``uint32 → int32`` cast, written out as an explicit two's-complement
    wrap (an out-of-range int64 → int32 ``.to()`` is not a documented
    wrap in torch)."""
    p = packed & MASK32
    return torch.where(p > 2**31 - 1, p - (1 << 32), p).to(torch.int32)
