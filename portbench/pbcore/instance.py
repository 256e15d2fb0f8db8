"""One problem instance, made by the benchmark from the seed and handed
alike to the program and to the reference."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass
class Instance:
    """A directed graph as int32 COO tensors on one device. A game map
    also carries its occupancy grid ``free`` (bool ``[H, W]``, True =
    passable; vertex id ``r * W + c``) and its move costs ``(straight,
    diagonal)``; the COO then holds every move between two free cells."""

    n: int
    src: torch.Tensor
    dst: torch.Tensor
    w: torch.Tensor
    free: Optional[torch.Tensor] = None
    costs: Optional[Tuple[int, int]] = None

    @property
    def m(self) -> int:
        return int(self.src.shape[0])

    @property
    def device(self) -> torch.device:
        return self.src.device
