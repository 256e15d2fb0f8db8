"""Where the port's entry points run: CUDA unless the caller asks for
another device, and never the CPU quietly."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``None`` → CUDA. Asking for CUDA without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; repro_torch runs on the GPU "
            "unless the caller passes device='cpu'")
    return dev
