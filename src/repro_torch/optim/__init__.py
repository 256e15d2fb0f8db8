"""Optimizers of the PyTorch port: pure ``(init, update)`` pairs over
named trees of tensors (``repro_torch.optim.optimizers``)."""
from repro_torch.optim.optimizers import (
    BY_NAME,
    Optimizer,
    adafactor,
    adamw,
    clip_by_global_norm,
    global_norm,
    sgdm,
    warmup_cosine,
)

__all__ = ["Optimizer", "adamw", "adafactor", "sgdm", "warmup_cosine",
           "clip_by_global_norm", "global_norm", "BY_NAME"]
