"""Checkpointing of the PyTorch port: atomic, step-indexed, optionally
async (``repro_torch.checkpoint.checkpointer``)."""
from repro_torch.checkpoint.checkpointer import (
    AsyncWriter,
    all_steps,
    latest_step,
    restore,
    save,
)

__all__ = ["save", "restore", "latest_step", "all_steps", "AsyncWriter"]
