"""Deterministic synthetic data pipelines (counterpart of
``repro.data.synthetic``; no dataset downloads). Every source is seeded
and step-indexed so a restarted run resumes with identical batches:
batch i is a pure function of (seed, i), never of pipeline state.

``gnn_full_batch`` and ``molecule_batch`` draw with numpy's
``default_rng`` in the reference's order, so they equal the
reference's arrays bitwise (as tensors on the requested device).
``SyntheticTokens`` and ``SyntheticClicks`` draw from a CPU
``torch.Generator`` seeded from (seed, i), then move the batch to the
device, so a batch is the same on every device; the reference draws
from ``jax.random``'s threefry stream, which torch does not have, so
the streams differ from the reference's (same transforms: Zipf-ish
tokens ``vocab * u**3``, skewed ids ``u**2 * vocab``, 3 % positives).
Tests that hold the port to the reference feed both packages the same
numpy batch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


def _generator(seed: int, step: int) -> torch.Generator:
    return torch.Generator().manual_seed((seed << 32) + step)


@dataclasses.dataclass(frozen=True)
class SyntheticTokens:
    """Zipfian token stream for LM training/serving; int64 tokens (the
    loss gathers its labels with them)."""
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    device: object = None

    def batch_at(self, step: int):
        g = _generator(self.seed, step)
        # Zipf-ish marginal via exponentiated uniform on [1e-6, 1)
        u = torch.rand((self.batch, self.seq_len + 1), generator=g) \
            * (1 - 1e-6) + 1e-6
        toks = (self.vocab * u ** 3).to(torch.int64) % self.vocab
        toks = toks.to(resolve_device(self.device))
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@dataclasses.dataclass(frozen=True)
class SyntheticClicks:
    """Criteo-like batches for DLRM."""
    vocab_sizes: tuple
    n_dense: int
    batch: int
    seed: int = 0
    device: object = None

    def batch_at(self, step: int):
        g = _generator(self.seed + 1, step)
        dense = torch.randn((self.batch, self.n_dense), generator=g)
        us = torch.rand((self.batch, len(self.vocab_sizes)), generator=g)
        vocab = torch.tensor(self.vocab_sizes, dtype=torch.int64)
        sparse = (us ** 2 * vocab).to(torch.int64) % vocab   # skewed ids
        labels = (torch.rand((self.batch,), generator=g) < 0.03).float()
        dev = resolve_device(self.device)
        return {"dense": dense.to(dev), "sparse": sparse.to(dev),
                "labels": labels.to(dev)}


def gnn_full_batch(n_nodes: int, d_feat: int, n_classes: int, seed: int = 0,
                   device=None):
    """Node features + labels + train mask for full-graph training."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n_nodes, d_feat), dtype=np.float32)
    y = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    mask = (rng.random(n_nodes) < 0.1).astype(np.float32)
    dev = resolve_device(device)
    return {"x": torch.from_numpy(x).to(dev),
            "labels": torch.from_numpy(y).to(dev),
            "label_mask": torch.from_numpy(mask).to(dev)}


def molecule_batch(batch: int, n_atoms: int, n_edges: int, seed: int = 0,
                   device=None):
    """Batched small molecules for SchNet: positions, atomic numbers,
    intra-molecule radius edges, per-molecule energy target."""
    rng = np.random.default_rng(seed)
    pos = rng.standard_normal((batch * n_atoms, 3)).astype(np.float32) * 2
    z = rng.integers(1, 18, batch * n_atoms).astype(np.int32)
    # edges within each molecule only
    src = rng.integers(0, n_atoms, (batch, n_edges))
    dst = rng.integers(0, n_atoms, (batch, n_edges))
    off = (np.arange(batch) * n_atoms)[:, None]
    src, dst = (src + off).ravel(), (dst + off).ravel()
    mol_id = np.repeat(np.arange(batch), n_atoms).astype(np.int32)
    energy = rng.standard_normal(batch).astype(np.float32)
    dev = resolve_device(device)
    arrays = {"pos": pos, "atom_z": z, "src": src.astype(np.int32),
              "dst": dst.astype(np.int32), "mol_id": mol_id,
              "energy": energy}
    return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
