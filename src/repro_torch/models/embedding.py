"""EmbeddingBag built from gather + segment-reduce (counterpart of
``repro.models.embedding``): a row gather from the table followed by a
segment reduction over bag ids, the same primitive family as the GNN
aggregations and the Δ-stepping scatter-min (DESIGN.md §5).

Out-of-range ids behave as in the reference (JAX drops them silently,
where ``index_add_`` raises on the CPU and asserts on CUDA): a gathered
id outside ``[-V, V)`` reads a zero row (negative ids from ``-V`` wrap,
as ``jnp.take`` wraps them), and a segment id outside ``[0, n)`` is
dropped. The gather reads a table with one zero row appended; the
reduction writes ``n + 1`` rows and the last is sliced off. The ops
(``index_select``, ``index_add``, ``scatter_reduce`` with ``amax``) are
deterministic on CUDA under ``torch.use_deterministic_algorithms``.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


def take_fill(table, idx, fill: float = 0.0):
    """``jnp.take(table, idx, axis=0, mode="fill", fill_value=fill)``:
    ids in ``[-V, 0)`` wrap, any other id outside ``[0, V)`` reads a row
    of ``fill``."""
    n = table.shape[0]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    rows = torch.index_select(table, 0, torch.where(valid, idx, 0).reshape(-1))
    rows = rows.reshape(idx.shape + table.shape[1:])
    return torch.where(valid.reshape(idx.shape + (1,) * (table.ndim - 1)),
                       rows, fill)


def sharded_lookup(table, ids):
    """``table[ids]`` for a DTensor ``table`` (rows split over some mesh
    dims, columns over others), on local tensors: each rank gathers the
    ids that fall in its own block of rows and zeros for the others, so
    the rows are the sum over the dims that split them (a ``Partial``
    placement, reduced by the caller's next layout). The ids are gathered
    whole over those dims; their other splits carry over to the output,
    and a column split becomes a split of its last dim. (DTensor's own
    rules for an indexing into a row-split table fail on the card's torch
    2.11 in the backward, and its masked embedding fails on batch-split
    ids.)"""
    from repro_torch.models.sharding import block_of

    mesh = table.device_mesh
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    id_want, out = [], []
    for tp, ip in zip(table.placements, ids.placements):
        if tp == Shard(0):
            id_want.append(Replicate())
            out.append(Partial())
        elif tp == Shard(1):
            id_want.append(Replicate())
            out.append(Shard(ids.ndim))
        else:
            id_want.append(ip)
            out.append(ip)
    local_ids = ids.redistribute(mesh, id_want).to_local().long()
    start, rows_here = block_of(table, 0)
    rel = local_ids - start
    inside = (rel >= 0) & (rel < rows_here)
    rows = table.to_local()[torch.where(inside, rel, 0)]
    rows = torch.where(inside[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    full = tuple(ids.shape) + (table.shape[1],)
    stride = tuple(math.prod(full[i + 1:]) for i in range(len(full)))
    return DTensor.from_local(rows, mesh, out, run_check=False, shape=full,
                              stride=stride)


def _segment_ids(ids, n: int):
    ids = ids.long()
    return torch.where((ids >= 0) & (ids < n), ids, n)


def segment_sum(x, ids, n: int):
    """``jax.ops.segment_sum(x, ids, num_segments=n)``: ids outside
    ``[0, n)`` are dropped."""
    out = torch.zeros((n + 1,) + x.shape[1:], dtype=x.dtype, device=x.device)
    return out.index_add(0, _segment_ids(ids, n), x)[:n]


def segment_max(x, ids, n: int):
    """``jax.ops.segment_max(x, ids, num_segments=n)``: an empty segment
    is ``-inf``; ids outside ``[0, n)`` are dropped. A DTensor ``x``
    (under sharding rules) is reduced on whole operands: DTensor has no
    rule for ``scatter_reduce`` (a replicate detour)."""
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        whole = [Replicate()] * mesh.ndim
        ids = (ids if isinstance(ids, DTensor) else DTensor.from_local(
            ids, mesh, whole, run_check=False))
        out = segment_max(x.redistribute(mesh, whole).to_local(),
                          ids.redistribute(mesh, whole).to_local(), n)
        return DTensor.from_local(out, mesh, whole, run_check=False)
    out = torch.full((n + 1,) + x.shape[1:], float("-inf"), dtype=x.dtype,
                     device=x.device)
    idx = _segment_ids(ids, n).reshape((-1,) + (1,) * (x.ndim - 1))
    return out.scatter_reduce(0, idx.expand_as(x), x, "amax",
                              include_self=True)[:n]


def embedding_bag(table, indices, segment_ids, num_bags: int,
                  mode: str = "sum", weights=None):
    """table: (V, D); indices: int[N] rows to gather; segment_ids:
    int[N] bag of each index (sorted not required); → (num_bags, D)."""
    rows = take_fill(table, indices)
    if weights is not None:
        rows = rows * weights[:, None]
    if mode == "sum":
        return segment_sum(rows, segment_ids, num_bags)
    if mode == "mean":
        s = segment_sum(rows, segment_ids, num_bags)
        c = segment_sum(torch.ones(segment_ids.shape, dtype=torch.float32,
                                   device=rows.device), segment_ids, num_bags)
        return s / torch.clamp(c, min=1.0)[:, None]
    if mode == "max":
        return segment_max(rows, segment_ids, num_bags)
    raise ValueError(mode)


def multi_hot_lookup(table, hot_indices):
    """Fixed multi-hot layout: hot_indices int[B, H] (H hots per sample,
    -1 = padding) → summed embeddings (B, D). The DLRM fast path (no
    ragged segment ids needed when every sample has the same hot count).
    An id past the table reads NaN, as the reference's default gather
    mode fills it."""
    mask = (hot_indices >= 0)[..., None]
    rows = take_fill(table, torch.clamp(hot_indices, min=0), float("nan"))
    return torch.where(mask, rows, 0).sum(dim=1)
