"""Uniform k-hop neighbour sampler (GraphSAGE-style) for minibatch GNN
training (counterpart of ``repro.graphs.sampler``; the
``minibatch_lg`` shape, fanout 15-10).

Per hop, each frontier node draws ``fanout`` neighbour slots uniformly
*with replacement* from its CSR row (nodes of degree 0 self-loop). The
draw is ``_uniforms`` (from a ``torch.Generator``); ``neighbours``
maps the uniforms to neighbour ids, so the reference's uniforms give
the reference's neighbours bitwise. Returns the block structure the GNN
layers consume: per-hop (src, dst) edge lists in *local* index space
plus the gathered node id table.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch


class SampledBlock(NamedTuple):
    """One hop of sampled message flow: edges src_local -> dst_local.

    ``src_local`` indexes into the *next* hop's node table (size
    n_dst * fanout + n_dst prefix), ``dst_local`` into the current one.
    """

    src_nodes: torch.Tensor   # int32[n_src] global ids of this hop's inputs
    src_local: torch.Tensor   # int32[n_edges]
    dst_local: torch.Tensor   # int32[n_edges]
    n_dst: int


def _uniforms(generator: torch.Generator, shape, device):
    """U[0, 1) float32 draws of one hop."""
    return torch.rand(shape, generator=generator, device=device)


def neighbours(u, row_ptr, col, seeds):
    """u float32[B, f] uniforms, seeds int[B] → int32[B, f] neighbour ids:
    slot ``floor(u * max(deg, 1))`` of each seed's CSR row; a seed of
    degree 0 yields itself."""
    seeds = seeds.long()
    start = row_ptr[seeds].long()
    deg = row_ptr[seeds + 1].long() - start
    slot = torch.floor(u * torch.clamp(deg, min=1)[:, None].float()).long()
    # a degree-0 seed's slot may point past the last edge: clamped, then
    # replaced by the seed itself
    idx = torch.clamp(start[:, None] + slot, max=max(col.numel() - 1, 0))
    nbrs = col[idx] if col.numel() else torch.zeros_like(slot)
    return torch.where(deg[:, None] > 0, nbrs.long(),
                       seeds[:, None]).to(torch.int32)


def _sample_one_hop(generator, row_ptr, col, seeds, fanout: int):
    """seeds: int[B] → sampled neighbour ids int32[B, fanout]."""
    u = _uniforms(generator, (seeds.shape[0], fanout), seeds.device)
    return neighbours(u, row_ptr, col, seeds)


def sample_khop(generator: torch.Generator, row_ptr, col, seeds,
                fanouts: Sequence[int]
                ) -> Tuple[torch.Tensor, list[SampledBlock]]:
    """Layer-wise k-hop sampling from the outermost hop inwards.

    Returns ``(input_nodes, blocks)`` where ``blocks[h]`` flows messages
    from hop h+1's nodes into hop h's nodes and ``blocks[0].n_dst`` equals
    ``len(seeds)``. All shapes are static given (len(seeds), fanouts).
    ``generator`` lives on the tensors' device.
    """
    blocks = []
    cur = seeds.to(torch.int32)
    dev = cur.device
    for fanout in fanouts:
        nbrs = _sample_one_hop(generator, row_ptr, col, cur, fanout)
        n_dst = cur.shape[0]
        # next hop's node table = [dst nodes (for self features)] ++ sampled
        nxt = torch.cat([cur, nbrs.reshape(-1)])
        src_local = n_dst + torch.arange(n_dst * fanout, dtype=torch.int32,
                                         device=dev)
        dst_local = torch.repeat_interleave(
            torch.arange(n_dst, dtype=torch.int32, device=dev), fanout)
        blocks.append(SampledBlock(src_nodes=cur, src_local=src_local,
                                   dst_local=dst_local, n_dst=n_dst))
        cur = nxt
    return cur, blocks
