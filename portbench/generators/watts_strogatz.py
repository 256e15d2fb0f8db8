"""Watts-Strogatz small-world graph, drawn on the device from the seed.

The arithmetic of the port's ``graphs.generators.watts_strogatz`` (a
ring of ``k`` nearest neighbours, one endpoint of each lattice edge
rewired with probability ``p``, self loops dropped, duplicates kept,
both directions with one weight U{w_lo..w_hi}), with a
``torch.Generator`` on the run's device in place of numpy's.
"""
from __future__ import annotations

import torch

from pbcore.instance import Instance


def make(params: dict, seed: int, device: torch.device) -> Instance:
    n, k, p = int(params["n"]), int(params["k"]), float(params["p"])
    if k % 2:
        raise ValueError("k must be even for a ring lattice")
    gen = torch.Generator(device=device).manual_seed(seed)
    half = k // 2
    u = torch.arange(n, dtype=torch.int64, device=device).repeat_interleave(
        half)
    offs = torch.arange(1, half + 1, dtype=torch.int64, device=device)
    v = (u + offs.repeat(n)) % n
    rew = torch.rand(u.shape[0], generator=gen, device=device) < p
    rand_v = torch.randint(0, n, (u.shape[0],), generator=gen, device=device)
    v = torch.where(rew, rand_v, v)
    keep = u != v
    u, v = u[keep].to(torch.int32), v[keep].to(torch.int32)
    w = torch.randint(int(params["w_lo"]), int(params["w_hi"]) + 1,
                      (u.shape[0],), generator=gen, device=device,
                      dtype=torch.int32)
    return Instance(n, torch.cat([u, v]), torch.cat([v, u]),
                    torch.cat([w, w]))
