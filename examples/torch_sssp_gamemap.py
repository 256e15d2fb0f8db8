"""Game-map SSSP on the PyTorch/CUDA port (paper §4 'Game Maps'), the
twin of ``examples/sssp_gamemap.py``: occupancy grid, straight moves
cost 10, diagonals 14, Δ=13 — runs both the generic engine and the
grid-stencil engine (the hand-written ``grid_relax`` kernel on CUDA,
its plain twin on the CPU) and renders a small ASCII path.

    PYTHONPATH=src python examples/torch_sssp_gamemap.py
    PYTHONPATH=src python examples/torch_sssp_gamemap.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.api import Engine, SingleSource
from repro_torch.core import DeltaConfig
from repro_torch.core.grid import GridDeltaConfig, GridDeltaSolver
from repro_torch.graphs import grid_map

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: cuda; 'cpu' runs the kernels' "
                     "plain twins)")
device = ap.parse_args().device

H = W = 40
g, free = grid_map(H, W, obstacle_frac=0.15, seed=7)
src = int(np.flatnonzero(free.ravel())[0])

# generic edge-centric engine
res = Engine(g, DeltaConfig(delta=13), device=device).plan().solve(
    SingleSource(src))
dist_edge = res.dist.cpu().numpy().reshape(H, W)

# grid-stencil engine (same bucket semantics, min-plus stencil sweeps)
grid = GridDeltaSolver(free, GridDeltaConfig(backend="pallas"),
                       device=device)
gres = grid.solve((src // W, src % W))
dist_grid = gres.dist.cpu().numpy()
assert np.array_equal(dist_edge, dist_grid), "engines disagree!"
print(f"engines agree on {grid.free.device}; {gres.outer_iters} buckets, "
      f"{gres.inner_iters} light sweeps")

# ASCII render: walls '#', unreachable '.', else distance band
INF = 2**31 - 1
band = np.where(dist_grid < INF, dist_grid // 80, -1)
chars = np.full((H, W), "#", dtype="<U1")
for r in range(H):
    for c in range(W):
        if free[r, c]:
            b = band[r, c]
            chars[r, c] = "." if b < 0 else "0123456789abcdefghijklmnop"[
                min(int(b), 25)]
chars[src // W, src % W] = "S"
print("\n".join("".join(row) for row in chars[:20]))
