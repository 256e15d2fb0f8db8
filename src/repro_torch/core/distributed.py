"""Distributed Δ-stepping over a process group (counterpart of
``repro.core.distributed``, DESIGN.md §4).

The paper's OpenMP parallelization maps to SPMD, one process per GPU,
every rank running this same program (PyTorch's idiom for the
reference's single-controller ``shard_map``):

* OpenMP static scheduling of bucket entries → a static 1-D vertex
  partition over the ``model`` dim of a ``DeviceMesh``
  (``graphs.partition``); each rank owns a vertex range, all outgoing
  edges of that range and its slice of the tent.
* shared ``tent`` array + CAS → per-rank relaxation into a local
  candidate buffer + a cross-rank **min-combine** collective.
* the paper's removal of the omp barrier in the light phase → with
  ``local_steps > 1`` each rank runs local light sweeps that merge only
  its own slice between collectives.

Two combine schedules:

* ``allreduce``      — ``all_reduce(MIN)`` of the |V|-word buffer, then
  each rank keeps its slice;
* ``reduce_scatter`` — a reduce-scatter with MIN: each rank gets
  the min of every rank's words of its own slice, half the volume.

Both give the same words. Independent sources are split over the
mesh's other dims (``data``): each data row solves its share, lane by
lane (the reference ``vmap``s them; every lane is bitwise its own
solve either way). Every rank returns the whole ``dist[B, n]`` and the
counters' maxima over all sources. Collectives run over NCCL on CUDA
and over gloo on the CPU (gloo takes CUDA tensors too).
Without a mesh the engine runs one shard and one data row in-process,
with no collective.

The dry run (``launch/cells.py``) traces ``solve.step``, one outer step
of the loop built from the same closures, on fake stand-ins
(``input_specs_sssp``): the loop's trip count is data-dependent, as it
is for the reference's lowered while-loop.
``repro_torch.launch.mesh.make_host_mesh`` builds the mesh this engine
takes.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.core.backends import all_reduce, edge_candidates, scan_bucket
from repro_torch.device import resolve_device
from repro_torch.graphs.partition import VertexPartition
from repro_torch.graphs.structures import INF32

_INF = int(INF32)
_IMAX = 2**31 - 1
# the reduce-scatter of one flat tensor: ``reduce_scatter_single`` where
# torch has it (``reduce_scatter_tensor`` is deprecated there)
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


@dataclasses.dataclass(frozen=True)
class DistDeltaConfig:
    """delta        — bucket width Δ.
    combine      — 'allreduce' | 'reduce_scatter' min-combine schedule.
    local_steps  — local light sweeps between collectives (>=1); the
                   paper's barrier-removal trade (§4 'Delta').
    model_axis   — mesh dim sharding the vertex set.
    batch_axes   — mesh dims sharding independent sources: every dim
                   but ``model_axis``, in mesh order.
    """

    delta: int = 10
    combine: str = "allreduce"
    local_steps: int = 1
    model_axis: str = "model"
    batch_axes: tuple = ("data",)

    def __post_init__(self):
        if self.combine not in ("allreduce", "reduce_scatter"):
            raise ValueError(f"unknown combine {self.combine!r}")
        if self.local_steps < 1:
            raise ValueError("local_steps must be >= 1")


class _Mesh:
    """The layout one rank needs: its model dim's size, coordinate and
    group, its data row among ``rows``, and every rank's (row, model)
    coordinate for the final gather. ``mesh=None``: one shard, one row,
    no group."""

    def __init__(self, mesh, cfg: DistDeltaConfig):
        if mesh is None:
            self.p_model, self.my, self.group = 1, 0, None
            self.rows, self.row, self.coords = 1, 0, None
            return
        names = tuple(mesh.mesh_dim_names or ())
        if cfg.model_axis not in names:
            raise ValueError(f"mesh dims {names} lack {cfg.model_axis!r}")
        batch = tuple(a for a in names if a != cfg.model_axis)
        if tuple(cfg.batch_axes) != batch:
            raise ValueError(
                f"batch_axes {tuple(cfg.batch_axes)} must be the mesh's "
                f"dims other than {cfg.model_axis!r}: {batch}")
        m = names.index(cfg.model_axis)
        layout = mesh.mesh.movedim(m, -1)         # [..batch dims, model]
        self.p_model = int(layout.shape[-1])
        self.rows = layout.numel() // self.p_model
        flat = layout.reshape(self.rows, self.p_model)
        self.group = mesh.get_group(cfg.model_axis)
        # rank -> (data row, model coordinate)
        self.coords = {int(flat[r, c]): (r, c) for r in range(self.rows)
                       for c in range(self.p_model)}
        self.row, self.my = self.coords[dist.get_rank()]

    def reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        """``t`` reduced in place over the model dim."""
        return t if self.group is None else all_reduce(t, op, self.group)

    def scatter_min(self, buf: torch.Tensor, s: int) -> torch.Tensor:
        """This rank's slice of the element-wise min of every rank's
        ``buf`` (a reduce-scatter with MIN)."""
        out = buf.new_empty(s)
        _reduce_scatter(out, buf, op=dist.ReduceOp.MIN, group=self.group)
        return out

    def gather(self, local: torch.Tensor, n: int) -> torch.Tensor:
        """``[B, n]`` from every rank's ``[B / rows, S]`` block."""
        if self.coords is None:
            return local[:, :n]
        parts = [torch.empty_like(local) for _ in self.coords]
        dist.all_gather(parts, local)               # in world rank order
        b, s = local.shape
        out = local.new_empty((self.rows * b, self.p_model * s))
        for r, part in enumerate(parts):
            row, col = self.coords[r]
            out[row * b:(row + 1) * b, col * s:(col + 1) * s] = part
        return out[:, :n]

    def max_all(self, x: int, device) -> int:
        """The maximum of ``x`` over every rank."""
        if self.coords is None:
            return x
        t = torch.tensor([x], dtype=torch.int64, device=device)
        return int(all_reduce(t, dist.ReduceOp.MAX, dist.group.WORLD))


def build_solver_from_meta(*, n_nodes: int, shard_nodes: int, mesh=None,
                           cfg: DistDeltaConfig = DistDeltaConfig(),
                           device=None):
    """Builds the SPMD solve function from static metadata. ``mesh``: a
    ``torch.distributed.device_mesh.DeviceMesh`` with a ``model`` dim
    and the batch dims (``None``: one shard in-process); ``device``:
    where this rank's tensors live (default CUDA).

    Returns ``solve(sources, src, dst, w, vstart) -> (dist int32[B, n],
    outer, inner)`` where ``src``/``dst``/``w`` are *this rank's* edge
    shard (its row of a ``VertexPartition``) and ``vstart`` its first
    owned vertex: each rank holds only its own shard. ``B`` must be a
    multiple of the batch dims' size. ``solve.step`` is one outer step of
    its loop for the dry run (``step`` below)."""
    dev = resolve_device(device)
    lay = _Mesh(mesh, cfg)
    n, s = n_nodes, shard_nodes
    n_pad = lay.p_model * s
    delta, my = cfg.delta, lay.my
    base = my * s
    mine = slice(base, base + s)

    def combine_min(buf, tent):
        """buf int32[n_pad] of local candidates → merged into the slice."""
        if lay.group is not None and cfg.combine == "reduce_scatter":
            return torch.minimum(tent, lay.scatter_min(buf, s))
        return torch.minimum(tent, lay.reduce(buf, dist.ReduceOp.MIN)[mine])

    def local_sweep(tent, frontier, light, edges):
        """Relax this rank's ``edges`` (``src_off``, ``dst``, ``w``) from
        ``frontier`` into a fresh full-size candidate buffer."""
        src_off, dst64, w_e = edges
        cand, ok = edge_candidates(tent[src_off], frontier[src_off], w_e,
                                   delta=delta, light=light)
        buf = torch.full((n_pad,), _INF, dtype=torch.int32, device=dev)
        return buf.scatter_reduce_(0, dst64, torch.where(ok, cand, _INF),
                                   "amin", include_self=True)

    def any_flag(tent, explored, i):
        """Bucket ``i``'s frontier and its any-flag, MAX over the model
        dim (a uint8 tensor)."""
        f, any_loc, _ = scan_bucket(tent, explored, i, delta=delta)
        return f, lay.reduce(any_loc.reshape(1).to(torch.uint8),
                             dist.ReduceOp.MAX)

    def flag(tent, explored, i):
        f, go = any_flag(tent, explored, i)
        return f, bool(go)

    def next_bucket(tent, explored, i):
        """The next non-empty bucket, MIN over the model dim."""
        _, _, nxt = scan_bucket(tent, explored, i, delta=delta)
        return lay.reduce(nxt.reshape(1), dist.ReduceOp.MIN)

    def init_tent(source):
        lidx = torch.arange(s, dtype=torch.int32, device=dev) + base
        tent = torch.where((lidx == source) & (lidx < n), 0, _INF)
        return tent.to(torch.int32)

    def outer_step(tent, explored, i, edges):
        """One step of ``solve_one``'s outer loop with one light sweep,
        reading nothing on the host: the light phase's first any-flag,
        one light sweep with its combine and its any-flag, the heavy
        sweep with its combine, the next-bucket MIN. Returns ``(tent,
        explored, go, nxt)``."""
        f, _ = any_flag(tent, explored, i)
        explored = torch.where(f, tent, explored)
        in_s = f
        f2, _, _ = scan_bucket(tent, explored, i, delta=delta)
        tent = combine_min(local_sweep(tent, f2 | f, True, edges), tent)
        _, go = any_flag(tent, explored, i)
        tent = combine_min(local_sweep(tent, in_s, False, edges), tent)
        return tent, explored, go, next_bucket(tent, explored, i)

    def step(sources, src, dst, w, vstart):
        """One outer step from bucket 0 for each of ``sources`` (this
        rank's share), on this rank's edge shard taken as all real
        (``src < n`` everywhere: the edges are already masked), with
        ``vstart`` a tensor: the dry run's traced step, whose loop trip
        count is data-dependent. Returns ``(tent [B, S], go, nxt)`` of
        the last source."""
        edges = (src.to(torch.int64) - vstart.to(torch.int64),
                 dst.to(torch.int64), w)
        lanes = []
        go = nxt = None
        for source in sources:
            explored = torch.full((s,), _INF, dtype=torch.int32, device=dev)
            tent, _, go, nxt = outer_step(init_tent(source), explored, 0,
                                          edges)
            lanes.append(tent)
        return torch.stack(lanes), go, nxt

    def solve(sources, src, dst, w, vstart):
        real = src < n
        edges = ((src[real].to(torch.int64) - int(vstart)).to(dev),
                 dst[real].to(device=dev, dtype=torch.int64), w[real].to(dev))

        def solve_one(source):
            tent = init_tent(source)
            explored = torch.full((s,), _INF, dtype=torch.int32, device=dev)
            i, outer, inner = 0, 0, 0
            while i < _IMAX:
                in_s = torch.zeros(s, dtype=torch.bool, device=dev)
                f, go = flag(tent, explored, i)
                while go:
                    explored = torch.where(f, tent, explored)
                    in_s = in_s | f
                    # local_steps - 1 local sweeps without combining:
                    # redundant work instead of synchronization
                    for _ in range(cfg.local_steps - 1):
                        fl, _, _ = scan_bucket(tent, explored, i, delta=delta)
                        explored = torch.where(fl, tent, explored)
                        buf = local_sweep(tent, fl, True, edges)
                        tent = torch.minimum(tent, buf[mine])
                    f2, _, _ = scan_bucket(tent, explored, i, delta=delta)
                    tent = combine_min(
                        local_sweep(tent, f2 | f, True, edges), tent)
                    f, go = flag(tent, explored, i)
                    inner += 1
                tent = combine_min(local_sweep(tent, in_s, False, edges),
                                   tent)
                i = int(next_bucket(tent, explored, i))
                outer += 1
            return tent, outer, inner

        srcs = [int(x) for x in sources]
        if len(srcs) % lay.rows:
            raise ValueError(f"{len(srcs)} sources do not split over "
                             f"{lay.rows} data rows")
        per = len(srcs) // lay.rows
        runs = [solve_one(x) for x in srcs[lay.row * per:(lay.row + 1) * per]]
        local = (torch.stack([r[0] for r in runs]) if runs else
                 torch.empty((0, s), dtype=torch.int32, device=dev))
        outer = lay.max_all(max((r[1] for r in runs), default=0), dev)
        inner = lay.max_all(max((r[2] for r in runs), default=0), dev)
        return lay.gather(local, n), outer, inner

    solve.step = step
    return solve


def build_distributed_solver(partition: VertexPartition, mesh=None,
                             cfg: DistDeltaConfig = DistDeltaConfig(),
                             device=None):
    """Convenience wrapper over a concrete partition (on any device: only
    this rank's row moves to ``device``). Returns ``solve(sources
    int[B]) -> (dist int32[B, n], outer, inner)``, the same on every
    rank."""
    lay = _Mesh(mesh, cfg)
    if partition.n_shards != lay.p_model:
        raise ValueError(
            f"partition has {partition.n_shards} shards, mesh dim "
            f"{cfg.model_axis!r} has {lay.p_model} ranks")
    inner = build_solver_from_meta(
        n_nodes=partition.n_nodes, shard_nodes=partition.shard_nodes,
        mesh=mesh, cfg=cfg, device=device)
    row = lay.my
    src, dst, w = (t[row] for t in (partition.src, partition.dst,
                                    partition.w))
    vstart = int(partition.vstart[row])

    def solve(sources):
        return inner(sources, src, dst, w, vstart)

    return solve


def input_specs_sssp(n_sources: int, n_nodes: int, device="meta"):
    """Stand-ins for the SSSP dry run: tensors without data (``meta``; a
    FakeTensor where a fake mode is active)."""
    return dict(sources=torch.empty((n_sources,), dtype=torch.int32,
                                    device=device))


__all__ = [
    "DistDeltaConfig",
    "build_distributed_solver",
    "build_solver_from_meta",
    "input_specs_sssp",
]
