"""(architecture × input-shape × mesh) cell builders for the dry run
(counterpart of ``repro.launch.cells``).

A *cell* packages everything needed to trace one step program once: the
step callable, stand-ins for every input, and the MODEL_FLOPS estimate
for the roofline. The reference lowers its step against
ShapeDtypeStructs; the port runs its own step once on **fake tensors**
(``analysis/trace.py``): every stand-in (parameters, optimizer state,
KV cache, batch) is made under the cell's ``RecordingMode`` and placed
as a DTensor on the mesh by ``param_sharding``'s specs, trimmed by
``param_sharding.fit`` as the reference's ``_fit`` trims its
shardings. No stand-in allocates device memory. ``Cell.trace()`` takes
the place of ``lower()``.

Family → traced program:
  lm / train_*        train_step  (loss + grads + optimizer update)
  lm / prefill_*      prefill     (prompt pass filling the KV cache)
  lm / decode_*, long decode_step (one token against the cache)
  gnn / *             train_step  (full-graph / sampled / batched-mol)
  recsys / train      train_step; serve_* forward; retrieval top-k
  sssp / *            one outer step of the batched distributed solve

Where DTensor has no sharding rule for a step's op, the step gathers
the operands whole first (a replicate detour: the minibatch sampler's
graph arrays here, and in the models GAT's layers and ``segment_max``);
the all-gathers show in the cell's collectives and its ``note`` names
the detour.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional

import torch

from repro_torch.analysis.roofline import estimate_model_flops
from repro_torch.analysis.trace import RecordingMode, StepTrace, trace_step
from repro_torch.configs import family_of, get_config, get_shape
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.distributed import (
    DistDeltaConfig,
    build_solver_from_meta,
    input_specs_sssp,
)
from repro_torch.device import resolve_device
from repro_torch.graphs.sampler import sample_khop
from repro_torch.models import dlrm as dlrm_lib
from repro_torch.models import gnn as gnn_lib
from repro_torch.models import transformer as tf_lib
from repro_torch.models.param_sharding import (
    cache_specs,
    distribute,
    dlrm_param_specs,
    gnn_param_specs,
    lm_param_specs,
    place,
    state_specs_like,
)
from repro_torch.models.sharding import P, axis_names, full, sharding_rules
from repro_torch.optim import adafactor, adamw
from repro_torch.train.steps import make_train_step, named_params

F32 = torch.float32
I32 = torch.int32
# the minibatch sampler's seed: a host int (the reference carries a
# uint32[2] key in the batch; a fake tensor cannot seed a generator)
SAMPLER_SEED = 0


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    fn: Any                      # the step, run under the sharding rules
    args: tuple                  # fake stand-ins (DTensors over them)
    model_flops: float
    mapping: dict                # logical→mesh mapping used
    note: str = ""
    mode: Optional[RecordingMode] = None

    def trace(self) -> StepTrace:
        return trace_step(self.fn, *self.args, mode=self.mode)


def _dp(mesh):
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def _all_axes(mesh):
    return tuple(axis_names(mesh))


def _size(mesh, axes) -> int:
    out = 1
    for a in axes:
        out *= mesh.size(axis_names(mesh).index(a))
    return out


def _mapping_for(mesh, overrides: Optional[dict] = None):
    m = {"dp": _dp(mesh), "fsdp": _dp(mesh), "tp": "model", "sp": "model",
         "ep_cap": _dp(mesh), "nodes": _all_axes(mesh), "act_seq": None}
    m.update(overrides or {})
    return m


def _opt_for(cfg):
    # factored state is mandatory above ~100B params (DESIGN.md §6)
    if cfg.n_params() > 100e9:
        return adafactor(1e-3)
    return adamw(3e-4)


def _made(mode):
    """Where stand-ins are made: under the cell's fake mode, or (a real
    cell) as they are."""
    return contextlib.nullcontext() if mode is None else mode


def _generator(dev):
    return torch.Generator(device=dev).manual_seed(0)


def _stand_in(shape, dtype, dev):
    return torch.zeros(tuple(int(s) for s in shape), dtype=dtype, device=dev)


def _placed(specs: dict, mesh, dev) -> dict:
    """``{name: (shape, dtype, mesh-dim spec)}`` as fake DTensors."""
    return {k: place(_stand_in(shape, dt, dev), spec, mesh)
            for k, (shape, dt, spec) in specs.items()}


def _model_and_state(model, pspecs, opt, mesh, mapping):
    """``model``'s parameters placed by ``pspecs`` and, with ``opt``, its
    optimizer state placed by the specs the reference derives."""
    state = None
    if opt is not None:
        state = opt.init(named_params(model))
        state = distribute(state, state_specs_like(pspecs, state), mesh,
                           mapping)
    distribute(model, pspecs, mesh, mapping)
    return state


def _train_fn(loss_fn, opt, mesh, mapping):
    raw = make_train_step(loss_fn, opt, donate=False, jit=False)

    def step(params, opt_state, batch):
        with sharding_rules(mesh, mapping):
            return raw(params, opt_state, None, batch)
    return step


# ------------------------------------------------------------------ LM cells

def _lm_cell(arch: str, cfg, shape: ShapeSpec, mesh, smoke: bool, dev,
             mode: RecordingMode) -> Cell:
    # training: sequence-parallel residual stream (act_seq -> model axis)
    mapping = _mapping_for(
        mesh, {"act_seq": "model"} if shape.kind == "train" else None)
    b, s = shape.global_batch, shape.seq_len
    dp_size = _size(mesh, _dp(mesh))
    if smoke:
        b, s = max(2 * dp_size, 4), 64
    dp = _dp(mesh)
    if shape.kind != "train":
        cfg = dataclasses.replace(cfg, remat=False)  # remat: a training trade

    with _made(mode):
        model = tf_lib.init_lm(cfg, _generator(dev), dev)
        pspecs = lm_param_specs(model)
        if shape.kind == "train":
            opt = _opt_for(cfg)
            state = _model_and_state(model, pspecs, opt, mesh, mapping)
            batch = _placed({"tokens": ((b, s), I32, P(dp, None)),
                             "labels": ((b, s), I32, P(dp, None))}, mesh,
                            dev)
        else:
            long_ctx = shape.name.startswith("long")
            if long_ctx:
                mapping = _mapping_for(mesh, {"dp": None,
                                              "sp": _all_axes(mesh)})
            _model_and_state(model, pspecs, None, mesh, mapping)
            cache_len = s
            bb = b if not smoke else max(dp_size, 2)
            if smoke:
                cache_len, s = 128, 128
            cache = distribute(tf_lib.init_cache(cfg, bb, cache_len,
                                                 device=dev),
                               cache_specs(long_context=long_ctx), mesh,
                               mapping)

    if shape.kind == "train":
        # No microbatch accumulation: remat + sequence-parallel residuals
        # already bound activations (the reference's choice).
        loss_chunk = 64 if smoke else 512

        def loss_fn(p, batch):
            return tf_lib.lm_loss(p, cfg, batch["tokens"], batch["labels"],
                                  loss_chunk=loss_chunk)

        fn = _train_fn(loss_fn, opt, mesh, mapping)
        args = (model, state, batch)
    elif shape.kind == "prefill":
        with _made(mode):
            tokens = place(_stand_in((bb, s if not smoke else 64), I32, dev),
                           P(dp, None), mesh)

        def fn(params, tokens, cache):
            with sharding_rules(mesh, mapping):
                return tf_lib.prefill(params, cfg, tokens, cache)
        args = (model, tokens, cache)
    else:                                        # decode (incl. long_500k)
        with _made(mode):
            tokens = place(_stand_in((bb, 1), I32, dev),
                           P(dp, None) if not long_ctx else P(None, None),
                           mesh)

        def fn(params, cache, tokens):
            with sharding_rules(mesh, mapping):
                return tf_lib.decode_step(params, cfg, cache, tokens)
        args = (model, cache, tokens)

    return Cell(arch, shape.name, fn, args,
                estimate_model_flops("lm", cfg, shape), mapping, mode=mode)


# ----------------------------------------------------------------- GNN cells

def _gnn_batch_sds(cfg, shape: ShapeSpec, smoke: bool, mesh_size: int):
    n = shape.extra("n_nodes")
    e = shape.extra("n_edges")
    b = shape.extra("batch", 1)
    if smoke:
        n, e, b = min(n, 256), min(e, 1024), min(b, 4)
    # pad to mesh-divisible counts so the flat node/edge arrays shard
    # (padding edges target the sentinel node; stand-ins only)
    n = -(-n // mesh_size) * mesh_size
    e = -(-e // mesh_size) * mesh_size
    return n, e, b


def _take_clip(table, idx):
    """``jnp.take(table, idx, axis=0, mode="clip")``."""
    return torch.index_select(
        table, 0, torch.clamp(idx.long(), 0, table.shape[0] - 1).reshape(-1)
    ).reshape(tuple(idx.shape) + tuple(table.shape[1:]))


def _gnn_cell(arch: str, cfg, shape: ShapeSpec, mesh, smoke: bool, dev,
              mode: RecordingMode) -> Cell:
    from repro_torch.configs.gnn_archs import with_shape_dims
    cfg = with_shape_dims(cfg, shape.name)
    if smoke:
        cfg = dataclasses.replace(cfg, d_in=min(cfg.d_in, 32), n_rbf=16)
    mapping = _mapping_for(mesh)
    mesh_size = _size(mesh, _all_axes(mesh))
    n, e, b = _gnn_batch_sds(cfg, shape, smoke, mesh_size)
    opt = adamw(1e-3)
    nodes, dp = P(_all_axes(mesh)), P(_dp(mesh))
    nodes2 = P(_all_axes(mesh), None)
    is_schnet = cfg.arch == "schnet"

    if shape.name == "minibatch_lg":
        bn = shape.extra("batch_nodes")
        fanout = shape.extra("fanout")
        if smoke:
            bn, fanout = 8, (3, 2)

        def loss_fn(p, batch):
            # the sampler and the gathers run on the whole graph arrays
            # (a replicate detour: DTensor has no rule for them)
            gen = torch.Generator(device=dev).manual_seed(SAMPLER_SEED)
            seeds = full(batch["seeds"])
            nodes_, blocks = sample_khop(gen, full(batch["row_ptr"]),
                                         full(batch["col"]), seeds, fanout)
            src = torch.cat([bl.src_local + 0 for bl in blocks])
            dst = torch.cat([bl.dst_local for bl in blocks])
            m = nodes_.shape[0]
            if is_schnet:
                inputs = dict(
                    atom_z=_take_clip(full(batch["atom_z"]), nodes_),
                    pos=_take_clip(full(batch["pos"]), nodes_),
                    src=src, dst=dst,
                    mol_id=torch.zeros((m,), dtype=I32, device=dev))
                labels = torch.zeros((1,), dtype=F32, device=dev)
                return gnn_lib.gnn_loss(p, cfg, inputs, labels)
            x = _take_clip(full(batch["x"]), nodes_)
            out_mask = torch.zeros((m,), dtype=F32, device=dev)
            out_mask[:bn] = 1.0
            labels = torch.zeros((m,), dtype=I32, device=dev)
            labels[:bn] = _take_clip(full(batch["labels"]), seeds)
            inputs = dict(x=x, src=src, dst=dst)
            return gnn_lib.gnn_loss(p, cfg, inputs, labels, out_mask)

        specs = {"row_ptr": ((n + 1,), I32, nodes), "col": ((e,), I32, nodes),
                 "seeds": ((bn,), I32, dp), "labels": ((n,), I32, nodes)}
        if is_schnet:
            specs.update(atom_z=((n,), I32, nodes), pos=((n, 3), F32, nodes2))
        else:
            specs.update(x=((n, cfg.d_in), F32, nodes2))
        note = ("sampler on the whole graph arrays (replicate detour); seed "
                "a host int")
    else:
        n_tot = n * b if shape.name == "molecule" else n
        e_tot = e * b if shape.name == "molecule" else e
        n_tot = -(-n_tot // mesh_size) * mesh_size
        e_tot = -(-e_tot // mesh_size) * mesh_size

        def loss_fn(p, batch):
            if is_schnet:
                inputs = dict(atom_z=batch["atom_z"], pos=batch["pos"],
                              src=batch["src"], dst=batch["dst"],
                              mol_id=batch["mol_id"])
                return gnn_lib.gnn_loss(p, cfg, inputs, batch["energy"])
            inputs = dict(x=batch["x"], src=batch["src"], dst=batch["dst"])
            return gnn_lib.gnn_loss(p, cfg, inputs, batch["labels"],
                                    batch["label_mask"])

        specs = {"src": ((e_tot,), I32, nodes), "dst": ((e_tot,), I32, nodes)}
        if is_schnet:
            specs.update(atom_z=((n_tot,), I32, nodes),
                         pos=((n_tot, 3), F32, nodes2),
                         mol_id=((n_tot,), I32, nodes),
                         energy=((max(b, 1),), F32, P(None)))
        else:
            specs.update(x=((n_tot, cfg.d_in), F32, nodes2),
                         labels=((n_tot,), I32, nodes),
                         label_mask=((n_tot,), F32, nodes))
        note = ("the whole GAT on every rank (replicate detour)"
                if cfg.arch == "gat" else "")

    with _made(mode):
        model = gnn_lib.init_gnn(cfg, _generator(dev), dev)
        state = _model_and_state(model, gnn_param_specs(model), opt, mesh,
                                 mapping)
        batch = _placed(specs, mesh, dev)
    fn = _train_fn(loss_fn, opt, mesh, mapping)
    return Cell(arch, shape.name, fn, (model, state, batch),
                estimate_model_flops("gnn", cfg, shape), mapping, note=note,
                mode=mode)


# -------------------------------------------------------------- recsys cells

def _dlrm_cell(arch: str, cfg, shape: ShapeSpec, mesh, smoke: bool, dev,
               mode: RecordingMode) -> Cell:
    mapping = _mapping_for(mesh)
    b = shape.global_batch
    dp = _dp(mesh)
    if smoke:
        b = max(_size(mesh, dp), 4)
    opt = adamw(1e-3) if shape.kind == "train" else None
    if shape.name == "retrieval_cand":
        mapping = _mapping_for(mesh, {"dp": None})
    with _made(mode):
        model = dlrm_lib.init_dlrm(cfg, _generator(dev), dev)
        state = _model_and_state(model, dlrm_param_specs(model), opt, mesh,
                                 mapping)
    if shape.kind == "train":
        with _made(mode):
            batch = _placed({"dense": ((b, cfg.n_dense), F32, P(dp, None)),
                             "sparse": ((b, cfg.n_sparse), I32, P(dp, None)),
                             "labels": ((b,), F32, P(dp))}, mesh, dev)

        def loss_fn(p, batch):
            return dlrm_lib.dlrm_loss(p, cfg, batch["dense"],
                                      batch["sparse"], batch["labels"])

        fn = _train_fn(loss_fn, opt, mesh, mapping)
        args = (model, state, batch)
    elif shape.name == "retrieval_cand":
        nc = shape.extra("n_candidates")
        if smoke:
            nc = 512
        with _made(mode):
            ins = _placed({"dense": ((b, cfg.n_dense), F32, P(None, None)),
                           "sparse": ((b, cfg.n_sparse), I32, P(None, None)),
                           "cand": ((nc, cfg.embed_dim), F32,
                                    P("model", None))}, mesh, dev)

        def fn(params, dense, sparse, cand):
            with sharding_rules(mesh, mapping):
                return dlrm_lib.retrieval_score(params, cfg, dense, sparse,
                                                cand, top_k=100)
        args = (model, ins["dense"], ins["sparse"], ins["cand"])
    else:                                        # serve_p99 / serve_bulk
        with _made(mode):
            ins = _placed({"dense": ((b, cfg.n_dense), F32, P(dp, None)),
                           "sparse": ((b, cfg.n_sparse), I32, P(dp, None))},
                          mesh, dev)

        def fn(params, dense, sparse):
            with sharding_rules(mesh, mapping):
                return dlrm_lib.apply_dlrm(params, cfg, dense, sparse)
        args = (model, ins["dense"], ins["sparse"])

    return Cell(arch, shape.name, fn, args,
                estimate_model_flops("recsys", cfg, shape), mapping,
                mode=mode)


# ---------------------------------------------------------------- SSSP cells

def _sssp_cell(arch: str, cfg, shape: ShapeSpec, mesh, smoke: bool, dev,
               mode: RecordingMode) -> Cell:
    names = axis_names(mesh)
    n = cfg.n_nodes if not smoke else 2048
    deg = cfg.avg_degree if not smoke else 6
    dp_prod = _size(mesh, [a for a in ("data", "pod") if a in names])
    # sources shard over the batch axes: round up to a full multiple
    n_sources = max(cfg.n_sources, dp_prod) if not smoke else dp_prod
    n_sources = -(-n_sources // dp_prod) * dp_prod
    p_model = _size(mesh, ["model"])
    shard_nodes = -(-n // p_model)
    edges = n * deg
    cap = -(-(-(-edges // p_model) // 128) * 128 * 5 // 4)  # 1.25x slack
    batch_axes = tuple(a for a in ("pod", "data") if a in names)
    dcfg = DistDeltaConfig(delta=cfg.delta, combine=cfg.combine,
                           local_steps=cfg.local_steps,
                           batch_axes=batch_axes)
    solve = build_solver_from_meta(n_nodes=n, shard_nodes=shard_nodes,
                                   mesh=mesh, cfg=dcfg, device=dev)
    with _made(mode):
        sources = place(input_specs_sssp(n_sources, n, device=dev)["sources"],
                        P(batch_axes), mesh)
        edge = {k: ((p_model, cap), I32, P("model")) for k in
                ("src", "dst", "w")}
        edge["vstart"] = ((p_model,), I32, P("model"))
        ins = _placed(edge, mesh, dev)

    def fn(sources, src, dst, w, vstart):
        # each rank's own blocks: its sources, its edge row, its vstart
        return solve.step(sources.to_local(), src.to_local()[0],
                          dst.to_local()[0], w.to_local()[0],
                          vstart.to_local()[0])

    args = (sources, ins["src"], ins["dst"], ins["w"], ins["vstart"])
    return Cell(arch, shape.name, fn, args,
                estimate_model_flops("sssp", cfg, shape),
                {"batch_axes": batch_axes, "model": "model"},
                note=f"combine={cfg.combine} n={n} deg={deg}; one step; the "
                "trip count is data-dependent", mode=mode)


# ------------------------------------------------------------------ dispatch

def build_cell(arch: str, shape_name: str, mesh, smoke: bool = False,
               device=None, layers: Optional[int] = None,
               batch: Optional[int] = None, real: bool = False) -> Cell:
    """The cell's stand-ins on ``mesh`` (a ``DeviceMesh``, over a fake
    process group in the dry run), as fake tensors on ``device``
    (default CUDA; raises without one). Cuts for a run on one card:
    ``layers`` (an LM's depth) and ``batch`` (an LM's global batch).
    ``real``: real tensors instead of fakes (weights drawn from a
    generator seeded 0, the other inputs zero) for running ``fn`` on a
    real mesh; such a cell has no ``trace()``."""
    dev = resolve_device(device)
    family = family_of(arch)
    cfg = get_config(arch, smoke=smoke)
    shape = get_shape(arch, shape_name)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if batch is not None:
        shape = dataclasses.replace(shape, global_batch=batch)
    mode = None if real else RecordingMode()
    builders = {"lm": _lm_cell, "gnn": _gnn_cell, "recsys": _dlrm_cell,
                "sssp": _sssp_cell}
    if family not in builders:
        raise ValueError(family)
    return builders[family](arch, cfg, shape, mesh, smoke, dev, mode)
