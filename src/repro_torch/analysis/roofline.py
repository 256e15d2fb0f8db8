"""Roofline terms of one traced step (counterpart of
``repro.analysis.roofline``).

Target hardware: one NVIDIA H100 80GB HBM3 (SXM5) at its 700 W power
limit, data-sheet numbers (constants below). A card set to a lower
power limit runs slower under load, so every prediction here stands
beside the card's name and power limit.

The record (``analysis/trace.py``) holds per-device quantities, the
rank's local ops on its shards, so with

    flops_dev, bytes_dev, wire_dev  = per-device per-step quantities

the three terms (seconds, global step time lower bounds) are, as in the
reference,

    compute    = flops_dev / peak_flops
    memory     = bytes_dev / hbm_bw
    collective = wire_dev  / link_bw

What the port counts:

* ``flops_dev``: ``torch.utils.flop_counter``'s registry (matrix
  products, convolutions, attention) applied to the local ops' shapes,
  every layer. XLA's ``cost_analysis`` counts elementwise operations
  too, and the body of a scanned layer stack once.
* ``bytes_dev``: input plus output bytes of each local op that moves
  data (views, ``prim.device``, ``empty*`` and ``wait_tensor`` count 0;
  collectives count only in ``wire_dev``). Eager PyTorch runs every op
  as a kernel, so this sum is what the eager step moves; XLA's ``bytes
  accessed`` is counted after fusion and is the smaller.
* ``memory_analysis``, per device: arguments, the stand-ins' local
  bytes; temps, the peak of live local bytes allocated during the step
  less the new outputs still live at its end; outputs, the returned
  tensors' bytes; alias, the outputs that are arguments updated in
  place (the port's train step writes the parameters in place where the
  reference donates them). ``arguments + temps + outputs - alias`` is
  then the arguments plus the peak of what the step allocated.

MODEL_FLOPS uses 6·N·D (train) or 2·N·D (forward-only), with N =
active params for MoE; the ratio MODEL_FLOPS / (flops_dev × chips)
exposes remat/padding/redundancy waste.
"""
from __future__ import annotations

import dataclasses
import json

from repro_torch.analysis.trace import StepTrace, collective_stats

# NVIDIA H100 80GB HBM3 (SXM5), 700 W: NVIDIA H100 Tensor Core GPU data
# sheet (dense rates, without sparsity)
H100 = {
    "peak_flops": 989e12,    # bf16 dense FLOP/s per card
    "hbm_bw": 3.35e12,       # HBM3 bytes/s per card
    "link_bw": 450e9,        # NVLink 4 bytes/s a direction (900 both)
    "hbm_bytes": 80e9,       # 80 GB of HBM3
}


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_per_dev: float
    bytes_per_dev: float
    wire_bytes_per_dev: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float          # MODEL_FLOPS / global flops
    peak_fraction: float         # compute_s / max(term) — roofline fraction
    collectives: dict
    memory_analysis: dict
    note: str = ""

    def to_json(self):
        return dataclasses.asdict(self)

    def summary(self) -> str:
        return (f"{self.arch:>22s} {self.shape:>13s} {self.mesh:>5s} | "
                f"C {self.compute_s:9.3e}s M {self.memory_s:9.3e}s "
                f"X {self.collective_s:9.3e}s -> {self.dominant:10s} | "
                f"useful {self.useful_ratio:6.1%} roofline "
                f"{self.peak_fraction:6.1%}")


def memory_analysis(trace: StepTrace) -> dict:
    """The reference's ``memory_analysis`` keys, per device (module
    note)."""
    new_out = trace.output_bytes - trace.in_place_bytes
    return {"argument_size_in_bytes": int(trace.argument_bytes),
            "output_size_in_bytes": int(trace.output_bytes),
            "temp_size_in_bytes": int(max(trace.peak_temp_bytes - new_out,
                                          0)),
            "alias_size_in_bytes": int(trace.in_place_bytes)}


def analyze(trace: StepTrace, *, arch: str, shape: str, mesh_name: str,
            n_devices: int, model_flops: float, hw: dict = H100,
            note: str = "") -> RooflineReport:
    flops_dev = trace.flops
    bytes_dev = trace.bytes
    coll = collective_stats(trace)
    wire_dev = float(coll["total"]["wire_bytes"])

    compute_s = flops_dev / hw["peak_flops"]
    memory_s = bytes_dev / hw["hbm_bw"]
    collective_s = wire_dev / hw["link_bw"]
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    global_flops = flops_dev * n_devices
    useful = model_flops / global_flops if global_flops else 0.0
    bound = max(terms.values())
    peak_fraction = (compute_s / bound) if bound > 0 else 0.0

    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, n_devices=n_devices,
        flops_per_dev=flops_dev, bytes_per_dev=bytes_dev,
        wire_bytes_per_dev=wire_dev, compute_s=compute_s, memory_s=memory_s,
        collective_s=collective_s, dominant=dominant,
        model_flops=model_flops, useful_ratio=useful,
        peak_fraction=peak_fraction, collectives=coll,
        memory_analysis=memory_analysis(trace), note=note)


def estimate_model_flops(family: str, cfg, shape) -> float:
    """Napkin MODEL_FLOPS per step (global), per family."""
    if family == "lm":
        n_active = cfg.n_active_params()
        if shape.kind == "train":
            tokens = shape.global_batch * shape.seq_len
            return 6.0 * n_active * tokens
        if shape.kind == "prefill":
            tokens = shape.global_batch * shape.seq_len
            return 2.0 * n_active * tokens
        # decode: one token per sequence + attention over the cache
        attn = (2.0 * 2.0 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim_
                * shape.seq_len * shape.global_batch)
        return 2.0 * n_active * shape.global_batch + attn
    if family == "gnn":
        n = shape.extra("n_nodes")
        e = shape.extra("n_edges")
        b = shape.extra("batch", 1)
        if shape.name == "minibatch_lg":
            bn = shape.extra("batch_nodes")
            f = shape.extra("fanout")
            n = bn * (1 + f[0] + f[0] * f[1])
            e = bn * f[0] * (1 + f[1])
        d = cfg.head_hidden()
        # per layer: node transform (N·d_in·d_out GEMM) + edge traffic
        node_flops = 2.0 * n * b * max(cfg.d_in, d) * d
        edge_flops = 4.0 * e * b * d
        return 3.0 * cfg.n_layers * (node_flops + edge_flops)  # fwd+bwd
    if family == "recsys":
        b = shape.global_batch
        mlp = 0
        dims = (cfg.n_dense,) + cfg.bot_mlp
        mlp += sum(2 * a * c for a, c in zip(dims[:-1], dims[1:]))
        f = 1 + cfg.n_sparse
        d_int = cfg.embed_dim + f * (f - 1) // 2
        dims = (d_int,) + cfg.top_mlp
        mlp += sum(2 * a * c for a, c in zip(dims[:-1], dims[1:]))
        inter = 2 * f * f * cfg.embed_dim
        factor = 3.0 if shape.kind == "train" else 1.0
        flops = factor * b * (mlp + inter)
        if shape.name == "retrieval_cand":
            flops += 2.0 * shape.extra("n_candidates") * cfg.embed_dim
        return flops
    if family == "sssp":
        # relaxation work: ~4 int-ops per edge per sweep; sweeps ~ ln(V)
        import math
        e = cfg.n_nodes * cfg.avg_degree
        sweeps = max(4, int(math.log(max(cfg.n_nodes, 2))))
        return 4.0 * e * sweeps * cfg.n_sources
    raise ValueError(family)


def save_reports(path: str, reports):
    with open(path, "w") as f:
        json.dump([r.to_json() for r in reports], f, indent=1)


def load_reports(path: str):
    with open(path) as f:
        return json.load(f)
