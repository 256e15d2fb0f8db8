"""Batched serving of the PyTorch port (counterpart of
``repro.serve.decode``): two workloads behind the same submit/step/drain
idiom —

* LM decode: prefill and greedy decode over a preallocated KV cache
  (``generate``), and a slot-based continuous-batching server for mixed
  request streams (``BatchServer``).
* SSSP queries: the deprecated synchronous ``SSSPServer`` shim over the
  async serving tier (``repro_torch.serve.Server``).

The model runs where its parameters are (``init_lm``'s device).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import LMConfig
from repro_torch.models.transformer import decode_step, init_cache, prefill


def _device(params) -> torch.device:
    return next(params.parameters()).device


def _argmax_last(logits):
    """Greedy pick of each row's last position (the first of equal
    maxima, as ``jnp.argmax``)."""
    return torch.argmax(logits[:, -1], dim=-1)


@torch.no_grad()
def generate(params, cfg: LMConfig, prompts, n_new: int, max_len=None):
    """prompts int[B, S] → generated int32[B, n_new] (greedy): the
    prefill's pick, then one decode step per further token."""
    dev = _device(params)
    prompts = torch.as_tensor(np.asarray(prompts), device=dev)
    b, s = prompts.shape
    max_len = max_len or (s + n_new)
    cache = init_cache(cfg, b, max_len, device=dev)
    logits, cache = prefill(params, cfg, prompts, cache)
    toks = [_argmax_last(logits)]
    for _ in range(n_new - 1):
        logits, cache = decode_step(params, cfg, cache, toks[-1][:, None])
        toks.append(_argmax_last(logits))
    return torch.stack(toks, dim=1).to(torch.int32)      # (B, n_new)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False


class BatchServer:
    """Slot-based continuous batching: up to ``n_slots`` concurrent
    sequences share one batched KV cache; finished slots are refilled
    from the queue. Prefills run per request at admission, then one
    decode step serves every slot.

    The cache has one length for all slots, as in the reference: the
    longest active slot's prompt-plus-generated length. A slot shorter
    than that writes its next K/V at the shared length and attends over
    the zero-filled gap, so its tokens can differ from ``generate``'s
    on its prompt alone."""

    def __init__(self, params, cfg: LMConfig, n_slots: int, max_len: int,
                 eos_id: int = 1):
        self.params, self.cfg = params, cfg
        self.n_slots, self.max_len, self.eos = n_slots, max_len, eos_id
        self.device = _device(params)
        self.cache = init_cache(cfg, n_slots, max_len, device=self.device)
        self.slots: List[Optional[Request]] = [None] * n_slots
        self.queue: List[Request] = []

    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for i in range(self.n_slots):
            if self.slots[i] is None and self.queue:
                req = self.queue.pop(0)
                # per-slot prefill into the shared cache
                sub = init_cache(self.cfg, 1, self.max_len,
                                 device=self.device)
                prompt = torch.as_tensor(np.asarray(req.prompt)[None],
                                         device=self.device)
                logits, sub = prefill(self.params, self.cfg, prompt, sub)
                for kk in ("k", "v"):
                    self.cache[kk][:, i:i + 1] = sub[kk]
                req.generated.append(int(_argmax_last(logits)[0]))
                self.slots[i] = req
        # shared scalar length: slots track their own logical lengths; the
        # cache len is the max prompt+generated across active slots
        lens = [len(r.prompt) + len(r.generated)
                for r in self.slots if r is not None]
        if lens:
            self.cache["len"] = max(lens)

    @torch.no_grad()
    def step(self):
        self._admit()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return []
        toks = np.zeros((self.n_slots, 1), np.int64)
        for i in active:
            toks[i, 0] = self.slots[i].generated[-1]
        logits, self.cache = decode_step(
            self.params, self.cfg, self.cache,
            torch.from_numpy(toks).to(self.device))
        nxt = _argmax_last(logits).cpu().numpy()
        finished = []
        for i in active:
            req = self.slots[i]
            req.generated.append(int(nxt[i]))
            if len(req.generated) >= req.max_new or int(nxt[i]) == self.eos:
                req.done = True
                finished.append(req)
                self.slots[i] = None
        return finished

    def run_to_completion(self, max_steps: int = 10_000):
        done = []
        for _ in range(max_steps):
            done += self.step()
            if not self.queue and all(s is None for s in self.slots):
                break
        return done


# ---------------------------------------------------------------------------
# batched SSSP serving
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SSSPQuery:
    """One shortest-path query. ``target=None`` asks for the full
    distance vector; a concrete target additionally extracts the path
    from the predecessor tree (requires pred_mode != 'none')."""

    qid: int
    source: int
    target: Optional[int] = None
    dist: Optional[np.ndarray] = None     # int64[n] (or scalar to target)
    path: Optional[List[int]] = None
    done: bool = False


class SSSPServer:
    """Microbatching SSSP server — a **deprecated** thin shim over the
    async serving tier (prefer ``repro_torch.serve.Server``). The shim
    hosts one tenant named ``"graph"`` on a private ``Server`` with
    ``lane_width=batch_size`` and keeps the legacy synchronous cadence:
    ``step()`` submits queued weight updates first (they apply between
    microbatches, through the same ``UpdateBatch`` submit path queries
    use), then up to ``batch_size`` queries, and drains the batch loop
    inline.

    ``config="auto"`` resolves (Δ, backend, packing) through the tuner
    at graph-load time, as ``Engine(graph, tuning=...)`` does, and the
    resolved ``TuningRecord`` attaches to the plan (``server.plan.record``).
    ``device``: where the server solves (default CUDA; raises without
    one).
    """

    def __init__(self, graph, config=None, *, batch_size: int = 8,
                 free_mask=None, tune: bool = False,
                 tune_cache: Optional[str] = None, device=None):
        import warnings

        warnings.warn(
            "SSSPServer is deprecated: use repro_torch.serve.Server (async "
            "serving tier, DESIGN.md §13) or repro_torch.api.Engine(...)"
            ".plan(fallback=True) with MultiSource queries (DESIGN.md §10)",
            DeprecationWarning, stacklevel=2)
        from repro_torch.api import Tuning
        from repro_torch.core import DeltaConfig
        from repro_torch.serve.server import Server

        # legacy knob translation: config="auto" meant resolve from
        # scratch; a concrete config survives as the tuning *base* so
        # its non-searched fields (pred_mode, n_shards, ...) carry into
        # the tuned result
        if isinstance(config, str):
            if config != "auto":
                raise ValueError(f"config must be 'auto', got {config!r}")
            base = None
            tuning = Tuning(measure=bool(tune), cache=tune_cache)
        else:
            base = config or DeltaConfig()
            tuning = (Tuning(measure=bool(tune), cache=tune_cache)
                      if (tune or tune_cache is not None) else None)
        self._server = Server(config=base, tuning=tuning,
                              lane_width=batch_size, device=device)
        self._server.admit("graph", graph, free_mask=free_mask)
        # the legacy server tuned eagerly at graph load: srv.config is
        # the resolved DeltaConfig before the first query arrives
        self.config = self._server.plan("graph").config
        self.graph = graph
        self.free_mask = free_mask
        self.batch_size = batch_size
        self.queue: List[SSSPQuery] = []
        self._pending_updates: List[tuple] = []

    @property
    def plan(self):
        """The underlying ``repro_torch.api.Plan`` (tuning record
        included)."""
        return self._server.plan("graph")

    def submit(self, query: SSSPQuery):
        if query.target is not None and self.config.pred_mode == "none":
            raise ValueError("point-to-point queries need a pred_mode")
        self.queue.append(query)

    def update(self, edge_ids, new_weights):
        """Queue a dynamic edge-cost update batch. Updates apply to the
        resident plan *between* query microbatches — at the start of the
        next ``step()`` — so every query inside a batch is answered
        against one consistent weight snapshot."""
        self._pending_updates.append((edge_ids, new_weights))

    def step(self) -> List[SSSPQuery]:
        """Serve one microbatch; returns the completed queries. Pending
        weight updates are applied first (between microbatches)."""
        from repro_torch.api import PointToPoint, SingleSource, UpdateBatch
        upd_tickets = [
            self._server.submit(UpdateBatch(edge_ids, new_weights))
            for edge_ids, new_weights in self._pending_updates]
        self._pending_updates = []
        batch = self.queue[:self.batch_size]
        self.queue = self.queue[self.batch_size:]
        tickets = [
            self._server.submit(
                SingleSource(q.source) if q.target is None
                else PointToPoint(q.source, q.target))
            for q in batch]
        self._server.drain()
        if upd_tickets:
            self.graph = self.plan.graph
            for t in upd_tickets:
                t.result()                   # surface refused updates
        for q, t in zip(batch, tickets):
            res = t.result()
            if q.target is None:
                q.dist = np.asarray(res.dist.cpu(), np.int64)
            else:
                q.dist = np.int64(res.distance)
                q.path = res.path
            q.done = True
        return batch

    def run_to_completion(self, max_steps: int = 10_000):
        done = []
        for _ in range(max_steps):
            if not self.queue:
                break
            done += self.step()
        return done
