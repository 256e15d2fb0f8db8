"""Async SSSP serving tier of the PyTorch port (counterpart of
``repro.serve.server``): continuous batching, multi-graph tenancy and
admission control over the Query/Plan façade (DESIGN.md §13).

The paper's result is that shared-memory SSSP wins by amortizing work
into large uniform batches. ``Server`` lifts that discipline to the
serving layer: an async request queue is drained *continuously* into
microbatches of ``MultiSource`` lanes. Every tenant's ``Engine`` runs
on the server's ``device`` (default: CUDA, or raise; ``"cpu"`` runs the
kernels' twins).

* **Continuous batching.** ``submit(query)`` returns a future-style
  ``Ticket`` immediately; the batch former takes the tenant owning the
  oldest pending request and packs up to ``lane_width`` consecutive
  lane-able queries (``SingleSource`` / ``PointToPoint`` /
  ``BoundedRadius`` — one multi-source lane each, short batches padded
  by repeating the last source so every batch has one shape).
  ``MultiSource`` / ``ManyToMany`` run as solo batches through the
  plan's own dispatch; per-tenant FIFO order is never reordered, so
  answers are bitwise what a serial ``plan.solve`` stream would give
  (tests/test_torch_serve.py holds them to the reference's tier).
* **Multi-graph tenancy.** Each admitted graph is a *tenant*; resident
  ``Plan``s live in an LRU bounded by ``max_resident``. Eviction drops
  the plan but keeps the (possibly updated) graph; a
  re-admitted tenant re-resolves through the same ``tuning`` inputs —
  with a tuning cache, the fingerprint-keyed record makes the re-built
  plan bitwise identical to the evicted one.
* **Streamed updates.** ``UpdateBatch`` rides the same submit path as
  queries and is applied *between* microbatches on the owning plan, so
  every query batch sees one consistent weight snapshot. A plan that
  refuses an update (``api.UpdateRefused``, e.g. grid-stencil costs)
  sheds that one ticket; the batch loop keeps serving.
* **Admission control.** A full queue (``max_queue``) sheds at submit;
  an expired ``deadline`` sheds at batch-form time — both resolve the
  ticket with a typed ``RequestRejected`` carrying the reason. An
  accepted request is never dropped: every ticket resolves with a
  result or a typed rejection.

* **Process groups.** In an initialised ``torch.distributed`` group of
  more than one rank, every rank builds the same ``Server`` with the
  same tenants (one script under ``torchrun``), and rank 0 is the front
  end: only rank 0 takes ``submit``, forms batches (deadline shedding
  on its clock, lane packing, update grouping) and keeps tickets.
  Before it executes a batch, or builds a plan for ``plan()``, it
  writes the step to the group's store; the other ranks read the steps
  in order and run the same plan builds, evictions, updates and solves,
  so every collective of a ``sharded_*`` tenant (and of a measured
  tuning search) meets the same collective on every rank. Every tenant
  is solved on every rank, sharded or not. The other ranks wait on the
  store with a timeout that re-arms while rank 0 idles, never in a
  collective; ``drain()``, ``close()`` and ``with Server(...)`` serve
  rank 0's steps there until ``close()`` on rank 0 sends the stop. A
  ``ValueError`` of a solve (``UpdateRefused`` too) is a ticket
  rejection on rank 0 and passes on the other ranks; any other
  exception there propagates.

Per-request telemetry (``Ticket.trace``) records the
enqueue→batch→solve→extract timestamps and batch occupancy;
``Server.stats()`` aggregates them into p50/p99 latency, shed counts
and occupancy.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import pickle
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.api import (
    BoundedRadius,
    BoundedRadiusResult,
    Engine,
    ManyToMany,
    MultiSource,
    PointToPoint,
    PointToPointResult,
    SingleSource,
    SingleSourceResult,
    Telemetry,
    UpdateBatch,
    UpdateRefused,
    extract_path,
)
from repro_torch.core.backends import group_size
from repro_torch.core.delta_stepping import P2P_MODES
from repro_torch.device import resolve_device
from repro_torch.graphs.structures import INF32

# query kinds that occupy exactly one multi-source lane each; anything
# else runs as a solo batch through the plan's own dispatch
_LANE_KINDS = (SingleSource, PointToPoint, BoundedRadius)
_QUERY_KINDS = _LANE_KINDS + (MultiSource, ManyToMany, UpdateBatch)


def _lane_able(query) -> bool:
    """Lane batches answer PointToPoint from a full single-source lane
    — correct, but it would silently ignore an explicitly requested
    goal-directed mode (repro_torch.landmarks), so mode-carrying queries run
    solo through the plan's own dispatch instead."""
    if not isinstance(query, _LANE_KINDS):
        return False
    return not (isinstance(query, PointToPoint) and query.mode is not None)

# ``admit``'s default: the tenant resolves with the server's ``tuning``
_SERVER_TUNING = object()

# how long a rank other than 0 waits on the store for rank 0's next
# step before it waits again (an idle server never fails)
_CONTROL_TIMEOUT = datetime.timedelta(seconds=30)
# every rank builds its servers in the same order, so the n-th server
# of each rank shares the n-th channel
_CHANNEL_IDS = itertools.count()

# bounded ring of completed-request latencies backing stats()'s
# percentiles — enough for a load sweep, O(1) memory under sustained
# traffic
_LATENCY_WINDOW = 10_000


class RequestRejected(RuntimeError):
    """Typed admission-control rejection. ``reason`` is a stable tag:
    ``"queue_full"`` (depth cap at submit), ``"deadline"`` (expired at
    batch-form time), ``"update_refused"`` (the owning plan refused the
    update — see ``api.UpdateRefused``), ``"invalid"`` (malformed
    query), ``"closed"`` (server shut down without draining)."""

    def __init__(self, reason: str, detail: str = ""):
        msg = f"request rejected ({reason})"
        super().__init__(f"{msg}: {detail}" if detail else msg)
        self.reason = reason
        self.detail = detail


@dataclasses.dataclass
class RequestTrace:
    """Per-request serving telemetry: where one request's latency went.
    Timestamps are ``clock()`` values (``time.monotonic`` by default);
    ``t_batch``/``t_solve``/``t_done`` stay ``None`` for requests shed
    before reaching that stage. ``batch_occupancy`` is real lanes /
    ``lane_width`` for lane batches, 1.0 for solo and update batches."""

    tenant: str
    kind: str
    t_submit: float
    t_batch: Optional[float] = None
    t_solve: Optional[float] = None
    t_done: Optional[float] = None
    batch_occupancy: Optional[float] = None
    shed: Optional[str] = None

    @property
    def latency(self) -> Optional[float]:
        if self.t_done is None:
            return None
        return self.t_done - self.t_submit


@dataclasses.dataclass(frozen=True)
class UpdateApplied:
    """Acknowledgement for an ``UpdateBatch`` applied to a plan with no
    resident single-source answer to re-solve (the serving tier answers
    queries through batched lanes, which do not establish residency):
    the weights are swapped, the next batch sees them."""

    n_edges: int


class Ticket:
    """Future-style handle for one submitted request. ``result()``
    blocks until the batch loop resolves it, returning the query's
    typed result (or raising the typed rejection/error); ``trace``
    carries the per-request serving telemetry."""

    def __init__(self, trace: RequestTrace):
        self.trace = trace
        self._event = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("request not served yet")
        if self._exc is not None:
            raise self._exc
        return self._result

    def exception(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("request not served yet")
        return self._exc

    def _resolve(self, result) -> None:
        self._result = result
        self._event.set()

    def _reject(self, exc: BaseException) -> None:
        self._exc = exc
        self._event.set()


@dataclasses.dataclass
class _Pending:
    seq: int
    query: object
    ticket: Ticket
    deadline: Optional[float]  # absolute clock() value


@dataclasses.dataclass
class _Tenant:
    name: str
    graph: object
    config: object
    free_mask: object
    tuning: object
    queue: deque = dataclasses.field(default_factory=deque)
    plan: object = None
    last_used: int = -1
    served: int = 0


@dataclasses.dataclass
class _Batch:
    tenant: _Tenant
    kind: str  # "lanes" | "solo" | "update"
    items: List[_Pending]


def _portable(query):
    """``query`` with its tensors as host numpy arrays, for the other
    ranks (a CUDA tensor names rank 0's device)."""
    fields = {f.name: getattr(query, f.name)
              for f in dataclasses.fields(query)}
    moved = {k: v.cpu().numpy() for k, v in fields.items()
             if isinstance(v, torch.Tensor)}
    return dataclasses.replace(query, **moved) if moved else query


class _Channel:
    """Rank 0's steps to the other ranks of the default process group,
    through the group's store: step ``k`` is the pickled message under
    key ``k``, deleted by the last rank to read it. A reader waits for
    the next key ``timeout`` at a time and waits again while rank 0
    idles; any store error other than that timeout propagates."""

    def __init__(self, timeout: datetime.timedelta):
        from torch.distributed.distributed_c10d import _get_default_store
        self.store = dist.PrefixStore(
            f"repro_torch.serve/{next(_CHANNEL_IDS)}/", _get_default_store())
        self.readers = dist.get_world_size() - 1
        self.timeout = timeout
        self.seq = 0

    def send(self, msg) -> None:
        self.store.set(str(self.seq), pickle.dumps(msg))
        self.seq += 1

    def recv(self):
        key = str(self.seq)
        while True:
            try:
                self.store.wait([key], self.timeout)
                break
            except RuntimeError as e:   # FileStore and TCPStore's timeout
                if "wait timeout" not in str(e).lower():
                    raise
        msg = pickle.loads(self.store.get(key))
        if self.store.add(f"read/{key}", 1) == self.readers:
            self.store.delete_key(key)
            self.store.delete_key(f"read/{key}")
        self.seq += 1
        return msg


class Server:
    """The serving tier. ``graphs`` is a ``{name: COOGraph}`` mapping
    (or a single graph, admitted as ``"default"``); ``config`` is the
    per-tenant ``DeltaConfig`` base and ``tuning`` the ``Engine``
    resolution knob, both shared by every tenant unless ``admit``
    overrides them (the reference's ``admit`` takes ``config`` only; the
    port's takes ``tuning`` too, so one server can hold a tuned tenant
    beside pinned ones); ``device`` is where every tenant's ``Engine``
    runs.
    Inline use: ``submit`` then ``drain()``/``pump()``.
    Async use: ``with Server(...) as srv:`` runs the batch loop on a
    background thread and ``close()`` drains it.
    In a process group of more than one rank (module note), rank 0 is
    used as above; on the other ranks ``drain()``, ``close()`` and
    ``with Server(...)`` run rank 0's steps until its ``close()``, and
    ``submit``, ``pump`` and ``plan`` raise.
    """

    def __init__(
        self,
        graphs=None,
        *,
        config=None,
        tuning=None,
        lane_width: int = 8,
        max_resident: Optional[int] = None,
        max_queue: int = 256,
        clock: Callable[[], float] = time.monotonic,
        landmarks=None,
        device=None,
    ):
        if lane_width < 1:
            raise ValueError(f"lane_width must be >= 1, got {lane_width}")
        if max_resident is not None and max_resident < 1:
            raise ValueError(f"max_resident must be >= 1, got {max_resident}")
        self.lane_width = int(lane_width)
        self.max_resident = max_resident
        self.max_queue = int(max_queue)
        self.device = resolve_device(device)
        self._config = config
        self._tuning = tuning
        # landmark residency knob (repro_torch.landmarks): Plan.prepare_landmarks
        # kwargs (or an int k) applied lazily to every tenant plan — the
        # table precompute itself runs on a tenant's first landmark-mode
        # query, so tenants that never ask for goal-directed point-to-
        # point never pay for it
        if isinstance(landmarks, int):
            landmarks = {"k": landmarks}
        self._landmarks = landmarks
        self._clock = clock
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._tenants: Dict[str, _Tenant] = {}
        self._seq = 0
        self._tick = 0
        self._thread: Optional[threading.Thread] = None
        self._closing = False
        # one order of plan builds and batches on every rank: rank 0
        # sends each step and runs it under this lock
        self._order = threading.RLock()
        self._rank = dist.get_rank() if group_size() > 1 else 0
        self._channel = (_Channel(_CONTROL_TIMEOUT) if group_size() > 1
                         else None)
        self._stopped = False     # the group's stop was sent / received
        # counters behind stats()
        self._submitted = 0
        self._completed = 0
        self._shed: Dict[str, int] = {}
        self._batches = {"lanes": 0, "solo": 0, "update": 0}
        self._occupancy_sum = 0.0
        self._evictions = 0
        self._plans_built = 0
        self._latencies = deque(maxlen=_LATENCY_WINDOW)
        if graphs is not None:
            if not isinstance(graphs, dict):
                graphs = {"default": graphs}
            for name, g in graphs.items():
                self.admit(name, g)

    # -- tenancy -------------------------------------------------------------

    def admit(self, name: str, graph, *, config=None, free_mask=None,
              tuning=_SERVER_TUNING) -> None:
        """Register a tenant graph. The plan is built lazily, on the
        tenant's first batch (and rebuilt after an LRU eviction).
        ``config`` and ``tuning`` override the server's for this tenant
        (``tuning=None``: the concrete ``config`` as is)."""
        with self._lock:
            if name in self._tenants:
                raise ValueError(f"tenant {name!r} already admitted")
            self._tenants[name] = _Tenant(
                name=name,
                graph=graph,
                config=config if config is not None else self._config,
                free_mask=free_mask,
                tuning=(self._tuning if tuning is _SERVER_TUNING
                        else tuning),
            )

    def plan(self, graph: Optional[str] = None):
        """The tenant's resident ``repro_torch.api.Plan`` (built — and LRU-
        touched — on access; in a group, on every rank)."""
        self._front_end("plan")
        with self._order, self._lock:
            tenant = self._tenant_locked(graph)
            self._send(("plan", tenant.name))
            return self._plan_locked(tenant)

    def _front_end(self, what: str) -> None:
        if self._rank:
            raise RuntimeError(
                f"{what}() on rank {self._rank}: in a process group, rank 0 "
                "is the server's front end and forms every batch; the "
                "other ranks follow its steps in drain(), close() or "
                "with Server(...)")

    def _send(self, msg) -> None:
        """Rank 0: the group's next step, before it runs here."""
        if self._channel is not None and not self._rank \
                and not self._stopped:
            self._channel.send(msg)

    def _tenant_locked(self, name: Optional[str]) -> _Tenant:
        if not self._tenants:
            raise ValueError("no tenant graphs admitted")
        if name is None:
            if len(self._tenants) > 1:
                raise ValueError(
                    f"server hosts {sorted(self._tenants)}: pass graph=<name>"
                )
            return next(iter(self._tenants.values()))
        try:
            return self._tenants[name]
        except KeyError:
            raise ValueError(
                f"unknown tenant {name!r} (admitted: {sorted(self._tenants)})"
            ) from None

    def _plan_locked(self, tenant: _Tenant):
        tenant.last_used = self._tick
        self._tick += 1
        if tenant.plan is None:
            tenant.plan = Engine(
                tenant.graph,
                tenant.config,
                free_mask=tenant.free_mask,
                tuning=tenant.tuning,
                device=self.device,
            ).plan(fallback=True)
            if self._landmarks is not None:
                tenant.plan.prepare_landmarks(**self._landmarks, build=False)
            self._plans_built += 1
            self._evict_locked(keep=tenant)
        return tenant.plan

    def _evict_locked(self, keep: _Tenant) -> None:
        if self.max_resident is None:
            return
        resident = [t for t in self._tenants.values() if t.plan is not None]
        while len(resident) > self.max_resident:
            victim = min(
                (t for t in resident if t is not keep),
                key=lambda t: t.last_used,
            )
            # updated weights outlive the plan: the tenant keeps the
            # plan's current graph, so a rebuild resumes from the same
            # weight state the evicted plan served
            victim.graph = victim.plan.graph
            victim.plan = None
            resident.remove(victim)
            self._evictions += 1

    # -- admission -----------------------------------------------------------

    def submit(self, query, *, graph: Optional[str] = None,
               deadline: Optional[float] = None) -> Ticket:
        """Enqueue one request; returns its ``Ticket`` immediately.
        ``graph`` names the tenant (optional when only one is admitted);
        ``deadline`` is a latency budget in seconds — a request still
        queued when it expires is shed at batch-form time. Admission
        failures (unknown tenant, full queue, malformed query) resolve
        the ticket with a typed ``RequestRejected`` instead of raising,
        so an open-loop generator never blocks on an overloaded server.
        """
        self._front_end("submit")
        now = self._clock()
        with self._work:
            trace = RequestTrace(tenant=graph or "?",
                                 kind=type(query).__name__, t_submit=now)
            ticket = Ticket(trace)
            self._submitted += 1
            if self._closing:
                return self._shed_locked(ticket, "closed", "server closed")
            try:
                tenant = self._tenant_locked(graph)
            except ValueError as e:
                return self._shed_locked(ticket, "invalid", str(e))
            trace.tenant = tenant.name
            err = self._validate(tenant, query)
            if err is not None:
                return self._shed_locked(ticket, "invalid", err)
            depth = sum(len(t.queue) for t in self._tenants.values())
            if depth >= self.max_queue:
                return self._shed_locked(
                    ticket, "queue_full",
                    f"queue depth {depth} at cap {self.max_queue}")
            self._seq += 1
            tenant.queue.append(_Pending(
                seq=self._seq, query=query, ticket=ticket,
                deadline=None if deadline is None else now + deadline))
            self._work.notify()
            return ticket

    def _validate(self, tenant: _Tenant, query) -> Optional[str]:
        """Host-side admission validation of the per-lane query kinds,
        so one malformed request cannot poison its batch-mates (solo
        kinds are validated by ``plan.solve`` and fail alone)."""
        if not isinstance(query, _QUERY_KINDS):
            return f"unknown query kind {type(query).__name__!r}"
        n = tenant.graph.n_nodes
        if isinstance(query, _LANE_KINDS) and not 0 <= int(query.source) < n:
            return f"source {query.source} out of range for {n} vertices"
        if isinstance(query, PointToPoint) and not 0 <= int(query.target) < n:
            return f"target {query.target} out of range for {n} vertices"
        if (isinstance(query, PointToPoint) and query.mode is not None
                and query.mode not in P2P_MODES):
            return f"unknown p2p mode {query.mode!r} (known: {P2P_MODES})"
        if isinstance(query, BoundedRadius) and not (
            0 <= int(query.radius) < int(INF32)
        ):
            return f"radius must be in [0, INF32), got {query.radius}"
        return None

    def _shed_locked(self, ticket: Ticket, reason: str, detail: str) -> Ticket:
        ticket.trace.shed = reason
        ticket.trace.t_done = self._clock()
        if not self._rank:        # tickets are rank 0's
            self._shed[reason] = self._shed.get(reason, 0) + 1
        ticket._reject(RequestRejected(reason, detail))
        return ticket

    # -- the batch loop ------------------------------------------------------

    def _has_work_locked(self) -> bool:
        return any(t.queue for t in self._tenants.values())

    def _form_batch_locked(self) -> Optional[_Batch]:
        now = self._clock()
        for tenant in self._tenants.values():
            if any(p.deadline is not None and p.deadline < now
                   for p in tenant.queue):
                kept = deque()
                for p in tenant.queue:
                    if p.deadline is not None and p.deadline < now:
                        self._shed_locked(
                            p.ticket, "deadline",
                            "deadline expired before batch formation")
                    else:
                        kept.append(p)
                tenant.queue = kept
        live = [t for t in self._tenants.values() if t.queue]
        if not live:
            return None
        # continuous batching: serve the tenant owning the oldest
        # pending request, never reordering within a tenant
        tenant = min(live, key=lambda t: t.queue[0].seq)
        head = tenant.queue[0]
        if isinstance(head.query, UpdateBatch):
            kind, items = "update", []
            while tenant.queue and isinstance(tenant.queue[0].query,
                                              UpdateBatch):
                items.append(tenant.queue.popleft())
        elif _lane_able(head.query):
            kind, items = "lanes", []
            while (tenant.queue and len(items) < self.lane_width
                   and _lane_able(tenant.queue[0].query)):
                items.append(tenant.queue.popleft())
        else:
            kind, items = "solo", [tenant.queue.popleft()]
        t_batch = self._clock()
        occupancy = (len(items) / self.lane_width if kind == "lanes" else 1.0)
        for p in items:
            p.ticket.trace.t_batch = t_batch
            p.ticket.trace.batch_occupancy = occupancy
        self._batches[kind] += 1
        self._occupancy_sum += occupancy
        return _Batch(tenant=tenant, kind=kind, items=items)

    def pump(self) -> int:
        """Form and execute one microbatch inline (no worker thread);
        returns the number of requests resolved (0 = nothing queued)."""
        self._front_end("pump")
        with self._lock:
            batch = self._form_batch_locked()
        if batch is None:
            return 0
        return self._execute(batch)

    def drain(self) -> None:
        """Serve inline until every queued request has resolved (on a
        group's other ranks: rank 0's steps until its stop)."""
        if self._rank:
            return self._follow()
        while self.pump():
            pass

    def _follow(self) -> None:
        """A rank other than 0: run rank 0's steps in its order, with
        placeholder tickets, until the stop."""
        while not self._stopped:
            msg = self._channel.recv()
            if msg[0] == "stop":
                self._stopped = True
            elif msg[0] == "plan":
                with self._lock:
                    self._plan_locked(self._tenant_locked(msg[1]))
            else:
                _, name, kind, queries = msg
                items = [_Pending(seq=0, query=q, deadline=None,
                                  ticket=Ticket(RequestTrace(
                                      name, type(q).__name__, 0.0)))
                         for q in queries]
                with self._lock:
                    self._batches[kind] += 1
                    self._occupancy_sum += (len(items) / self.lane_width
                                            if kind == "lanes" else 1.0)
                self._execute(_Batch(self._tenant_locked(name), kind, items))

    def _execute(self, batch: _Batch) -> int:
        with self._order:
            self._send(("batch", batch.tenant.name, batch.kind,
                        [_portable(p.query) for p in batch.items]))
            try:
                with self._lock:
                    plan = self._plan_locked(batch.tenant)
                if batch.kind == "update":
                    self._run_updates(batch, plan)
                elif batch.kind == "solo":
                    self._run_solo(batch, plan)
                else:
                    self._run_lanes(batch, plan)
            except Exception as e:  # noqa: BLE001 — the loop must survive
                # on a group's other ranks only what rank 0 rejects the
                # same way on every rank (a solve's ValueError) passes
                if self._rank and not isinstance(e, ValueError):
                    raise
                for p in batch.items:
                    if not p.ticket.done():
                        p.ticket._reject(e)
        if self._rank:
            return len(batch.items)
        with self._lock:
            done = self._clock()
            for p in batch.items:
                p.ticket.trace.t_done = done
                if p.ticket.trace.shed is None and p.ticket.exception(0) is None:
                    self._completed += 1
                    batch.tenant.served += 1
                    self._latencies.append(done - p.ticket.trace.t_submit)
        return len(batch.items)

    def _run_updates(self, batch: _Batch, plan) -> None:
        """Streamed update application between microbatches: weights
        swap on the owning plan, one request at a time so a refused
        update sheds its own ticket and the rest of the stream (and the
        batch loop) keeps going."""
        tenant = batch.tenant
        for p in batch.items:
            q = p.query
            try:
                plan.update(q.edge_ids, q.new_weights)
            except UpdateRefused as e:
                with self._lock:
                    self._shed_locked(p.ticket, "update_refused", str(e))
                continue
            except ValueError as e:
                with self._lock:
                    self._shed_locked(p.ticket, "invalid", str(e))
                continue
            tenant.graph = plan.graph
            p.ticket.trace.t_solve = self._clock()
            if plan.explain()["resident_source"] is not None:
                p.ticket._resolve(plan.resolve(warm=q.warm))
            else:
                p.ticket._resolve(
                    UpdateApplied(n_edges=len(np.ravel(q.edge_ids))))

    def _run_solo(self, batch: _Batch, plan) -> None:
        (p,) = batch.items
        p.ticket.trace.t_solve = self._clock()
        p.ticket._resolve(plan.solve(p.query))

    def _run_lanes(self, batch: _Batch, plan) -> None:
        """One padded multi-source solve answers every lane: lane i is
        bitwise identical to ``SingleSource(sources[i])`` (the
        ``MultiSource`` contract), so splitting the batch reproduces each
        request's serial answer. A lane's counters are Python scalars,
        as a ``SingleSource`` answer's are."""
        items = batch.items
        sources = [int(p.query.source) for p in items]
        padded = sources + [sources[-1]] * (self.lane_width - len(sources))
        res = plan.solve(MultiSource(padded))
        t_solve = self._clock()
        dist, pred = res.dist, res.pred
        tel_b = res.telemetry
        n = plan.graph.n_nodes
        for i, p in enumerate(items):
            q = p.query
            tel = Telemetry(
                buckets=int(tel_b.buckets[i]),
                inner_iters=int(tel_b.inner_iters[i]),
                overflow=bool(tel_b.overflow[i]),
                fallback=tel_b.fallback,
            )
            p.ticket.trace.t_solve = t_solve
            if isinstance(q, SingleSource):
                p.ticket._resolve(SingleSourceResult(dist[i], pred[i], tel))
            elif isinstance(q, PointToPoint):
                distance = int(dist[i][int(q.target)])
                path = None
                if distance < int(INF32) and plan.config.pred_mode != "none":
                    path = extract_path(
                        pred[i].cpu().numpy(), int(q.source), int(q.target), n)
                p.ticket._resolve(PointToPointResult(distance, path, tel))
            else:  # BoundedRadius: the full lane filtered to the radius
                within = dist[i] <= int(q.radius)
                d = torch.where(within, dist[i], int(INF32))
                pr = torch.where(within, pred[i], -1)
                p.ticket._resolve(
                    BoundedRadiusResult(d, pr, int(q.radius), tel))

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "Server":
        """Run the batch loop on a daemon thread (continuous serving).
        On a group's other ranks nothing starts: ``close()`` runs rank
        0's steps."""
        if self._rank:
            return self
        if self._stopped:
            raise RuntimeError("this server's process group was sent its "
                               "stop: it cannot serve again")
        if self._thread is None:
            self._closing = False
            self._thread = threading.Thread(
                target=self._loop, name="repro-serve", daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        while True:
            with self._work:
                while not self._closing and not self._has_work_locked():
                    self._work.wait()
                if self._closing and not self._has_work_locked():
                    return
                batch = self._form_batch_locked()
            if batch is not None:
                self._execute(batch)

    def close(self, drain: bool = True) -> None:
        """Stop serving. ``drain=True`` (default) answers everything
        still queued first; ``drain=False`` sheds it with a typed
        ``"closed"`` rejection — accepted requests never just vanish.
        In a group, rank 0 then sends the stop, after the last batch it
        executed; the other ranks run rank 0's steps until it arrives."""
        if self._rank:
            return self._follow()
        with self._work:
            if not drain:
                for tenant in self._tenants.values():
                    while tenant.queue:
                        p = tenant.queue.popleft()
                        self._shed_locked(p.ticket, "closed",
                                          "server closed before serving")
            self._closing = True
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        elif drain:
            self.drain()
        with self._order:
            self._send(("stop",))
            self._stopped = self._channel is not None

    def __enter__(self) -> "Server":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close(drain=not any(exc))

    # -- telemetry -----------------------------------------------------------

    def stats(self) -> dict:
        """Aggregated serving telemetry: request accounting (submitted /
        completed / shed-by-reason / queued), batch counts and mean
        occupancy, tenancy state (resident plans, builds, evictions) and
        completed-request latency percentiles in milliseconds (over the
        last {window} requests). On a group's other ranks the batch and
        tenancy counts are rank 0's; the request counts stay 0 (tickets
        are rank 0's).""".format(window=_LATENCY_WINDOW)
        with self._lock:
            lat = sorted(self._latencies)

            def pct(p: float) -> Optional[float]:
                if not lat:
                    return None
                return 1e3 * lat[min(len(lat) - 1, int(p * len(lat)))]

            n_batches = sum(self._batches.values())
            return {
                "submitted": self._submitted,
                "completed": self._completed,
                "shed": dict(sorted(self._shed.items())),
                "queued": sum(len(t.queue) for t in self._tenants.values()),
                "batches": dict(self._batches),
                "mean_occupancy": (
                    self._occupancy_sum / n_batches if n_batches else None),
                "resident": sorted(
                    t.name for t in self._tenants.values()
                    if t.plan is not None),
                "plans_built": self._plans_built,
                "evictions": self._evictions,
                "per_tenant": {
                    t.name: t.served for t in self._tenants.values()},
                "latency_p50_ms": pct(0.50),
                "latency_p99_ms": pct(0.99),
            }


__all__ = [
    "RequestRejected",
    "RequestTrace",
    "Server",
    "Ticket",
    "UpdateApplied",
]
