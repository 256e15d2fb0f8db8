"""The record of one traced step (counterpart of ``repro.analysis.hlo``).

The reference lowers and compiles a step for a 256- or 512-device mesh
and reads the per-partition HLO text. The port has no lowering: it runs
the step once, eagerly, on fake tensors (``torch._subclasses.
FakeTensorMode``: shapes, dtypes and devices, no memory) placed as
DTensors on a ``DeviceMesh`` over a fake process group (one rank that
stands for every rank; its collectives run nothing). ``RecordingMode``,
a ``FakeTensorMode`` that records in ``__torch_dispatch__``, sees two
levels of each op: DTensor's own dispatch, whose arguments are DTensors
(the mode declines them and records nothing), and the rank's local ops
that DTensor issues on its shards, whose arguments are the mode's
FakeTensors. Only the second level is recorded, so every shape in the
record is a **per-device** shape, as in the reference's per-partition
module. DTensor's sharding propagation also runs each op once on
global-shape fake tensors to learn its output's metadata; that run is
not part of the rank's work and is not recorded.

A ``StepTrace`` holds every local op (name, input and output shapes and
dtypes, its FLOPs by ``torch.utils.flop_counter``'s registry and the
bytes it moves), every collective (its op in the reference's five
names, operand and result bytes per device, group size) and the live
local bytes over the step. Wire-traffic model per collective, as the
reference's (ring algorithms, (P−1)/P ≈ 1):

  all-reduce         2 × operand bytes   (reduce-scatter + all-gather)
  reduce-scatter     1 × operand bytes
  all-gather         1 × result bytes    (operand is the local shard)
  all-to-all         1 × operand bytes
  collective-permute 1 × operand bytes

A functional collective is issued and later waited on
(``wait_tensor``): it is counted once, at its issue, as the reference
counts an async ``-start``/``-done`` pair once. A collective with no
mapping here raises, naming the op.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import weakref
from collections import defaultdict
from typing import Dict, List, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

_WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}

# collective op name (namespace.name, without overload) -> reference name
COLLECTIVES = {
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_reduce_coalesced_": "all-reduce",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_out": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_c10d_functional_autograd.all_to_all_single": "all-to-all",
    "_c10d_functional_autograd.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional_autograd.all_gather_into_tensor": "all-gather",
    "_dtensor.shard_dim_alltoall": "all-to-all",
    "c10d.allreduce_": "all-reduce",
    "c10d.allreduce_coalesced_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.send": "collective-permute",
    "c10d.recv_": "collective-permute",
}
# ops of the collective namespaces that move nothing themselves
_COLLECTIVE_NOOPS = {"_c10d_functional.wait_tensor", "c10d.barrier",
                     "c10d.monitored_barrier_"}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                          "_dtensor", "c10d")

# local ops that move no data: metadata, allocation without a write
_NO_BYTES = {"prim.device", "aten.empty", "aten.empty_strided",
             "aten.empty_like", "aten.new_empty", "aten.new_empty_strided",
             "aten.lift_fresh", "aten.detach", "aten.alias",
             "aten._local_scalar_dense", "aten.set_", "aten.resize_"}


@dataclasses.dataclass
class OpRecord:
    name: str            # "aten.mm"
    inputs: list         # [(shape, dtype str)] of the tensor arguments
    outputs: list        # [(shape, dtype str)] of the tensor results
    flops: int
    bytes: int


@dataclasses.dataclass
class CollectiveRecord:
    op: str              # one of the reference's five names
    name: str            # the torch op, e.g. "_c10d_functional.all_reduce"
    operand_bytes: int   # per device
    result_bytes: int    # per device
    group_size: Optional[int]


@dataclasses.dataclass
class StepTrace:
    ops: List[OpRecord]
    collectives: List[CollectiveRecord]
    argument_bytes: int      # the stand-ins' local bytes
    peak_temp_bytes: int     # peak live bytes allocated during the step
    output_bytes: int        # the returned tensors' local bytes
    in_place_bytes: int      # ... of those, the arguments' own storages
    seconds: float           # host time of the traced run
    returned: object = None  # what the step returned (fake tensors)

    @property
    def flops(self) -> float:
        return float(sum(o.flops for o in self.ops))

    @property
    def bytes(self) -> float:
        return float(sum(o.bytes for o in self.ops))


def _opname(func) -> str:
    """``namespace.name`` of an op overload (no overload name)."""
    packet = func.overloadpacket
    return f"{packet._qualified_op_name.replace('::', '.')}"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _group_size(args, kwargs) -> Optional[int]:
    """The size of a collective's group: a functional op names it (a
    string), a c10d op passes the group itself."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in tree_leaves((args, kwargs)):
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except (KeyError, ValueError, RuntimeError):
                continue
        if isinstance(a, torch.ScriptObject) and hasattr(a, "size"):
            return int(a.size())
    return None


def _storage_key(t: torch.Tensor):
    return t.untyped_storage()._cdata


class RecordingMode(FakeTensorMode):
    """A ``FakeTensorMode`` that records the rank's local ops while
    ``recording`` is on (``trace_step`` turns it on). Set-up made under
    the mode (the stand-ins) is not recorded."""

    def __init__(self):
        super().__init__(allow_non_fake_inputs=True)
        self.recording = False
        self._paused = 0
        self._reset()

    def _reset(self):
        self.ops: List[OpRecord] = []
        self.collectives: List[CollectiveRecord] = []
        self._live: Dict[int, tuple] = {}   # storage key -> (ref, bytes)
        self.known: set = set()    # the arguments' storages (not new)
        self.live_bytes = 0
        self.peak_bytes = 0

    @contextlib.contextmanager
    def paused(self):
        """Record nothing inside (DTensor's global-shape propagation)."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def _track(self, out) -> None:
        for t in _tensors(out):
            if not isinstance(t, FakeTensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live or key in self.known:
                continue
            n = st.nbytes()
            self._live[key] = (weakref.ref(st, self._freer(key, n)), n)
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _freer(self, key, n):
        def freed(_ref):
            if self._live.pop(key, None) is not None:
                self.live_bytes -= n
        return freed

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if (out is NotImplemented or not self.recording or self._paused):
            return out
        ins = _tensors((args, kwargs))
        if not all(isinstance(t, FakeTensor) for t in ins):
            return out                          # a DTensor-level call
        self._record(func, ins, args, kwargs, out)
        self._track(out)
        return out

    def _record(self, func, ins, args, kwargs, out) -> None:
        name = _opname(func)
        outs = _tensors(out)
        namespace = name.split(".", 1)[0]
        if namespace in _COLLECTIVE_NAMESPACES:
            if name in _COLLECTIVE_NOOPS:
                return
            if name not in COLLECTIVES:
                raise NotImplementedError(
                    f"collective {name} has no mapping onto the reference's "
                    f"{sorted(_WIRE_FACTOR)}")
            out_ids = {id(t) for t in outs}
            operands = [t for t in ins if id(t) not in out_ids] or outs
            self.collectives.append(CollectiveRecord(
                op=COLLECTIVES[name], name=name,
                operand_bytes=sum(map(_nbytes, operands)),
                result_bytes=sum(map(_nbytes, outs)),
                group_size=_group_size(args, kwargs)))
            return
        packet = func.overloadpacket
        flops = 0
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **(kwargs or {}),
                                              out_val=out))
        moved = 0
        if not (func.is_view or name in _NO_BYTES):
            moved = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        self.ops.append(OpRecord(
            name=name,
            inputs=[(tuple(t.shape), str(t.dtype)) for t in ins],
            outputs=[(tuple(t.shape), str(t.dtype)) for t in outs],
            flops=flops, bytes=moved))


def local_tensors(tree) -> list:
    """The local tensors of every tensor in ``tree`` (a module's
    parameters, dicts, lists; a DTensor's shard)."""
    from torch.distributed.tensor import DTensor
    out = []

    def walk(x):
        if isinstance(x, torch.nn.Module):
            for p in x.parameters():
                walk(p)
        elif isinstance(x, DTensor):
            out.append(x.to_local())
        elif isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
    walk(tree)
    return out


def unique_bytes(tensors) -> int:
    """Bytes of the distinct storages under ``tensors``."""
    seen = {}
    for t in tensors:
        seen.setdefault(_storage_key(t), t.untyped_storage().nbytes())
    return sum(seen.values())


@contextlib.contextmanager
def _propagation_paused(mode: RecordingMode):
    """DTensor's sharding propagation runs each op once on global-shape
    fake tensors (under the active fake mode) to learn the output's
    metadata: that run is paused."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    real = ShardingPropagator._propagate_tensor_meta_non_cached

    def paused(self, op_schema):
        with mode.paused():
            return real(self, op_schema)

    ShardingPropagator._propagate_tensor_meta_non_cached = paused
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = real


def trace_step(fn, *args, mode: RecordingMode) -> StepTrace:
    """Run ``fn(*args)`` once under ``mode`` (where ``args`` were made)
    and return its record: the counterpart of ``lower().compile()``."""
    arg_locals = local_tensors(args)
    arg_keys = {_storage_key(t) for t in arg_locals}
    mode._reset()
    mode.known = arg_keys
    t0 = time.perf_counter()
    with mode, _propagation_paused(mode):
        mode.recording = True
        try:
            out = fn(*args)
        finally:
            mode.recording = False
    seconds = time.perf_counter() - t0
    outs = local_tensors(out)
    trace = StepTrace(
        ops=mode.ops, collectives=mode.collectives,
        argument_bytes=unique_bytes(arg_locals),
        peak_temp_bytes=mode.peak_bytes,
        output_bytes=unique_bytes(outs),
        in_place_bytes=unique_bytes(
            [t for t in outs if _storage_key(t) in arg_keys]),
        seconds=seconds, returned=out)
    mode._reset()
    return trace


def collective_stats(trace: StepTrace) -> Dict:
    """Returns per-collective-type {count, operand_bytes, wire_bytes} and
    totals, all per-device per-step."""
    stats = defaultdict(lambda: {"count": 0, "operand_bytes": 0,
                                 "wire_bytes": 0})
    for c in trace.collectives:
        basis = c.result_bytes if c.op == "all-gather" else c.operand_bytes
        stats[c.op]["count"] += 1
        stats[c.op]["operand_bytes"] += c.operand_bytes
        stats[c.op]["wire_bytes"] += int(basis * _WIRE_FACTOR[c.op])
    total = {
        "count": sum(s["count"] for s in stats.values()),
        "operand_bytes": sum(s["operand_bytes"] for s in stats.values()),
        "wire_bytes": sum(s["wire_bytes"] for s in stats.values()),
    }
    return {"by_op": dict(stats), "total": total}


def count_op(trace: StepTrace, opname: str) -> int:
    """Local ops of ``trace`` named ``opname`` (``"aten.mm"``, or
    ``"mm"`` for any namespace)."""
    return sum(1 for o in trace.ops
               if o.name == opname or o.name.split(".", 1)[-1] == opname)
