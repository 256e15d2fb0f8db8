"""One run of one cell: set-up, the measured window (or, with a trace,
a fixed number of profiled queries), the check against the reference,
and the result line.

A traced run profiles the first ``trace_queries`` of the window's
queries (a number the mix sets, so that they span its rotation).

Set-up makes the instance on the device from the seed, resets the
device's peak memory (the generator's scratch is the benchmark's, not
the program's), builds the plan (``Engine(...).plan()``), and answers
one warm-up query of the cell's own kind. ``setup_s`` runs from the
process's start to the first timed query. The window is a closed loop
of one client: each query is issued once the previous answer (its
``dist`` and ``pred``, or its distance and path) is on hand and the
device has synchronised; it ends with the first query that finishes
``--seconds`` after the window opened, and ``query_ms`` is its wall time
over the queries it finished. The answers compared with the reference
are a reservoir sample, drawn from the seed, of the window's queries.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

from pbcore import check, isolation, trace as trace_mod, traffic
from pbcore.spec import ROOT, Spec

_PREFETCH = 64          # window queries drawn before the window opens


class NoDevice(RuntimeError):
    """The run needs CUDA devices that this machine does not have."""


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own CUDA build lies in ``build/kernels-<hash>/``)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch-ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def require_cuda(chips: int):
    import torch
    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device: the benchmark measures the port on "
                       "the GPU and has no CPU fallback")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell asks for {chips} CUDA devices, "
                       f"{torch.cuda.device_count()} present")
    return torch.device("cuda", 0)


def power_limit() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Reservoir:
    """A uniform sample of ``k`` of the answers seen, drawn from the
    seed's sample stream."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen, self.items = k, 0, []
        self.rng = traffic.rng_of(seed, traffic.SAMPLE)

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def answer(plan, q, device):
    """Ask the plan one query and wait for the whole answer."""
    from repro_torch.api import PointToPoint, SingleSource
    if q.kind == "single_source":
        r = plan.solve(SingleSource(q.source))
        out = (q, r.dist, r.pred)
    else:
        r = plan.solve(PointToPoint(q.source, q.target, mode=q.mode))
        out = (q, r.distance, r.path)
    _sync(device)
    return out


def launch_counters(kernels: dict) -> dict:
    out = {}
    for name, spec in kernels.items():
        mod, attr = spec["counter"].split(":")
        out[name] = getattr(importlib.import_module(mod), attr)
    return out


def run(spec: Spec, cell: dict, seed: int, seconds: float, trace: bool,
        device, t_start: float, config: dict | None = None,
        mix: dict | None = None) -> dict:
    """One run of ``cell``: the result line's object. ``config`` and
    ``mix`` stand in for the cell's files (the CPU tests' sizes)."""
    import torch
    from repro_torch.api import Engine
    from repro_torch.core import DeltaConfig
    from repro_torch.graphs.structures import COOGraph

    cfg = config if config is not None else spec.config(cell["config"])
    mix = mix if mix is not None else spec.traffic(cell["traffic"])
    cuda = device.type == "cuda"

    # -- set-up ---------------------------------------------------------
    inst = spec.generator(cfg["graph"]["generator"]).make(cfg["graph"], seed,
                                                          device)
    free_host = None if inst.free is None else inst.free.cpu().numpy()
    _sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    solver = {k: tuple(v) if isinstance(v, list) else v
              for k, v in cfg["solver"].items()}
    plan = Engine(COOGraph(inst.src, inst.dst, inst.w, inst.n),
                  DeltaConfig(**solver), free_mask=inst.free,
                  device=device).plan()
    _sync(device)
    plan_build_s = time.perf_counter() - t
    warm = traffic.stream(mix, inst.n, free_host, seed, traffic.WARMUP)
    queries = traffic.stream(mix, inst.n, free_host, seed, traffic.WINDOW)
    ahead = [next(queries) for _ in range(_PREFETCH)]
    answer(plan, next(warm), device)
    setup_s = time.perf_counter() - t_start

    # -- the window ----------------------------------------------------------
    sample = Reservoir(int(cfg["compare_queries"]), seed)
    kernels = spec.kernels()
    counters = launch_counters(kernels)
    before = {k: f.launches for k, f in counters.items()}
    syncs, failed, done = [], 0, 0
    summary = None

    def one():
        nonlocal failed, done
        q = ahead.pop(0) if ahead else next(queries)
        try:
            sample.offer(answer(plan, q, device))
            syncs.append(plan.host_syncs)
        except Exception as e:                    # counted, then reported
            failed += 1
            if failed == 1:
                print(f"query {q} failed: {e!r}", file=sys.stderr)
        done += 1

    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(int(mix["trace_queries"])):
                one()
            _sync(device)
            wall = time.perf_counter() - t0
        dev_spans, host_spans = trace_mod.kineto_spans(prof)
        del prof
        summary = trace_mod.summarize(dev_spans, host_spans, wall)
        if cuda:
            seen = trace_mod.check_records(
                summary.counts,
                {k: f.launches - before[k] for k, f in counters.items()},
                kernels)
            print("records " + ", ".join(f"{k} {r} of {n}" for k, (r, n)
                                         in seen.items() if n),
                  file=sys.stderr)
    else:
        t0 = time.perf_counter()
        while True:
            one()
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    # -- the check: the program's state freed, the reference on the card --
    del plan
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    compared = check.compare(mix["query"], spec.reference(cfg["reference"]),
                             spec.tree(), inst, sample.items)
    correct = (failed == 0 and done > 0 and bool(sample.items)
               and check.verdict(compared))

    ctx = SimpleNamespace(
        setup_s=setup_s, plan_build_s=plan_build_s, window_s=wall,
        queries=done, host_syncs=syncs, peak_bytes=peak, trace=summary,
        n=inst.n, m=inst.m, config=cfg,
        device_kind=torch.cuda.get_device_name(device) if cuda else "cpu")
    metrics = {}
    for m in spec.metrics(cell["name"], trace):
        value = spec.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if cuda else "cpu", "kind": ctx.device_kind,
                "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": done, "failed": failed,
              "metrics": metrics, "device": dev_info}
    if summary is not None:
        dev_info["busy_s"] = summary.busy_s
        dev_info["window_s"] = summary.window_s
        result["breakdown"] = {
            "device_ops": trace_mod.top(summary.by_name),
            "idle_gaps": trace_mod.top(summary.gaps)}
    result["compared"] = {k: {"value": v, "limit": check.LIMITS[k]}
                          for k, v in compared.items()}
    return result


def emit(result: dict, smi: str) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error, the result as the last line of standard output."""
    print(f"device {smi}", file=sys.stderr)
    for k, v in result["compared"].items():
        print(f"compared {k} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    set_cache_dirs()
    spec = Spec()
    cell = spec.cell(args.workload)
    try:
        device = require_cuda(int(cell["chips"]))
    except NoDevice as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    result = run(spec, cell, args.seed, args.seconds, bool(args.trace),
                 device, t_start)
    found = isolation.forbidden(sys.modules)
    if found:
        print("forbidden modules loaded: " + ", ".join(found), file=sys.stderr)
        return 1
    emit(result, power_limit())
    return 0
