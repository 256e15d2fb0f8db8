"""Reduce a ``torch.profiler`` trace of whole queries to what the
per-layer metrics read: device busy time (the union of kernel, copy and
fill intervals), device time by operation name, each port kernel's
records, and the idle gaps labelled by the host operation that ran
during them."""
from __future__ import annotations

import bisect
from typing import Dict, List, NamedTuple

HOST_BETWEEN_OPS = "host between ops"


class Span(NamedTuple):
    name: str
    start: float        # seconds, on the trace's clock
    end: float


class TraceHoles(RuntimeError):
    """The profiler kept fewer records of a port kernel than it had
    launches: the trace has holes and its busy time cannot be read."""


class Summary(NamedTuple):
    window_s: float                    # host wall time of the traced queries
    busy_s: float                      # union of device intervals
    device_s: float                    # summed device intervals
    by_name: Dict[str, float]          # device seconds by operation name
    counts: Dict[str, int]             # device records by operation name
    gaps: Dict[str, float]             # idle seconds by host operation


DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_ACTIVITIES = ("cpu_op", "cuda_runtime", "cuda_driver")


def kineto_spans(prof) -> tuple[List[Span], List[Span]]:
    """(device spans, host spans) of a finished ``torch.profiler.profile``
    from its raw Kineto events: on the device kernels, copies and fills
    (not synchronisation records or annotations), on the host operator
    and CUDA runtime calls."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = e.end_ns() if hasattr(e, "end_ns") else start + e.duration_ns()
        span = Span(e.name(), start * 1e-9, end * 1e-9)
        on_host = e.device_type() == DeviceType.CPU
        if hasattr(e, "activity_type"):
            kind = str(e.activity_type())
            keep = kind in (HOST_ACTIVITIES if on_host else DEVICE_ACTIVITIES)
        else:
            keep = on_host or "sync" not in e.name().lower()
        if keep:
            (host if on_host else dev).append(span)
    return dev, host


def busy_intervals(spans: List[Span]) -> List[tuple]:
    """The union of ``spans`` as sorted disjoint (start, end) pairs."""
    out: List[list] = []
    for s in sorted(spans, key=lambda s: s.start):
        if out and s.start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], s.end)
        else:
            out.append([s.start, s.end])
    return [tuple(x) for x in out]


def top_level(host: List[Span]) -> List[Span]:
    """Host spans not nested in another: the operations the program
    called, disjoint and in order."""
    out, hi = [], float("-inf")
    for s in sorted(host, key=lambda s: (s.start, -s.end)):
        if s.start >= hi:
            out.append(s)
            hi = s.end
    return out


def idle_gaps(dev: List[Span], host: List[Span]) -> Dict[str, float]:
    """Seconds in which no device operation ran, between the first and
    the last span of the trace, by the top-level host operation that
    ran then (``HOST_BETWEEN_OPS`` where none did)."""
    spans = dev + host
    if not spans:
        return {}
    lo = min(s.start for s in spans)
    hi = max(s.end for s in spans)
    busy = busy_intervals(dev)
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    ops = top_level(host)
    starts = [s.start for s in ops]
    out: Dict[str, float] = {}
    for a, b in gaps:
        covered = 0.0
        k = max(bisect.bisect_right(starts, a) - 1, 0)
        while k < len(ops) and ops[k].start < b:
            ov = min(b, ops[k].end) - max(a, ops[k].start)
            if ov > 0:
                out[ops[k].name] = out.get(ops[k].name, 0.0) + ov
                covered += ov
            k += 1
        if b - a - covered > 0:
            out[HOST_BETWEEN_OPS] = out.get(HOST_BETWEEN_OPS, 0.0) + (
                b - a - covered)
    return out


def summarize(dev: List[Span], host: List[Span], window_s: float) -> Summary:
    by_name: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for s in dev:
        by_name[s.name] = by_name.get(s.name, 0.0) + (s.end - s.start)
        counts[s.name] = counts.get(s.name, 0) + 1
    busy = sum(b - a for a, b in busy_intervals(dev))
    return Summary(window_s, busy, sum(by_name.values()), by_name, counts,
                   idle_gaps(dev, host))


def records_of(counts: Dict[str, int], symbol: str) -> int:
    """Device records whose name holds the kernel's symbol."""
    return sum(c for name, c in counts.items() if symbol in name)


def check_records(counts: Dict[str, int], launches: Dict[str, int],
                  kernels: Dict[str, dict]) -> Dict[str, tuple]:
    """Each port kernel's records against its launches counter over the
    traced queries: ``{symbol: (records, launches)}``. Raises
    ``TraceHoles`` where the profiler kept fewer records than there
    were launches (or more: a name held by another kernel)."""
    seen = {}
    for name, spec in kernels.items():
        for sym in spec["symbols"]:
            seen[sym] = (records_of(counts, sym), launches[name])
    bad = {k: v for k, v in seen.items() if v[0] != v[1]}
    if bad:
        raise TraceHoles("profiler records against launches: " + ", ".join(
            f"{k} {r} of {n}" for k, (r, n) in bad.items()))
    return seen


def top(d: Dict[str, float], k: int = 10) -> List[list]:
    return [[name, sec] for name, sec in
            sorted(d.items(), key=lambda kv: -kv[1])[:k]]
