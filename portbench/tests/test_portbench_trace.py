"""The trace arithmetic on a synthetic trace: busy time, idle gaps by
host operation, records against launches, and the per-layer readers'
shares, with the least-bytes floor of each configuration."""
import json
from types import SimpleNamespace

import pytest

from pbcore import trace
from pbcore.spec import HERE, Spec
from pbcore.trace import Span


def _synthetic():
    # device: two overlapping port kernels, a scatter, a copy;
    # host: two top-level ops with nested calls inside, and a gap of
    # Python between them
    dev = [Span("void bucket_scan_kernel<true>(int*)", 1.0, 2.0),
           Span("frontier_gather_kernel", 1.5, 2.5),
           Span("void at::native::_scatter_gather_elementwise_kernel", 4.0,
                6.0),
           Span("Memcpy DtoH (Device -> Pinned)", 7.0, 7.5)]
    host = [Span("aten::item", 2.4, 3.5), Span("cudaStreamSynchronize", 2.5,
                                                3.4),
            Span("aten::scatter_reduce_", 3.8, 4.2),
            Span("aten::to", 6.5, 7.1), Span("cudaMemcpyAsync", 6.6, 7.05)]
    return dev, host


def test_union_and_summary():
    dev, host = _synthetic()
    s = trace.summarize(dev, host, window_s=8.0)
    assert s.busy_s == pytest.approx(1.5 + 2.0 + 0.5)
    assert s.device_s == pytest.approx(1.0 + 1.0 + 2.0 + 0.5)
    assert s.counts["frontier_gather_kernel"] == 1
    # gaps on [1.0, 7.5]: (2.5, 4.0) and (6.0, 7.0)
    assert sum(s.gaps.values()) == pytest.approx(1.5 + 1.0)
    assert s.gaps["aten::item"] == pytest.approx(1.0)          # 2.5-3.5
    assert s.gaps["aten::scatter_reduce_"] == pytest.approx(0.2)  # 3.8-4.0
    assert s.gaps["aten::to"] == pytest.approx(0.5)             # 6.5-7.0
    assert s.gaps[trace.HOST_BETWEEN_OPS] == pytest.approx(0.3 + 0.5)
    assert "cudaStreamSynchronize" not in s.gaps                # nested
    assert trace.top(s.gaps, 2)[0][0] == "aten::item"


def test_top_level_drops_nested_spans():
    _, host = _synthetic()
    names = [s.name for s in trace.top_level(host)]
    assert names == ["aten::item", "aten::scatter_reduce_", "aten::to"]


def test_records_against_launches():
    kernels = Spec().kernels()
    counts = {"void bucket_scan_kernel<true>(int*)": 5,
              "frontier_scan_kernel": 3, "frontier_gather_kernel": 3}
    launches = {"bucket_scan": 5, "frontier_relax": 3, "ell_relax": 0,
                "grid_relax": 0}
    seen = trace.check_records(counts, launches, kernels)
    assert seen["bucket_scan_kernel"] == (5, 5)
    assert seen["frontier_gather_kernel"] == (3, 3)
    with pytest.raises(trace.TraceHoles, match="frontier_gather_kernel 2 of"):
        trace.check_records(dict(counts, frontier_gather_kernel=2), launches,
                            kernels)


def _ctx(config, n, m, queries=2, kind="NVIDIA H100 80GB HBM3"):
    dev, host = _synthetic()
    return SimpleNamespace(trace=trace.summarize(dev, host, 8.0),
                           config=config, n=n, m=m, queries=queries,
                           device_kind=kind, host_syncs=[100, 120],
                           plan_build_s=1.25, setup_s=9.0, window_s=8.0,
                           peak_bytes=3 * 2**30)


def test_readers_on_the_synthetic_trace():
    spec = Spec()
    cfg = spec.config("smallworld-1m-k20-fused")
    ctx = _ctx(cfg, 1000, 20000)
    idle = spec.reader("device_idle_pct").read(ctx)
    assert idle == pytest.approx(100 * (1 - 4.0 / 8.0))
    share = spec.reader("torch_op_share_pct").read(ctx)
    assert share == pytest.approx(100 * 2.5 / 4.5)
    assert spec.reader("host_syncs").read(ctx) == 110
    assert spec.reader("plan_build_s").read(ctx) == 1.25
    roof = spec.reader("query_hbm_roofline_pct").read(ctx)
    assert roof == pytest.approx(100 * (8 * 1000 + 8 * 20000) / 3.35e12
                                 / (4.0 / 2))
    # an unknown chip has no peak to hold the time to
    assert spec.reader("query_hbm_roofline_pct").read(
        _ctx(cfg, 1000, 20000, kind="cpu")) is None
    # no trace: the per-layer readers of the trace find nothing to read
    bare = SimpleNamespace(**dict(vars(ctx), trace=None))
    for name in ("device_idle_pct", "torch_op_share_pct",
                 "query_hbm_roofline_pct"):
        assert spec.reader(name).read(bare) is None
    assert spec.reader("query_ms").read(bare) == pytest.approx(4000.0)
    assert spec.reader("peak_mem_gib").read(bare) == 3.0


@pytest.mark.parametrize("config, n, m, want", [
    ("smallworld-1m-k20-fused", 1_000_000, 20_000_000, 168_000_000),
    ("gamemap-3000-grid", 9_000_000, 58_000_000, 81_000_000)])
def test_least_bytes_of_each_configuration(config, n, m, want):
    spec = Spec()
    cfg = json.loads((HERE / "configs" / f"{config}.json").read_text())
    lb = spec.reader("query_hbm_roofline_pct").least_bytes(cfg, n, m)
    assert lb == want
