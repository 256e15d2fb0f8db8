"""query_hbm_roofline_pct (%, device trace): the least time one whole
solve could take on the chip's memory bandwidth, over the device's busy
time per traced query. The least bytes come from the configuration's
``least_bytes`` (``per_vertex * n + per_edge * m`` of the cell's own
instance), so they count the same work whatever implements the solve;
the peak is the data sheet's (``peaks.json``). Moves ``query_ms``."""
import json
from pathlib import Path

_PEAKS = Path(__file__).resolve().parents[1] / "peaks.json"


def least_bytes(config: dict, n: int, m: int) -> int:
    lb = config["least_bytes"]
    return int(lb["per_vertex"]) * n + int(lb["per_edge"]) * m


def read(ctx):
    t = ctx.trace
    peak = json.loads(_PEAKS.read_text()).get(ctx.device_kind)
    if t is None or t.busy_s <= 0 or peak is None or not ctx.queries:
        return None
    best_s = least_bytes(ctx.config, ctx.n, ctx.m) / peak["hbm_bytes_per_s"]
    return 100.0 * best_s / (t.busy_s / ctx.queries)
