"""torch_op_share_pct (%, device trace): the share of device time in
operations that are not the port's own kernels (``kernels/*.json``):
PyTorch's scatter, gather, ``where``, OR, copies and fills that
``core/backends.py`` and ``pred_argmin`` issue. Moves ``query_ms``."""
import json
from pathlib import Path

_KERNELS = Path(__file__).resolve().parents[1] / "kernels"


def own_symbols():
    return [s for p in sorted(_KERNELS.glob("*.json"))
            for s in json.loads(p.read_text())["symbols"]]


def read(ctx):
    t = ctx.trace
    if t is None or t.device_s <= 0:
        return None
    syms = own_symbols()
    own = sum(sec for name, sec in t.by_name.items()
              if any(s in name for s in syms))
    return 100.0 * (t.device_s - own) / t.device_s
