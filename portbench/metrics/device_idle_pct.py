"""device_idle_pct (%, device trace): 100 x (1 - the union of kernel,
copy and fill intervals / the traced queries' wall time), over whole
queries. Moves ``query_ms``."""


def read(ctx):
    t = ctx.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
