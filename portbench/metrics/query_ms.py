"""query_ms (ms, host clock): the window's wall time over the queries
finished in it. One query is one ``Plan.solve`` call that ends in a
device synchronise with its whole answer on hand, so this is all the
work over all the time of the window."""


def read(ctx):
    if ctx.trace is not None or not ctx.queries:
        return None
    return ctx.window_s * 1e3 / ctx.queries
