"""host_syncs (syncs/query, program counter): ``Plan.host_syncs`` after
each traced query (the host loop ``core/delta_stepping._run_backend``:
2 * buckets + inner_iters + 1, and the point-to-point stop), averaged
over the traced queries. Moves ``query_ms``."""


def read(ctx):
    if not ctx.host_syncs:
        return None
    return sum(ctx.host_syncs) / len(ctx.host_syncs)
