"""peak_mem_gib (GiB): ``torch.cuda.max_memory_allocated`` over the
plan build, the warm-up and the window, with the resident graph; the
benchmark's own scratch from drawing the instance is left out."""


def read(ctx):
    if ctx.trace is not None or not ctx.peak_bytes:
        return None
    return ctx.peak_bytes / 2**30
