"""setup_s (s, host clock): from the process's start to the first timed
query: imports, CUDA start-up, the instance drawn on the device, the
plan build, the kernels' load (their build, in a checkout's first run)
and one warm-up query."""


def read(ctx):
    return ctx.setup_s
