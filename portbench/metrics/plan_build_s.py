"""plan_build_s (s, harness clock): ``Engine(...).plan()`` ending in a
device synchronise: the host CSR, light/heavy split and ELL build
(``graphs/structures.py``, ``core/backends.make_backend``) or the grid
backend (``core/grid.py``). Moves ``setup_s``."""


def read(ctx):
    return ctx.plan_build_s
