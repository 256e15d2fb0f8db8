"""Set-up shared by the port's CPU tests (``tests/test_torch_*.py``)."""
import contextlib

import jax
import torch


@contextlib.contextmanager
def fresh_caches_one_thread():
    """Empty JAX's compile caches on entry and on exit, so that a module
    leaves no compiled executables behind for the modules that follow,
    and run torch on one intra-op thread in between: xdist's workers
    share the cores, and an intra-op pool in each would oversubscribe
    them."""
    jax.clear_caches()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        jax.clear_caches()
