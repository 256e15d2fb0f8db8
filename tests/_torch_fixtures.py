"""Set-up shared by the port's CPU tests (``tests/test_torch_*.py``)."""
import contextlib
import fcntl
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

HERE = Path(__file__).resolve().parent


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


class SpawnedGroup:
    """Processes that a test module needs once per test session, shared
    by xdist's workers: the first worker to take the lock in the
    session's directory ``name`` calls ``start(root)`` (which starts the
    processes without waiting and returns them) and keeps the lock
    until they have exited; the others wait on the lock. ``wait()``
    returns ``root`` once every process has exited 0. Each process has
    a hard time limit of ``limit_s``, so the worker that started them
    can go on with its own tests meanwhile."""

    def __init__(self, tmp_path_factory, name: str, start, limit_s: int):
        base = tmp_path_factory.getbasetemp()
        if "PYTEST_XDIST_WORKER" in os.environ:     # the session's, not
            base = base.parent                      # the worker's, dir
        self.root = base / name
        self.root.mkdir(exist_ok=True)
        self.limit_s = limit_s
        self.lock = open(self.root / "lock", "w")
        self.procs = None
        try:
            fcntl.flock(self.lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except BlockingIOError:
            return                      # another worker runs the group
        if (self.root / "done").exists():
            fcntl.flock(self.lock, fcntl.LOCK_UN)
        else:
            self.procs = start(self.root)

    def _finish(self):
        """Wait for this worker's processes, mark the results done,
        release the lock."""
        procs, self.procs = self.procs, None
        try:
            for p in procs:
                try:
                    out, _ = p.communicate(timeout=self.limit_s)
                except subprocess.TimeoutExpired:
                    for q in procs:
                        q.kill()
                    pytest.fail(f"a spawned process ran past {self.limit_s}"
                                f" s: {p.args}")
                assert p.returncode == 0, \
                    f"{p.args} failed:\n{(out or '')[-4000:]}"
            (self.root / "done").write_text("ok")
        finally:
            fcntl.flock(self.lock, fcntl.LOCK_UN)

    def wait(self) -> Path:
        if self.procs is not None:
            self._finish()
        else:
            fcntl.flock(self.lock, fcntl.LOCK_EX)
            fcntl.flock(self.lock, fcntl.LOCK_UN)
        assert (self.root / "done").exists(), "the group did not finish"
        return self.root

    def close(self):
        if self.procs is not None:
            self._finish()
        self.lock.close()


def spawn(*args, log=None):
    """``python ARGS`` with ``src`` and ``tests`` on the path, one
    thread per process, its output piped (or written to the file
    ``log``)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(HERE.parent / "src"), str(HERE)]), OMP_NUM_THREADS="1")
    with open(log, "w") if log is not None else contextlib.nullcontext() \
            as f:
        return subprocess.Popen([sys.executable, *map(str, args)], env=env,
                                stdout=f or subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
