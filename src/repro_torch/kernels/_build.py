"""Build and load the port's hand-written CUDA kernels.

The sources under ``src/repro_torch/csrc/`` are compiled with ``nvcc``
for Hopper (``sm_90a``) into one shared library with a plain C
interface, which is loaded with ``ctypes``. The build happens at the
first launch of any kernel (never at import, so the CPU-only tests
import every module without ``nvcc``), one ``nvcc`` per source started
together, into ``build/kernels-<hash>/`` at the repository root. The
hash covers the sources and the flags, so an edited source rebuilds and
an unchanged one is loaded as built.

Every C entry point returns ``cudaGetLastError()`` after its launches;
``check`` turns a non-zero code into an exception.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("bucket_scan.cu", "ell_relax.cu", "frontier_relax.cu",
           "grid_relax.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "librepro_torch_kernels.so"

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# argtypes of every C entry point: a pointer or the stream is c_void_p,
# a 32-bit int c_int, a 64-bit count c_longlong
SIGNATURES = {
    "bucket_scan_launch": (_P, _P, _LL, _I, _I, _I, _I, _P, _P, _P, _P,
                           _P),
    "bucket_scan_scratch_ints": (),
    "ell_relax_launch": (_P, _P, _P, _I, _LL, _I, _I, _I, _I, _I, _I, _P,
                         _P),
    "frontier_relax_launch": (_P, _P, _I, _I, _I, _I, _I, _P, _P, _I, _I,
                              _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                              _P, _P, _P, _P),
    "grid_relax_launch": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
                          _P),
}


class KernelBuild:
    """The loaded library, where it lies, and what the build printed."""

    def __init__(self, lib: ctypes.CDLL, path: Path, seconds: float,
                 log: str):
        self.lib = lib
        self.path = path
        self.seconds = seconds   # 0.0 when an earlier build was reused
        self.log = log


_lock = threading.Lock()
_loaded: KernelBuild | None = None


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: Path) -> str:
    """One nvcc per source, all started together, then one link."""
    cc = nvcc()
    procs = []
    for name in SOURCES:
        obj = out_dir / (Path(name).stem + ".o")
        cmd = [cc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / name),
               "-o", str(obj)]
        procs.append((name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for name, p in procs:
        out, _ = p.communicate()
        logs.append(f"--- {name}\n{out}")
        if p.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed on " + ", ".join(failed) + "\n"
                           + "\n".join(logs))
    link = [cc, "-shared", "-Xcompiler", "-fPIC", "-o", str(out_dir / LIB_NAME),
            *[str(out_dir / (Path(s).stem + ".o")) for s in SOURCES]]
    res = subprocess.run(link, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc link failed\n" + res.stdout)
    return "\n".join(logs)


def load() -> KernelBuild:
    """Build the library if this source hash has none yet, load it once
    per process, and declare every entry point's argument types."""
    global _loaded
    if _loaded is not None:        # the launchers' per-call path
        return _loaded
    with _lock:
        if _loaded is not None:
            return _loaded
        target = BUILD_ROOT / f"kernels-{source_hash()}" / LIB_NAME
        t0 = time.perf_counter()
        log = ""
        seconds = 0.0
        if not target.is_file():
            BUILD_ROOT.mkdir(parents=True, exist_ok=True)
            tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
            try:
                log = _compile(tmp)
                target.parent.mkdir(parents=True, exist_ok=True)
                os.replace(tmp / LIB_NAME, target)   # atomic publish
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(target))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _loaded = KernelBuild(lib, target, seconds, log)
        return _loaded


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def require_cuda_int32(name: str, t: torch.Tensor, device: torch.device,
                       ndim: int) -> None:
    """The kernels take contiguous int32 tensors on one CUDA device."""
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name} must lie on {device}, got {t.device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {t.dim()}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def on_device(device: torch.device):
    """A context in which ``device`` is the current CUDA device: no-op
    where it already is, which spares the launchers' per-call path."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
