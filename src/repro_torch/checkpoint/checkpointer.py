"""Checkpointing: atomic, step-indexed, optionally async (counterpart of
``repro.checkpoint.checkpointer``).

Layout: ``<dir>/step_<n>/arrays.npz`` + ``manifest.json``. Writes go to
``step_<n>.tmp`` and are renamed only after fsync, so a crash mid-write
never corrupts the latest checkpoint (the trainer's restart path relies
on it); only the last ``keep`` steps are kept.

A tree is nested dicts (keys in sorted order), lists and tuples of
tensors; ``None`` holds no leaf. The manifest records each leaf's path,
dtype and shape. numpy has no bfloat16, so a bf16 leaf is stored as its
uint16 bits and ``restore`` gives back the same bits. ``AsyncWriter``
overlaps serialization with the next training steps (one snapshot in
flight); it copies every leaf to the host before its thread starts, so
the training loop may update its tensors in place at once.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch


def _leaves(tree, path: str = ""):
    """(path, leaf) pairs in the tree's fixed order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{path}/{key}")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, f"{path}/{i}")
    else:
        yield path, tree


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: _rebuild(tree[key], leaves) for key in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(sub, leaves) for sub in tree)
    return next(leaves)


def _to_numpy(leaf):
    t = torch.as_tensor(leaf).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.dtype).removeprefix("torch.")


def save(directory: str, step: int, tree: Any, keep: int = 3):
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"step_{step}.tmp")
    final = os.path.join(directory, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays, meta = {}, []
    for i, (path, leaf) in enumerate(_leaves(tree)):
        arrays[f"leaf_{i}"], dtype = _to_numpy(leaf)
        meta.append({"path": path, "dtype": dtype,
                     "shape": list(arrays[f"leaf_{i}"].shape)})
    with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "n_leaves": len(meta), "leaves": meta}, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(directory, keep)


def _gc(directory: str, keep: int):
    steps = sorted(all_steps(directory))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, f"step_{s}"),
                      ignore_errors=True)


def all_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                pass
    return out


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return max(steps) if steps else None


def restore(directory: str, like: Any, step: Optional[int] = None):
    """Restore into the structure of ``like``: each leaf a tensor with the
    dtype and on the device of ``like``'s leaf at the same path. Returns
    (tree, step) or (None, None) when no checkpoint exists."""
    step = latest_step(directory) if step is None else step
    if step is None:
        return None, None
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        meta = json.load(f)["leaves"]
    refs = list(_leaves(like))
    if [p for p, _ in refs] != [m["path"] for m in meta]:
        raise ValueError(f"checkpoint {path} holds {len(meta)} leaves that "
                         f"do not match the {len(refs)} of the tree")
    new_leaves = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, ((_, ref), m) in enumerate(zip(refs, meta)):
            t = torch.from_numpy(data[f"leaf_{i}"].copy())
            if m["dtype"] == "bfloat16":
                t = t.view(torch.bfloat16)
            ref = torch.as_tensor(ref)
            new_leaves.append(t.to(device=ref.device, dtype=ref.dtype))
    return _rebuild(like, iter(new_leaves)), step


class AsyncWriter:
    """One-in-flight background checkpoint writer."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def submit(self, step: int, tree: Any):
        self.wait()
        # a copy of every leaf now: on the CPU .cpu() would return the
        # same storage, which the next step updates in place
        host = _rebuild(tree, iter(
            torch.as_tensor(leaf).detach().to("cpu", copy=True)
            for _, leaf in _leaves(tree)))

        def work():
            save(self.directory, step, host, self.keep)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
