"""On-disk persistence for landmark tables (counterpart of
``repro.landmarks.store``, DESIGN.md §14).

One ``.npz`` file per (fingerprint, whash, k, strategy, seed) key, the
reference's key and fields. Writes go to a temp file in the destination
directory and land via atomic ``os.replace`` (a crashed precompute never
leaves a torn table), and a corrupt or mismatched file reads as a miss
rather than an error. ``path=None`` keeps everything in memory.

The key includes ``whash`` (exact edge-array content hash) on top of
the structural fingerprint: a table reused across same-fingerprint
graphs with other weights would give inadmissible potentials and wrong
answers. The port's fingerprints end in their own device term
(``tune.estimator.fingerprint``), so a directory shared with the JAX
package never serves one package's file to the other.
"""
from __future__ import annotations

import hashlib
import os
import tempfile
import zipfile
from typing import Optional

import numpy as np

from repro_torch.landmarks.tables import LandmarkTables


def _key(fingerprint: str, whash: str, k: int, strategy: str, seed: int) -> str:
    raw = f"{fingerprint}|{whash}|k={k}|{strategy}|seed={seed}"
    return hashlib.sha1(raw.encode()).hexdigest()


class LandmarkStore:
    """Fingerprint-keyed table store; ``path=None`` is in-memory only."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._mem: dict[str, LandmarkTables] = {}
        if path is not None:
            os.makedirs(path, exist_ok=True)

    def _file(self, key: str) -> str:
        return os.path.join(self.path, f"landmarks_{key}.npz")

    def get(
        self,
        fingerprint: str,
        whash: str,
        k: int,
        strategy: str,
        seed: int,
    ) -> Optional[LandmarkTables]:
        key = _key(fingerprint, whash, k, strategy, seed)
        hit = self._mem.get(key)
        if hit is not None or self.path is None:
            return hit
        fname = self._file(key)
        if not os.path.exists(fname):
            return None
        try:
            with np.load(fname, allow_pickle=False) as z:
                tables = LandmarkTables(
                    fingerprint=str(z["fingerprint"]),
                    whash=str(z["whash"]),
                    strategy=str(z["strategy"]),
                    seed=int(z["seed"]),
                    landmarks=np.asarray(z["landmarks"], np.int32),
                    d_out=np.asarray(z["d_out"], np.int32),
                    d_in=np.asarray(z["d_in"], np.int32),
                )
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile):
            return None          # a corrupt file is a miss
        if tables.fingerprint != fingerprint or tables.whash != whash:
            return None          # hash-collision paranoia: verify payload
        self._mem[key] = tables
        return tables

    def put(self, tables: LandmarkTables) -> None:
        key = _key(tables.fingerprint, tables.whash, tables.k,
                   tables.strategy, tables.seed)
        self._mem[key] = tables
        if self.path is None:
            return
        fd, tmp = tempfile.mkstemp(dir=self.path, suffix=".npz.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(
                    f,
                    fingerprint=np.str_(tables.fingerprint),
                    whash=np.str_(tables.whash),
                    strategy=np.str_(tables.strategy),
                    seed=np.int64(tables.seed),
                    landmarks=tables.landmarks,
                    d_out=tables.d_out,
                    d_in=tables.d_in,
                )
            os.replace(tmp, self._file(key))
        except Exception:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise


__all__ = ["LandmarkStore"]
