"""Persistent JSON tuning cache of the PyTorch port (counterpart of
``repro.tune.cache``, DESIGN.md §7).

One JSON file maps graph fingerprints (``estimator.fingerprint``) to
serialized ``TuningRecord``s, so a repeat workload skips the measured
search. The schema is the reference's (``version`` 1, records keyed by
fingerprint, sorted keys), so either package reads the other's file;
the fingerprints' ``:dev=`` terms differ (``torch-cuda1`` against a
JAX device count), so a record measured by one package never answers
the other's lookup.

Writes are atomic (temporary file + ``os.replace``), so a crashed tuner
never leaves a truncated cache behind.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Optional

from repro_torch.tune.search import TuningRecord

_VERSION = 1


class TuningCache:
    """Dict-like fingerprint → ``TuningRecord`` store backed by one JSON
    file. ``path=None`` gives an in-memory cache (same interface,
    nothing persisted)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._records: Dict[str, TuningRecord] = {}
        if path is not None and os.path.exists(path):
            self._load(path)

    def _load(self, path: str) -> None:
        # an unreadable file (truncated write, hand edit, stale schema)
        # means "start fresh": a tuning cache is always safe to lose
        try:
            with open(path) as f:
                data = json.load(f)
            if data.get("version") != _VERSION:
                return
            records = {
                key: TuningRecord.from_json(rec)
                for key, rec in data.get("records", {}).items()
            }
        except (OSError, ValueError, KeyError, TypeError):
            return
        self._records.update(records)

    def get(self, fp: str) -> Optional[TuningRecord]:
        return self._records.get(fp)

    def put(self, record: TuningRecord) -> None:
        self._records[record.fingerprint] = record

    def __len__(self) -> int:
        return len(self._records)

    def __contains__(self, fp: str) -> bool:
        return fp in self._records

    def save(self) -> None:
        """Atomically rewrite the backing file (no-op when in-memory)."""
        if self.path is None:
            return
        payload = {
            "version": _VERSION,
            "records": {
                fp: rec.to_json() for fp, rec in sorted(self._records.items())
            },
        }
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise


__all__ = ["TuningCache"]
