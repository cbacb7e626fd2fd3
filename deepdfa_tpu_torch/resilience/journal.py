"""Durable run journal and atomic small-file commit helpers.

A copy of ``deepdfa_tpu/resilience/journal.py`` (standard library only).
The journal is the trainer's crash-recovery record: one small JSON file
holding the last completed epoch, global step, sampler identity and best
metric. It is written sideways, fsynced and moved into place with
``os.replace``, so a reader sees either the old record or the new one. The
checkpoint manager reuses :func:`fsync_dir` so a rename survives a crash,
and the embedding cache commits its entries with :func:`atomic_write_bytes`
and :func:`atomic_write_text`.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any

__all__ = ["RunJournal", "atomic_write_bytes", "atomic_write_text",
           "fsync_dir"]


def fsync_dir(path: str | Path) -> None:
    """fsync a directory so a completed rename is durable. Best-effort:
    some filesystems refuse O_RDONLY fsync on directories."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_text(path: str | Path, text: str,
                      encoding: str = "utf-8") -> Path:
    """Crash-safe text write: sideways file + fsync + ``os.replace``."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(text.encode(encoding))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(path.parent)
    return path


def atomic_write_bytes(path: str | Path, data: bytes) -> Path:
    """Crash-safe byte write: sideways file + fsync + ``os.replace``."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(path.parent)
    return path


class RunJournal:
    """Single-record JSON journal (schema-stamped, last write wins)."""

    SCHEMA = 1

    def __init__(self, path: str | Path):
        self.path = Path(path)

    def write(self, **record: Any) -> dict:
        rec = {"schema": self.SCHEMA, **record}
        atomic_write_text(self.path, json.dumps(rec, indent=2, sort_keys=True))
        return rec

    def read(self) -> dict | None:
        """The last committed record, or None when absent/unreadable —
        resume treats both as 'fresh run'."""
        try:
            text = self.path.read_text()
        except OSError:
            return None
        try:
            rec = json.loads(text)
        except json.JSONDecodeError:
            return None
        return rec if isinstance(rec, dict) else None
