"""Warm-start store: content-addressed exported bucket programs.

The port of ``deepdfa_tpu/serve/warmstore.py``. The FIRST engine to warm
a bucket exports its scoring program (``torch.export``, the path
:mod:`deepdfa_tpu_torch.serving` uses, every kernel call a registered op)
and commits it here under a content address derived from everything that
determines the program — vocab hash, model revision (a content hash of the
parameters with the framework and the device kind folded in), precision,
label style, feature keys, and the bucket's padded shape. A joining
replica whose key matches loads the program instead of tracing its own
model; the difference is journaled as ``compile_seconds_saved``. A key
never matches a JAX store's entry (the revisions differ), so a torch
joiner never reads a StableHLO payload.

Commit protocol mirrors the checkpoint invariant (ROADMAP resilience #1):
the payload lands first, then the ``.json`` meta commits via one
``os.replace`` — an entry EXISTS iff its meta parses, so a ``kill -9``
mid-put costs a re-compile, never a torn artifact. Keys are shared-
nothing across model revisions: a new checkpoint hashes to new keys and
old entries simply stop being read (GC is an ``ls``-and-unlink away, the
store never mutates an entry in place).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from pathlib import Path

from deepdfa_tpu_torch.resilience.journal import atomic_write_text

__all__ = ["WarmEntry", "WarmStore", "bucket_artifact_key"]


def bucket_artifact_key(vocab_hash: str | None, model_rev: str | None,
                        precision: str, label_style: str, feat_keys,
                        max_graphs: int, max_nodes: int,
                        max_edges: int) -> str:
    """Content address of one bucket's compiled program. Everything that
    changes the lowered module must be in the key — two replicas agree on
    a key exactly when the loaded program is bit-for-bit usable."""
    payload = "|".join([
        vocab_hash or "novocab", model_rev or "norev", precision,
        label_style, ",".join(feat_keys),
        f"{max_graphs}x{max_nodes}x{max_edges}",
    ])
    return hashlib.sha256(payload.encode()).hexdigest()[:24]


@dataclasses.dataclass(frozen=True)
class WarmEntry:
    """One committed artifact: the saved exported program plus the
    meta the populating replica recorded (``compile_seconds`` is what a
    loader saves by not compiling)."""

    key: str
    payload: bytes
    meta: dict


class WarmStore:
    """Directory of ``{key}.pt2`` + ``{key}.json`` pairs. The meta
    json is the commit marker (written last, atomically); ``get`` treats
    anything without a parseable meta as absent."""

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _payload_path(self, key: str) -> Path:
        return self.root / f"{key}.pt2"

    def _meta_path(self, key: str) -> Path:
        return self.root / f"{key}.json"

    def get(self, key: str) -> WarmEntry | None:
        try:
            meta = json.loads(self._meta_path(key).read_text())
            payload = self._payload_path(key).read_bytes()
        except (FileNotFoundError, OSError, json.JSONDecodeError):
            return None
        if not isinstance(meta, dict):
            return None
        return WarmEntry(key=key, payload=payload, meta=meta)

    def put(self, key: str, payload: bytes, meta: dict) -> WarmEntry:
        """Commit an artifact: payload sideways + replace, THEN the meta —
        a reader that sees the meta is guaranteed a whole payload."""
        ppath = self._payload_path(key)
        tmp = ppath.with_name(ppath.name + ".tmp")
        tmp.write_bytes(payload)
        os.replace(tmp, ppath)
        atomic_write_text(self._meta_path(key), json.dumps(meta, indent=2,
                                                           sort_keys=True))
        return WarmEntry(key=key, payload=payload, meta=dict(meta))

    def keys(self) -> list[str]:
        """Committed keys only (meta present and parseable)."""
        out = []
        for p in sorted(self.root.glob("*.json")):
            key = p.stem
            if self.get(key) is not None:
                out.append(key)
        return out

    def stats(self) -> dict:
        keys = self.keys()
        return {
            "entries": len(keys),
            "bytes": sum(self._payload_path(k).stat().st_size for k in keys),
        }
