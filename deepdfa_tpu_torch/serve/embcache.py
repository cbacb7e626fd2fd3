"""Content-addressed function-embedding cache for the hierarchical scorer.

A copy of ``deepdfa_tpu/serve/embcache.py`` (numpy and the standard library
only). The level-1 half of :mod:`deepdfa_tpu_torch.models.ggnn_hier` — the
per-function GGNN on the whole-model kernel — is the expensive part of
whole-unit scoring, yet a repo re-scan touches a handful of functions. This
cache makes a warm rescan pay zero level-1 dispatches: entries are keyed on
:func:`deepdfa_tpu_torch.pipeline.source_key` of the function's source
salted with the serving generation — ``model_rev``, the vocabulary content
hash and the feature configuration — so a new checkpoint, a re-vocabed
corpus or a feature flip each miss cleanly. The salt and the key formula
are the JAX package's, so both compute the same key for the same salt and
source.

Commit protocol: the raw float32 payload lands first via
:func:`~deepdfa_tpu_torch.resilience.journal.atomic_write_bytes`, then the
``{key}.json`` meta marker commits the entry. An entry exists iff its meta
exists; a torn write, a missing payload, a meta/payload digest mismatch or
a wrong-width blob all read as a miss, never as an exception. Writers race
benignly: identical content under content-addressed names, last
``os.replace`` wins. The ``embcache.cache_corrupt`` fault point corrupts one read's
payload, which then reads as a miss.
"""

from __future__ import annotations

import hashlib
import json
import threading
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from deepdfa_tpu_torch.pipeline import source_key
from deepdfa_tpu_torch.resilience import faults
from deepdfa_tpu_torch.resilience.journal import (atomic_write_bytes,
                                                  atomic_write_text)

__all__ = ["EMBCACHE_VERSION", "FunctionEmbeddingCache"]

# Bump when the level-1 embedding's output changes shape or content for the
# same (source, model_rev, vocab, features): old entries then miss instead
# of resurrecting embeddings from a different encoder.
EMBCACHE_VERSION = 1


@dataclass
class _Stats:
    hits: int = 0
    misses: int = 0
    corrupt: int = 0
    puts: int = 0


class FunctionEmbeddingCache:
    """``key(code) -> get/put`` of ``[dim]`` float32 pooled embeddings."""

    def __init__(self, root: str | Path, *, model_rev: str, vocab_hash: str,
                 feature_salt: str = "", dim: int | None = None,
                 version: int = EMBCACHE_VERSION):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.dim = dim
        # the generation salt: model revision × vocabulary × feature config,
        # folded into every key so entries of another serving identity
        # cannot collide
        self._salt = hashlib.sha256(
            f"embcache-v{int(version)}:{model_rev}:{vocab_hash}:"
            f"{feature_salt}".encode()).hexdigest()[:16]
        self._lock = threading.Lock()
        self._stats = _Stats()

    def key(self, code: str) -> str:
        """Content address of one function's source under this cache's
        serving generation (``source_key`` ⊕ model/vocab/feature salt)."""
        return hashlib.sha256(
            f"{source_key(code)}:{self._salt}".encode()).hexdigest()

    def _paths(self, key: str) -> tuple[Path, Path]:
        return self.root / f"{key}.f32", self.root / f"{key}.json"

    def get(self, key: str) -> np.ndarray | None:
        """The committed embedding for ``key``, or None (a miss). A torn,
        corrupt or injected-corrupt entry is a miss, never an exception."""
        payload_path, meta_path = self._paths(key)
        try:
            meta = json.loads(meta_path.read_text())
            blob = payload_path.read_bytes()
            if faults.fire("embcache.cache_corrupt"):
                blob = blob[: len(blob) // 2] + b"\x00corrupt"
            if meta.get("sha256") != hashlib.sha256(blob).hexdigest():
                raise ValueError("payload digest mismatch")
            emb = np.frombuffer(blob, np.float32)
            if emb.size != int(meta.get("dim", -1)):
                raise ValueError("payload width mismatch")
            if self.dim is not None and emb.size != self.dim:
                raise ValueError("embedding width != this scorer's out_dim")
        except FileNotFoundError:
            with self._lock:
                self._stats.misses += 1
            return None
        except Exception:  # noqa: BLE001 — a corrupt entry is a miss, by design
            with self._lock:
                self._stats.misses += 1
                self._stats.corrupt += 1
            return None
        with self._lock:
            self._stats.hits += 1
        return emb.copy()

    def put(self, key: str, emb: np.ndarray) -> None:
        """Commit payload first: the ``{key}.json`` meta marker is written
        only after the float32 payload is durably in place."""
        arr = np.ascontiguousarray(np.asarray(emb, np.float32).reshape(-1))
        payload_path, meta_path = self._paths(key)
        blob = arr.tobytes()
        atomic_write_bytes(payload_path, blob)
        atomic_write_text(meta_path, json.dumps({
            "schema": 1,
            "sha256": hashlib.sha256(blob).hexdigest(),
            "bytes": len(blob),
            "dim": int(arr.size),
        }))
        with self._lock:
            self._stats.puts += 1

    def __len__(self) -> int:
        return sum(1 for _ in self.root.glob("*.json"))

    def stats(self) -> dict:
        with self._lock:
            s = self._stats
            lookups = s.hits + s.misses
            return {
                "hits": s.hits,
                "misses": s.misses,
                "corrupt": s.corrupt,
                "puts": s.puts,
                "hit_rate": (s.hits / lookups) if lookups else 0.0,
            }
