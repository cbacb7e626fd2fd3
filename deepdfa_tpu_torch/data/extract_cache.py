"""On-disk content-addressed extraction cache: normalized source → encoded
functions.

A copy of ``deepdfa_tpu/data/extract_cache.py``. A re-scan pays only for
changed files: entries are keyed on :func:`deepdfa_tpu_torch.pipeline.
source_key` (the whitespace-normalized sha256, so a whitespace-only edit
shares the entry) salted with an extractor-version / vocabulary component,
so bumping the front end or re-vocabing misses cleanly.

What differs from the JAX package: the salt also carries a component of
the port's own, so a directory the JAX package wrote into reads as misses
here (its pickles name the JAX package's classes), and entries are read
through an unpickler that only resolves this package's classes, numpy and
plain containers: a foreign entry that happened to share a key would read
as a corrupt miss, never import another package.

Commit protocol: the pickled payload lands first via
``atomic_write_bytes``, then the ``{key}.json`` meta marker commits the
entry via ``atomic_write_text``. An entry exists iff its meta exists; a
torn write, a missing payload, a meta/payload digest mismatch or an
unreadable blob all read as a miss — never as a decode crash. Writers race
benignly: both write identical content under content-addressed names, last
``os.replace`` wins. The ``extract.cache_corrupt`` fault point corrupts one read's
payload, which then reads as a miss.
"""

from __future__ import annotations

import hashlib
import io
import json
import pickle
import threading
from dataclasses import dataclass
from pathlib import Path

from deepdfa_tpu_torch.resilience import faults
from deepdfa_tpu_torch.resilience.journal import (atomic_write_bytes,
                                                  atomic_write_text)

__all__ = ["EXTRACTOR_VERSION", "ExtractCache"]

# Bump when the extraction pipeline's output changes for the same source
# text (front-end node schema, dependence-edge pass, feature extraction) —
# old entries then miss instead of resurrecting stale graphs.
EXTRACTOR_VERSION = 1

# the key component that keeps the port's entries apart from the JAX
# package's in a shared directory
PORT_SALT = "deepdfa_tpu_torch"

_SAFE_BUILTINS = frozenset({"set", "frozenset", "dict", "list", "tuple",
                            "int", "float", "complex", "str", "bytes",
                            "bytearray", "bool", "slice", "range"})


class _PortUnpickler(pickle.Unpickler):
    """Resolves this package's classes, numpy's and plain containers only."""

    def find_class(self, module: str, name: str):
        top = module.split(".")[0]
        if (top in ("deepdfa_tpu_torch", "numpy", "collections", "copyreg")
                or (module == "builtins" and name in _SAFE_BUILTINS)):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"refusing {module}.{name}")


@dataclass
class _Stats:
    hits: int = 0
    misses: int = 0
    corrupt: int = 0
    puts: int = 0


class ExtractCache:
    """``key(code) -> get/put`` over one directory of committed entries."""

    def __init__(self, root: str | Path, *, salt: str = ""):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        # the extractor-version / vocab-salt / port key component: folded
        # into every key so entries from another pipeline generation or
        # another package cannot collide
        self._salt = hashlib.sha256(
            f"{PORT_SALT}:extractor-v{EXTRACTOR_VERSION}:{salt}".encode()
        ).hexdigest()[:16]
        self._lock = threading.Lock()
        self._stats = _Stats()

    # -- keys ---------------------------------------------------------------
    def key(self, code: str) -> str:
        """Content address of one source under this cache's generation."""
        from deepdfa_tpu_torch.pipeline import source_key

        return hashlib.sha256(
            f"{source_key(code)}:{self._salt}".encode()).hexdigest()

    def _paths(self, key: str) -> tuple[Path, Path]:
        return self.root / f"{key}.pkl", self.root / f"{key}.json"

    # -- protocol -----------------------------------------------------------
    def get(self, key: str):
        """The committed payload for ``key``, or None (MISS). Any torn,
        corrupt, foreign or injected-corrupt entry is a MISS, never an
        exception."""
        payload_path, meta_path = self._paths(key)
        try:
            meta = json.loads(meta_path.read_text())
            blob = payload_path.read_bytes()
            if faults.fire("extract.cache_corrupt"):
                blob = blob[: len(blob) // 2] + b"\x00corrupt"
            if meta.get("sha256") != hashlib.sha256(blob).hexdigest():
                raise ValueError("payload digest mismatch")
            value = _PortUnpickler(io.BytesIO(blob)).load()
        except FileNotFoundError:
            with self._lock:
                self._stats.misses += 1
            return None
        except Exception:  # noqa: BLE001 — corrupt entry == miss, by design
            with self._lock:
                self._stats.misses += 1
                self._stats.corrupt += 1
            return None
        with self._lock:
            self._stats.hits += 1
        return value

    def put(self, key: str, value) -> None:
        """Commit payload-first: the ``{key}.json`` meta marker is written
        only after the pickled payload is durably in place."""
        payload_path, meta_path = self._paths(key)
        blob = pickle.dumps(value)
        atomic_write_bytes(payload_path, blob)
        atomic_write_text(meta_path, json.dumps({
            "schema": 1,
            "sha256": hashlib.sha256(blob).hexdigest(),
            "bytes": len(blob),
        }))
        with self._lock:
            self._stats.puts += 1

    def get_or_extract(self, code: str, extract):
        """``(value, hit)`` — the committed payload for ``code``, or
        ``extract(code)`` committed on the way out."""
        k = self.key(code)
        value = self.get(k)
        if value is not None:
            return value, True
        value = extract(code)
        self.put(k, value)
        return value, False

    # -- accounting ---------------------------------------------------------
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
