"""Content-addressed scan cache: normalized source → encoded graphs + scores.

A copy of ``deepdfa_tpu/serve/cache.py``. The dominant cost of a scan is everything BEFORE the model — parsing,
dependence edges, feature extraction, vocab encoding (the "frontend").
Keying on the content address of the *normalized* source text
(:func:`deepdfa_tpu_torch.pipeline.source_key`) means a repeated scan of the
same function skips all of it; whitespace-only edits share the entry.

Entries hold two layers that fill independently:

- ``encoded`` — the :class:`~deepdfa_tpu_torch.pipeline.EncodedFunction` list,
  written as soon as the frontend succeeds;
- ``results`` — the final per-function score rows, written only after the
  engine scored them.

A request that raced a fault (``serve.engine_raises``) leaves ``encoded``
behind, so its retry skips the frontend and only re-scores — hence two
hit counters (``hits`` = full result hit, ``encode_hits`` = frontend
skipped but scoring re-ran). Eviction is plain LRU under one lock;
``capacity=0`` disables caching entirely (every lookup is a miss).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass

__all__ = ["ScanEntry", "ScanCache"]


@dataclass
class ScanEntry:
    encoded: list | None = None
    results: list | None = None


@dataclass
class _Stats:
    hits: int = 0
    encode_hits: int = 0
    misses: int = 0
    evictions: int = 0


class ScanCache:
    """Thread-safe LRU over ``source_key(code)`` → :class:`ScanEntry`."""

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._entries: OrderedDict[str, ScanEntry] = OrderedDict()
        self._stats = _Stats()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def lookup(self, key: str) -> ScanEntry | None:
        """Get-and-touch. Counts one hit (full or encode-level) or miss."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None or self.capacity == 0:
                self._stats.misses += 1
                return None
            self._entries.move_to_end(key)
            if entry.results is not None:
                self._stats.hits += 1
            elif entry.encoded is not None:
                self._stats.encode_hits += 1
            else:  # placeholder left by a failed fill — treat as a miss
                self._stats.misses += 1
                return None
            return entry

    def store(self, key: str, *, encoded=None, results=None) -> None:
        """Create or deepen the entry for ``key`` (does not count a hit)."""
        if self.capacity == 0:
            return
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                entry = ScanEntry()
                self._entries[key] = entry
            if encoded is not None:
                entry.encoded = encoded
            if results is not None:
                entry.results = results
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self._stats.evictions += 1

    def stats(self) -> dict:
        """Counters + derived hit rate (full hits ÷ lookups)."""
        with self._lock:
            s = self._stats
            lookups = s.hits + s.encode_hits + s.misses
            return {
                "hits": s.hits,
                "encode_hits": s.encode_hits,
                "misses": s.misses,
                "evictions": s.evictions,
                "entries": len(self._entries),
                "hit_rate": (s.hits / lookups) if lookups else 0.0,
            }
