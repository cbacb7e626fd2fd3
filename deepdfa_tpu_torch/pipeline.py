"""Content addressing of function sources.

A copy of ``normalize_source`` and ``source_key`` from
``deepdfa_tpu/pipeline.py`` (standard library only), so the port's embedding
cache keys a source exactly as the JAX package's caches do. The rest of that
module (the C frontend and the encode pipeline) is not ported yet.
"""

from __future__ import annotations

import hashlib

__all__ = ["normalize_source", "source_key"]


def normalize_source(code: str) -> str:
    """Whitespace-canonical form for content addressing: normalized line
    endings, trailing whitespace stripped, blank lines dropped. Two sources
    that differ only this way produce identical CPGs, so they must share
    one cache entry; anything deeper (comments, renames) changes bytes the
    frontend actually reads and stays a distinct key."""
    lines = (ln.rstrip() for ln in
             code.replace("\r\n", "\n").replace("\r", "\n").split("\n"))
    return "\n".join(ln for ln in lines if ln)


def source_key(code: str) -> str:
    """Content address of a scan request (sha256 of the normalized text)."""
    return hashlib.sha256(normalize_source(code).encode()).hexdigest()
