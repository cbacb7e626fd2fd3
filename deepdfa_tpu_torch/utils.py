"""Storage layout.

A copy of the directory helpers of ``deepdfa_tpu/utils.py``: the storage
root and its ``external``/``processed``/``cache`` children. The default
root is the repository's ``storage/`` directory, the JAX package's own, so
the two packages read each other's shard directories; the environment
variable ``DEEPDFA_STORAGE`` moves it. Every helper creates its directory
when it is first asked for.
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["project_dir", "storage_dir", "external_dir", "processed_dir",
           "cache_dir", "get_dir"]


def project_dir() -> Path:
    """Repository root (the directory holding the ``deepdfa_tpu_torch``
    package)."""
    return Path(__file__).resolve().parent.parent


def get_dir(path: Path | str) -> Path:
    """``mkdir -p`` and return (safe under concurrent callers)."""
    path = Path(path)
    path.mkdir(exist_ok=True, parents=True)
    return path


def storage_dir() -> Path:
    """Storage root: ``$DEEPDFA_STORAGE`` when set, else
    ``<repository>/storage``."""
    override = os.environ.get("DEEPDFA_STORAGE")
    return get_dir(Path(override) if override else project_dir() / "storage")


def external_dir() -> Path:
    """Downloaded or externally produced artifacts (split files)."""
    return get_dir(storage_dir() / "external")


def processed_dir() -> Path:
    """Training-ready artifacts (``{dataset}/shards[_sample]``)."""
    return get_dir(storage_dir() / "processed")


def cache_dir() -> Path:
    """Memoisation caches; safe to delete."""
    return get_dir(storage_dir() / "cache")
