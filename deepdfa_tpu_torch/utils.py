"""Storage layout, run ids and host seeding.

A copy of the directory helpers of ``deepdfa_tpu/utils.py``: the storage
root and its ``external``/``processed``/``cache`` children, ``get_run_id``
and ``seed_all``. The default
root is the repository's ``storage/`` directory, the JAX package's own, so
the two packages read each other's shard directories; the environment
variable ``DEEPDFA_STORAGE`` moves it. Every helper creates its directory
when it is first asked for.
"""

from __future__ import annotations

import datetime
import os
import random
from pathlib import Path
from typing import Sequence

import numpy as np

__all__ = ["project_dir", "storage_dir", "external_dir", "processed_dir",
           "cache_dir", "get_dir", "get_run_id", "seed_all"]


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


def get_run_id(args: Sequence[str] | None = None) -> str:
    """Timestamped unique run id, e.g. ``202607290755_1a2b3c_fit``
    (timestamp + short random hex + optional slug), reproducible after
    :func:`seed_all`."""
    stamp = datetime.datetime.now().strftime("%Y%m%d%H%M%S")
    nonce = "%06x" % random.randrange(16**6)
    slug = "_".join(str(a) for a in args) if args else ""
    return f"{stamp}_{nonce}" + (f"_{slug}" if slug else "")


def seed_all(seed: int = 0) -> None:
    """Seed the host generators (``random``, numpy's global one). The
    trainer draws from explicit generators seeded by the config."""
    random.seed(seed)
    np.random.seed(seed)
