"""Encode sessions: ``encode_source`` behind the extraction supervisor.

A copy of the thread half of ``deepdfa_tpu/serve/frontend.py``. The scan's
:class:`~deepdfa_tpu_torch.data.extraction.ExtractionPool` builds its
encode sessions from :func:`encode_session_factory`, as the JAX package's
scan and online frontend both do. Failure classification:
:data:`ENCODE_ITEM_ERRORS` members mean the item failed to encode (an
error row); anything else implicates the session.

Not ported yet: ``FrontendPool`` and process-mode sessions (ROADMAP A6).
"""

from __future__ import annotations

from typing import Callable

from deepdfa_tpu_torch.data.extraction import ExtractionItemError
from deepdfa_tpu_torch.resilience.supervisor import QuarantinedError

__all__ = ["ENCODE_ITEM_ERRORS", "ThreadEncodeSession",
           "encode_session_factory"]

# the ITEM failed to encode; everything else implicates the session
ENCODE_ITEM_ERRORS: tuple[type[BaseException], ...] = (
    ExtractionItemError, QuarantinedError)


class ThreadEncodeSession:
    """In-process encode session: one vocab closure. Every encode failure
    is an :class:`ExtractionItemError` — in-process there is no session
    infrastructure to implicate, only the item.

    ``keep_cpg=False`` (the default) returns (name, Graph, node_ids) only;
    the interprocedural scan turns it on so its supergraph pass reuses the
    parsed per-function CPGs instead of parsing every source again."""

    def __init__(self, vocabs, *, keep_cpg: bool = False):
        self._vocabs = vocabs
        self._keep_cpg = keep_cpg

    def encode(self, code: str):
        from deepdfa_tpu_torch.pipeline import encode_source

        try:
            return encode_source(code, self._vocabs, keep_cpg=self._keep_cpg)
        except Exception as exc:  # noqa: BLE001 — item error by definition
            raise ExtractionItemError(f"{type(exc).__name__}: {exc}") from exc

    def close(self) -> None:
        pass


def encode_session_factory(vocabs, *, keep_cpg: bool = False) -> Callable:
    """One ``session_factory(worker_id)`` for the scan's extraction pool: a
    :class:`ThreadEncodeSession` per worker (the JAX package's
    ``mode="thread"``; its ``FrontendConfig`` and process mode wait for
    ROADMAP A6)."""

    def factory(worker_id: int = 0):
        return ThreadEncodeSession(vocabs, keep_cpg=keep_cpg)

    return factory
