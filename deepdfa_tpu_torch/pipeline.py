"""Source → CPG → encoded-graph pipeline shared by scan and serving.

A copy of ``deepdfa_tpu/pipeline.py``: one canonical path from raw C text
to model-ready :class:`~deepdfa_tpu_torch.data.graphs.Graph`\\ s — the
front end, the dependence-edge pass, the training-vocabulary encoding (new
code is encoded with the vocabulary the checkpoint was trained on, never
one rebuilt from the code being scanned) and the CFG node selection, all
decided here once. Given the same source and vocabularies it gives the JAX
package's graphs bit for bit.

Also home to the content-addressing primitives the caches share:
:func:`normalize_source`/:func:`source_key` and :func:`vocab_content_hash`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path

__all__ = [
    "EncodedFunction",
    "load_vocabs",
    "all_subkeys",
    "encode_cpg",
    "encode_source",
    "normalize_source",
    "source_key",
    "vocab_content_hash",
]


def load_vocabs(shard_dir: Path | str) -> dict:
    """The training vocabularies from a shard dir's ``vocab.json`` (as the
    JAX package's preprocessing writes it): name → :class:`~deepdfa_tpu_torch.
    data.vocab.Vocabulary`.

    Requires the full serialised form (``Vocabulary.to_dict``): the legacy
    ``all_vocab``-only format cannot encode new code (UNKNOWN substitution
    needs the subkey vocabs), so it is rejected rather than silently
    mis-encoding every definition.
    """
    from deepdfa_tpu_torch.data.vocab import Vocabulary

    path = Path(shard_dir) / "vocab.json"
    data = json.loads(path.read_text())
    first = next(iter(data.values()), None)
    if not isinstance(first, dict) or "subkey_vocabs" not in first:
        raise ValueError(
            f"{path} is the legacy all_vocab-only format and cannot encode "
            "new source; re-run the preprocessing to write the full "
            "vocabulary (cfg + subkey_vocabs + all_vocab)"
        )
    return {name: Vocabulary.from_dict(d) for name, d in data.items()}


def all_subkeys(vocabs: dict) -> tuple[str, ...]:
    """Union of subkeys across vocabs, in first-seen order. Stage-2 hashes
    must cover every subkey any vocabulary reads."""
    seen: dict[str, None] = {}
    for voc in vocabs.values():
        for sk in voc.cfg.subkeys:
            seen.setdefault(sk)
    return tuple(seen)


def encode_cpg(cpg, gid: int, vocabs: dict):
    """CPG → (Graph with training-vocab feature ids, CFG node-id order)."""
    from deepdfa_tpu_torch.cpg.features import (extract_features,
                                                features_to_hashes)
    from deepdfa_tpu_torch.data.materialize import (graph_from_cpg,
                                                    select_cfg_nodes)

    feats = extract_features(cpg, gid)
    hashes: dict[int, str] = {}
    if feats:
        hashes = {int(r["node_id"]): r["hash"]
                  for r in features_to_hashes(feats, all_subkeys(vocabs))}
    feat_ids = {
        name: {n: voc.feature_id(h) for n, h in hashes.items()}
        for name, voc in vocabs.items()
    }
    selection = select_cfg_nodes(cpg, "cfg")
    g = graph_from_cpg(cpg, gid, feat_ids, graph_label=0, selection=selection)
    return g, selection[0]


@dataclasses.dataclass(frozen=True)
class EncodedFunction:
    """One function out of :func:`encode_source`.

    ``graph is None`` ⇔ ``error`` says why (a function with no CFG nodes is
    a per-function error row). ``cpg`` is kept only when the caller asks
    (the interprocedural scan reuses it instead of parsing again).
    """

    name: str
    graph: object | None
    node_ids: tuple[int, ...]
    cpg: object | None = None
    error: str | None = None


def encode_source(
    code: str, vocabs: dict, *, keep_cpg: bool = True,
    backend: str = "native",
) -> list[EncodedFunction]:
    """Parse + dependence-edge + encode every function in ``code``.

    Front-end failures propagate (``FrontendError``) — the caller decides
    whether that is a per-file error row or a rejected request; a function
    that parses but has no scoreable CFG is an :class:`EncodedFunction`
    with ``error`` set. ``backend`` is the dependence-edge pass's solver
    (``cpg.features.SOLVER_BACKENDS``); every backend gives the same graphs.
    """
    from deepdfa_tpu_torch.cpg.features import add_dependence_edges
    from deepdfa_tpu_torch.cpg.frontend import parse_functions

    out: list[EncodedFunction] = []
    for fname, cpg in parse_functions(code):
        cpg = add_dependence_edges(cpg, backend=backend)
        g, node_ids = encode_cpg(cpg, 0, vocabs)
        if g is None:
            out.append(EncodedFunction(
                fname, None, (), None, "no CFG nodes survived selection"))
        else:
            out.append(EncodedFunction(
                fname, g, tuple(int(n) for n in node_ids),
                cpg if keep_cpg else None))
    return out


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


def vocab_content_hash(vocabs: dict) -> str:
    """Deterministic digest of the full vocabulary content (every name →
    ``Vocabulary.to_dict``, key-sorted): the JAX package's digest of the
    same vocabularies."""
    payload = json.dumps(
        {name: voc.to_dict() for name, voc in sorted(vocabs.items())},
        sort_keys=True,
    )
    return hashlib.sha256(payload.encode()).hexdigest()[:16]
