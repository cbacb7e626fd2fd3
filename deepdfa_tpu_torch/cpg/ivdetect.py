"""IVDetect per-statement features and the corpus-wide statement labels.

A copy of ``deepdfa_tpu/cpg/ivdetect.py`` (reference
``DDFA/sastvd/helpers/evaluate.py``):

- :func:`feature_extraction` (``:19-191``): per-line records (tokenised
  subtoken sequence, line-local AST subgraph, variable type/name pairs,
  data/control dependency context) plus the line-level PDG edges;
- :func:`statement_labels` (``:239-255``): the ``statement_labels.pkl``
  cache mapping function id → removed lines + dependent-added lines.

Both caches are pickles of plain data. They are read through an unpickler
that resolves no class beyond the builtin containers and numbers, so a
cache the JAX package wrote in a shared directory loads (its payload is
the same plain data) and a pickle naming anything else is refused; a
refused or unreadable cache is recomputed and rewritten.
"""

from __future__ import annotations

import io
import logging
import pickle
from pathlib import Path
from typing import Any, Callable, Iterable, Mapping, Sequence

from deepdfa_tpu_torch.cpg.schema import CPG
from deepdfa_tpu_torch.data.tokenise import tokenise
from deepdfa_tpu_torch.resilience.journal import atomic_write_bytes

__all__ = [
    "line_dependency_context",
    "feature_extraction",
    "statement_labels",
]

logger = logging.getLogger("deepdfa_tpu_torch")

_PLAIN = frozenset({"dict", "list", "tuple", "set", "frozenset", "int",
                    "str", "bool"})


class _PlainUnpickler(pickle.Unpickler):
    """Admits the builtin containers and scalars only."""

    def find_class(self, module: str, name: str):
        if module == "builtins" and name in _PLAIN:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"refusing {module}.{name}")


def _load_plain(path: Path):
    """The cached value at ``path``, or None when it is missing, unreadable
    or names a class outside the plain containers."""
    try:
        data = path.read_bytes()
    except OSError:
        return None
    try:
        return _PlainUnpickler(io.BytesIO(data)).load()
    except Exception as exc:  # noqa: BLE001 — refused or corrupt: recompute
        logger.warning("ignoring cache %s: %s", path, exc)
        return None


def line_dependency_context(cpg: CPG) -> tuple[dict[int, set[int]], dict[int, set[int]]]:
    """(data, control): per-line dependency neighbour sets.

    REACHING_DEF edges become the DDG context, CDG edges the control context
    (``evaluate.py:142-171``): projected onto line numbers, symmetrised,
    self-loops dropped.
    """
    line_of = {i: n.line for i, n in cpg.nodes.items() if n.line is not None}
    data: dict[int, set[int]] = {}
    control: dict[int, set[int]] = {}
    for s, d, e in cpg.edges:
        ctx = data if e == "REACHING_DEF" else control if e == "CDG" else None
        if ctx is None:
            continue
        ls, ld = line_of.get(s), line_of.get(d)
        if ls is None or ld is None or ls == ld:
            continue
        ctx.setdefault(ls, set()).add(ld)
        ctx.setdefault(ld, set()).add(ls)
    return data, control


def _line_nodes(cpg: CPG) -> dict[int, list[int]]:
    """line → node ids on that line, in id order."""
    by_line: dict[int, list[int]] = {}
    for i in sorted(cpg.nodes):
        n = cpg.nodes[i]
        if n.line is not None:
            by_line.setdefault(n.line, []).append(i)
    return by_line


def _subseq(cpg: CPG, nodes_on_line: Sequence[int]) -> str:
    """Tokenised code of the line: the longest-code node on the line (the
    statement root, ``:53-66``), prefixed with the declared local's type
    when the line declares one."""
    best = max(nodes_on_line, key=lambda i: len(cpg.nodes[i].code), default=None)
    if best is None:
        return ""
    local_type = next(
        (cpg.nodes[i].type_full_name for i in nodes_on_line
         if cpg.nodes[i].label == "LOCAL" and cpg.nodes[i].type_full_name),
        "",
    )
    return tokenise(f"{local_type} {cpg.nodes[best].code}".strip())


def _line_ast(cpg: CPG, nodes_on_line: Sequence[int]) -> list[list[Any]]:
    """``[outnodes, innodes, token_lists]`` of the line-local AST in per-line
    indices, with lone nodes and parent roots re-wired under index 0 so the
    sub-graph is connected (``evaluate.py:69-103``)."""
    idx = {nid: k for k, nid in enumerate(nodes_on_line)}
    outs: list[int] = []
    ins: list[int] = []
    for s, d, e in cpg.edges:
        if e == "AST" and s in idx and d in idx:
            outs.append(idx[s])
            ins.append(idx[d])
    lone = [k for k in idx.values() if k not in outs and k not in ins]
    parents = [k for k in outs if k not in ins]
    for k in sorted(set(lone + parents) - {0}):
        outs.append(0)
        ins.append(k)
    codes = [tokenise(cpg.nodes[nid].code) for nid in nodes_on_line]
    return [outs, ins, codes]


def _nametypes(cpg: CPG, nodes_on_line: Sequence[int]) -> str:
    """Tokenised ``type name`` pairs of identifiers/declarations on the line
    (``evaluate.py:105-123``)."""
    pairs: list[str] = []
    seen: set[tuple[str, str]] = set()
    for i in nodes_on_line:
        n = cpg.nodes[i]
        if n.label not in ("IDENTIFIER", "LOCAL", "METHOD_PARAMETER_IN"):
            continue
        if not n.name or not n.type_full_name:
            continue
        key = (n.type_full_name, n.name)
        if key in seen:
            continue
        seen.add(key)
        pairs.append(f"{tokenise(n.type_full_name)} {tokenise(n.name)}".strip())
    return " ".join(p for p in pairs if p)


def feature_extraction(
    cpg: CPG,
    cache_dir: str | Path | None = None,
    key: str | None = None,
) -> tuple[list[dict[str, Any]], tuple[list[int], list[int]]]:
    """IVDetect code representation of one function.

    Returns ``(rows, pdg_edges)``: ``rows`` is one record per PDG line —
    ``{"line", "subseq", "ast", "nametypes", "data", "control"}`` sorted by
    line — and ``pdg_edges`` is ``(outnode_idxs, innode_idxs)`` between row
    indices (``:172-190``). Lines in no data/control dependency are dropped.
    ``cache_dir`` + ``key`` enable the per-function pickle cache.
    """
    cachefp = None
    if cache_dir is not None and key is not None:
        cachefp = Path(cache_dir) / f"{key}.pkl"
        cached = _load_plain(cachefp) if cachefp.exists() else None
        if cached is not None:
            return cached

    data, control = line_dependency_context(cpg)
    by_line = _line_nodes(cpg)
    rows: list[dict[str, Any]] = []
    for line in sorted(set(data) | set(control)):
        nodes_on_line = by_line.get(line, [])
        rows.append(
            {
                "line": line,
                "subseq": _subseq(cpg, nodes_on_line),
                "ast": _line_ast(cpg, nodes_on_line),
                "nametypes": _nametypes(cpg, nodes_on_line),
                "data": sorted(data.get(line, ())),
                "control": sorted(control.get(line, ())),
            }
        )
    row_idx = {r["line"]: k for k, r in enumerate(rows)}
    pairs: set[tuple[int, int]] = set()  # dedupe data+control-coupled pairs
    for line, neighbours in list(data.items()) + list(control.items()):
        for other in neighbours:
            if line in row_idx and other in row_idx:
                pairs.add((row_idx[line], row_idx[other]))
    ordered = sorted(pairs)
    result = (rows, ([p[0] for p in ordered], [p[1] for p in ordered]))

    if cachefp is not None:
        Path(cache_dir).mkdir(parents=True, exist_ok=True)
        atomic_write_bytes(cachefp, pickle.dumps(result))
    return result


def statement_labels(
    records: Iterable[Mapping[str, Any]],
    cpgs: Mapping[int, CPG],
    parse: Callable[[str], CPG],
    cache_path: str | Path | None = None,
    cache: bool = True,
) -> dict[int, dict[str, list[int]]]:
    """Corpus-wide statement labels: ``{id: {"removed": [...], "depadd": [...]}}``.

    Computed once for the vulnerable rows (removed lines from the diff
    labels, dependent-added lines by :func:`~deepdfa_tpu_torch.cpg.features.
    dep_add_lines` on the before/after CPG pair) and pickled; later calls
    load the cache. A failed after-parse degrades to ``depadd=[]``
    (``:225-240``)."""
    from deepdfa_tpu_torch.cpg.features import dep_add_lines

    if cache_path is not None:
        cache_path = Path(cache_path)
        if cache and cache_path.exists():
            cached = _load_plain(cache_path)
            if cached is not None:
                return cached

    out: dict[int, dict[str, list[int]]] = {}
    for row in records:
        fid = int(row["id"])
        if int(row.get("vul", 1)) != 1 or fid not in cpgs:
            continue
        removed = sorted(set(row.get("removed") or []))
        added = list(row.get("added") or [])
        depadd: list[int] = []
        if added and row.get("after"):
            try:
                depadd = dep_add_lines(cpgs[fid], parse(row["after"]), added)
            except Exception:  # noqa: BLE001 — label fallback: removed only
                depadd = []
        out[fid] = {"removed": removed, "depadd": depadd}

    if cache_path is not None:
        cache_path.parent.mkdir(parents=True, exist_ok=True)
        atomic_write_bytes(cache_path, pickle.dumps(out))
    return out
