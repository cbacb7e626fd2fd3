"""Columnar code-property-graph container.

A copy of ``deepdfa_tpu/cpg/schema.py`` (standard library only):
one node table + one edge table, with lazily built per-etype adjacency for
the traversals the analyses need. Node/edge vocabulary follows Joern's
schema (labels like ``CALL``, ``IDENTIFIER``, ``LOCAL``; edge types ``AST``,
``CFG``, ``ARGUMENT``, ``REACHING_DEF``, ...).

Edge direction convention: ``src → dst`` where ``src`` is Joern's
``outNode`` and ``dst`` its ``inNode``. :meth:`CPG.from_tables` builds one
from Joern's node and edge tables as row dicts (``cpg/joern.py``);
:func:`khop_neighbours` takes k-hop neighbourhoods through scipy's sparse
matrix powers.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Any, Iterable

import numpy as np

__all__ = ["Node", "CPG", "RDG_ETYPES", "rdg", "khop_neighbours"]


@dataclasses.dataclass
class Node:
    id: int
    label: str  # Joern ``_label``
    name: str = ""
    code: str = ""
    line: int | None = None
    order: int = 0
    type_full_name: str = ""


class CPG:
    """In-memory CPG with per-etype adjacency.

    ``nodes``: dict id → :class:`Node`. ``edges``: list of (src, dst, etype).
    """

    def __init__(self, nodes: Iterable[Node], edges: Iterable[tuple[int, int, str]]):
        self.nodes: dict[int, Node] = {n.id: n for n in nodes}
        self.edges: list[tuple[int, int, str]] = [
            (int(s), int(d), e) for s, d, e in edges
        ]
        self._succ: dict[str, dict[int, list[int]]] = {}
        self._pred: dict[str, dict[int, list[int]]] = {}

    # -- construction -----------------------------------------------------
    @classmethod
    def from_tables(cls, node_rows: Iterable[dict],
                    edge_rows: Iterable[dict]) -> "CPG":
        """Build from Joern tables as row dicts with reference-compatible
        columns (``id,_label,name,code,lineNumber,order,typeFullName`` /
        ``outnode,innode,etype``)."""
        def _int_or_none(v):
            try:
                return int(v)
            except (TypeError, ValueError):
                return None

        nodes = [
            Node(
                id=int(r["id"]),
                label=str(r.get("_label", "")),
                name=str(r.get("name", "")),
                code=str(r.get("code", "")),
                line=_int_or_none(r.get("lineNumber")),
                order=_int_or_none(r.get("order")) or 0,
                type_full_name=str(r.get("typeFullName", "")),
            )
            for r in node_rows
        ]
        edges = [(int(r["outnode"]), int(r["innode"]), str(r["etype"]))
                 for r in edge_rows]
        return cls(nodes, edges)

    # -- adjacency --------------------------------------------------------
    def _build(self, etype: str) -> None:
        succ: dict[int, list[int]] = defaultdict(list)
        pred: dict[int, list[int]] = defaultdict(list)
        for s, d, e in self.edges:
            if e == etype:
                succ[s].append(d)
                pred[d].append(s)
        self._succ[etype] = succ
        self._pred[etype] = pred

    def successors(self, node: int, etype: str) -> list[int]:
        if etype not in self._succ:
            self._build(etype)
        return self._succ[etype].get(node, [])

    def predecessors(self, node: int, etype: str) -> list[int]:
        if etype not in self._pred:
            self._build(etype)
        return self._pred[etype].get(node, [])

    def edge_nodes(self, etype: str) -> set[int]:
        """All nodes participating in at least one ``etype`` edge."""
        if etype not in self._succ:
            self._build(etype)
        out: set[int] = set()
        out.update(self._succ[etype])
        out.update(self._pred[etype])
        return out

    def edge_arrays(self, etype: str) -> tuple[np.ndarray, np.ndarray]:
        """(src, dst) int64 arrays for one edge type."""
        src = [s for s, d, e in self.edges if e == etype]
        dst = [d for s, d, e in self.edges if e == etype]
        return np.array(src, dtype=np.int64), np.array(dst, dtype=np.int64)

    # -- traversal helpers used by the analyses ---------------------------
    def ast_descendants(self, root: int, skip_labels: frozenset[str] = frozenset()) -> list[int]:
        """All AST-reachable nodes below ``root`` (excluding it), skipping
        subtrees rooted at nodes whose label is in ``skip_labels``."""
        out: list[int] = []
        stack = list(self.successors(root, "AST"))
        seen = {root}
        while stack:
            n = stack.pop()
            if n in seen:
                continue
            seen.add(n)
            if n in self.nodes and self.nodes[n].label in skip_labels:
                continue
            out.append(n)
            stack.extend(self.successors(n, "AST"))
        return out

    def arguments(self, call: int) -> dict[int, int]:
        """ARGUMENT successors keyed by their ``order`` (1-based)."""
        return {self.nodes[a].order: a for a in self.successors(call, "ARGUMENT") if a in self.nodes}

    def attr(self, name: str) -> dict[int, Any]:
        return {i: getattr(n, name) for i, n in self.nodes.items()}

    def __len__(self) -> int:
        return len(self.nodes)

    def __repr__(self) -> str:
        kinds = defaultdict(int)
        for _, _, e in self.edges:
            kinds[e] += 1
        return f"CPG({len(self.nodes)} nodes, {dict(kinds)})"


# gtype → edge types, parity with the reference's ``rdg``
# (``DDFA/sastvd/helpers/joern.py:419-441``). "cfg" is the golden config.
RDG_ETYPES: dict[str, tuple[str, ...]] = {
    "reftype": ("EVAL_TYPE", "REF"),
    "ast": ("AST",),
    "pdg": ("REACHING_DEF", "CDG"),
    "cfgcdg": ("CFG", "CDG"),
    "cfg": ("CFG",),
    "all": ("REACHING_DEF", "CDG", "AST", "EVAL_TYPE", "REF"),
    "dataflow": ("CFG", "AST"),
}


def rdg(cpg: "CPG", gtype: str) -> list[tuple[int, int]]:
    """Deduped (src, dst) edge list of the ``gtype`` subgraph."""
    etypes = RDG_ETYPES.get(gtype)
    if etypes is None:
        raise ValueError(f"unknown gtype {gtype!r}; known: {sorted(RDG_ETYPES)}")
    return sorted({(s, d) for s, d, e in cpg.edges if e in etypes})


def khop_neighbours(
    cpg: "CPG",
    node_ids: list[int],
    hop: int = 1,
    gtype: str = "all",
    intermediate: bool = True,
) -> dict[int, list[int]]:
    """Neighbours within ``hop`` steps (undirected), via sparse matrix powers
    (parity: ``joern.py:372-416``). ``intermediate=True`` unions hops 1..k;
    otherwise only exactly-k-step neighbours are returned."""
    from scipy import sparse

    edges = rdg(cpg, gtype)
    ids = sorted(cpg.nodes)
    id2adj = {nid: i for i, nid in enumerate(ids)}
    n = len(ids)
    rows, cols = [], []
    for s, d in edges:
        rows += [id2adj[s], id2adj[d]]
        cols += [id2adj[d], id2adj[s]]
    coo = sparse.coo_matrix(
        (np.ones(len(rows)), (rows, cols)), shape=(n, n)
    ).tocsr()
    out: dict[int, list[int]] = {nid: [] for nid in node_ids}
    hops = range(1, hop + 1) if intermediate else [hop]
    for h in hops:
        csr = coo**h
        for nid in node_ids:
            row = csr[id2adj[nid]].toarray()[0].nonzero()[0]
            out[nid] += [ids[i] for i in row]
    return out
