"""Abstract-dataflow feature extraction over CPGs.

A copy of ``deepdfa_tpu/cpg/features.py`` without pandas: stage 1 returns
a list of row dicts and stage 2 groups them in plain Python, in the JAX
package's row order and with its JSON hash strings byte for byte (rows
sorted by ``(graph_id, node_id)``, each hash's subkeys sorted, each value
list sorted).

Stage 1+2 of the reference's feature pipeline
(``DDFA/sastvd/scripts/abstract_dataflow_full.py``): for every *definition*
node (a CALL whose name is an assignment/inc-dec operator,
``abstract_dataflow_full.py:44-51``) collect four families of "subkeys"
describing the definition abstractly:

- ``datatype`` — the declared type of the assigned variable, resolved by
  recursing through access/cast operators to the underlying IDENTIFIER
  (``abstract_dataflow_full.py:67-125``), then normalised
  (``:240-250``: array extents dropped, leading ``const`` dropped,
  whitespace collapsed);
- ``literal`` / ``operator`` / ``api`` — the codes/names of LITERAL and CALL
  nodes in the definition's AST subtree (METHOD subtrees excluded,
  ``:127-167``); ``<operator>.X`` calls contribute ``X`` as an operator
  (``indirection`` excluded), every other call name is an ``api``.

Stage 2 groups subkeys per definition into a canonical JSON "hash"
(``:285-295``). Known deliberate deviation: the reference's operator regex
only matches the ``<operator>.`` spelling, so ``<operators>.``-spelled
operators (a Joern quirk) leak into the ``api`` family; we treat both
spellings as operators.

Also here: the dependence-edge pass (:func:`add_dependence_edges`) and the
static-analysis families (:func:`dataflow_node_features`), and the
line-level dependency labeling the statement labels build on
(:func:`line_dependencies`, :func:`dep_add_lines`).
"""

from __future__ import annotations

import json
import re
from typing import Iterable

from deepdfa_tpu_torch.cpg.dataflow import ASSIGNMENT_OPS, INC_DEC_OPS
from deepdfa_tpu_torch.cpg.schema import CPG

__all__ = [
    "DEF_OPS",
    "is_def",
    "clean_datatype",
    "definition_subkeys",
    "extract_features",
    "features_to_hashes",
    "add_dependence_edges",
    "dataflow_node_features",
    "FEATURE_COLUMNS",
    "SOLVER_BACKENDS",
]

# stage 1's row keys, in the JAX package's column order
FEATURE_COLUMNS = ("graph_id", "node_id", "subkey", "subkey_node_id",
                   "subkey_text")
# the solvers the dependence-edge pass and the static-analysis families can
# run on; "native" (the default) falls back to "bitvec" on a host without a
# C++ compiler, as the JAX package does
SOLVER_BACKENDS = ("native", "bitvec", "sets")

# Definition detection for *feature extraction*: the reference's
# all_assignment_types (abstract_dataflow_full.py:24-42) — the 13 assignment
# ops + 4 inc/dec ops (no incBy), in both operator spellings.
_DEF_BASE = tuple(op for op in ASSIGNMENT_OPS) + tuple(
    op for op in INC_DEC_OPS if not op.endswith("incBy")
)
DEF_OPS = frozenset(
    _DEF_BASE + tuple(op.replace("<operator>", "<operators>") for op in _DEF_BASE)
)

# Operators whose argument at the given order carries the underlying variable
# when resolving a datatype (abstract_dataflow_full.py:72-84).
_RECURSE_ARG_ORDER = {
    "indirectIndexAccess": 1,
    "indirectFieldAccess": 1,
    "indirection": 1,
    "fieldAccess": 1,
    "postIncrement": 1,
    "postDecrement": 1,
    "preIncrement": 1,
    "preDecrement": 1,
    "addressOf": 1,
    "cast": 2,
    "addition": 1,
}


def _op_name(name: str) -> str | None:
    """``<operator>.X``/``<operators>.X`` → ``X``; None for plain calls."""
    m = re.match(r"<operators?>\.(.*)", name)
    return m.group(1) if m else None


def is_def(cpg: CPG, nid: int) -> bool:
    node = cpg.nodes.get(nid)
    return node is not None and node.label == "CALL" and node.name in DEF_OPS


def clean_datatype(dt: str) -> str:
    """Normalise a type string (``abstract_dataflow_full.py:240-250``)."""
    dt = re.sub(r"\s*\[.*\]", "[]", dt)
    dt = re.sub(r"^const ", "", dt)
    return re.sub(r"\s+", " ", dt).strip()


def _recurse_datatype(cpg: CPG, v: int) -> tuple[int, str]:
    attr = cpg.nodes[v]
    if attr.label == "IDENTIFIER":
        return v, attr.type_full_name
    if attr.label == "CALL":
        op = _op_name(attr.name)
        if op in _RECURSE_ARG_ORDER:
            args = cpg.arguments(v)
            arg = args.get(_RECURSE_ARG_ORDER[op])
            if arg is None:
                raise LookupError(f"no arg {_RECURSE_ARG_ORDER[op]} on {v}")
            arg_attr = cpg.nodes[arg]
            if arg_attr.label == "IDENTIFIER":
                return arg, arg_attr.type_full_name
            if arg_attr.label == "CALL":
                return _recurse_datatype(cpg, arg)
            raise LookupError(f"unhandled arg {arg} ({arg_attr.label})")
    raise LookupError(f"unhandled node {v} ({attr.label} {attr.name})")


def _raw_datatype(cpg: CPG, decl: int) -> tuple[int, str]:
    """(node, raw type) of the variable defined at ``decl``
    (``abstract_dataflow_full.py:109-125``)."""
    attr = cpg.nodes[decl]
    if attr.label == "LOCAL":
        return decl, attr.type_full_name
    cast_ops = DEF_OPS | {"<operator>.cast", "<operators>.cast"}
    if attr.label == "CALL" and attr.name in cast_ops:
        args = cpg.arguments(decl)
        if 1 not in args:
            raise LookupError(f"no first arg on {decl}")
        return _recurse_datatype(cpg, args[1])
    raise LookupError(f"unhandled decl {decl} ({attr.label})")


def definition_subkeys(cpg: CPG, nid: int, raise_all: bool = False) -> list[tuple[str, int, str]]:
    """Subkey fields ``(subkey, subkey_node, text)`` for one definition node
    (``abstract_dataflow_full.py:127-167``)."""
    fields: list[tuple[str, int, str]] = []
    try:
        try:
            child, dt = _raw_datatype(cpg, nid)
            fields.append(("datatype", child, clean_datatype(dt)))
        except LookupError:
            if raise_all:
                raise
        for n in cpg.ast_descendants(nid, skip_labels=frozenset({"METHOD"})):
            attr = cpg.nodes.get(n)
            if attr is None:
                continue
            if attr.label == "LITERAL":
                fields.append(("literal", n, attr.code))
            elif attr.label == "CALL":
                op = _op_name(attr.name)
                if op is not None:
                    if op != "indirection":
                        fields.append(("operator", n, op))
                else:
                    fields.append(("api", n, attr.name))
    except Exception:
        if raise_all:
            raise
    return fields


def extract_features(
    cpg: CPG, graph_id: int, raise_all: bool = False
) -> list[dict]:
    """Stage 1 for one graph: rows
    ``(graph_id, node_id, subkey, subkey_node_id, subkey_text)``, one dict
    each (keys :data:`FEATURE_COLUMNS`), in node order."""
    rows = []
    for nid in cpg.nodes:
        if not is_def(cpg, nid):
            continue
        for subkey, sk_node, text in definition_subkeys(cpg, nid, raise_all=raise_all):
            rows.append(
                dict(
                    graph_id=graph_id,
                    node_id=nid,
                    subkey=subkey,
                    subkey_node_id=sk_node,
                    subkey_text=text,
                )
            )
    return rows


def features_to_hashes(feature_rows: Iterable[dict], subkeys: Iterable[str]) -> list[dict]:
    """Stage 2: group per definition into a canonical JSON hash
    ``{"api": [...], "datatype": [...], ...}`` with sorted value lists
    (``abstract_dataflow_full.py:285-334``). Returns rows
    ``{"graph_id", "node_id", "hash"}`` sorted by ``(graph_id, node_id)``,
    the JAX package's DataFrame row for row."""
    subkeys = sorted(subkeys)
    groups: dict[tuple, list[dict]] = {}
    for r in feature_rows:
        groups.setdefault((r["graph_id"], r["node_id"]), []).append(r)
    out = []
    for gid, nid in sorted(groups):
        group = groups[(gid, nid)]
        out.append({
            "graph_id": gid,
            "node_id": nid,
            "hash": json.dumps({
                sk: sorted(str(r["subkey_text"]) for r in group
                           if r["subkey"] == sk)
                for sk in subkeys
            }),
        })
    return out


def _solver(backend: str):
    from deepdfa_tpu_torch.cpg import analyses

    if backend not in SOLVER_BACKENDS:
        raise ValueError(f"backend must be one of {SOLVER_BACKENDS}, "
                         f"got {backend!r}")
    return {"native": analyses.solve_native, "bitvec": analyses.solve_bitvec,
            "sets": analyses.solve_sets}[backend]


def dataflow_node_features(cpg: CPG, backend: str = "native") -> dict[str, dict[int, int]]:
    """Per-CFG-node raw values for the static-analysis feature families
    (the JAX package's ``config.DFA_FAMILIES``), solved with ``backend``
    (by default the native solver, which falls back to the bit-vector one
    on compiler-less hosts):

    - ``live_out`` — |live_out(n)| clipped to ``DFA_LIVE_OUT_CLIP``;
    - ``uninit`` — 1 iff ``n`` reads a possibly-uninitialized local;
    - ``taint`` — 0 untouched / 1 uses a tainted variable / 2 introduces
      taint (source call, tainted assignment, parameter entry).

    Nodes outside the CFG are absent; carriers default them to 0.
    """
    from deepdfa_tpu_torch.config import DFA_LIVE_OUT_CLIP
    from deepdfa_tpu_torch.cpg import analyses

    solve = _solver(backend)
    live = solve(analyses.liveness(cpg))
    live_out = {n: min(len(s), DFA_LIVE_OUT_CLIP) for n, s in live.out_facts.items()}
    uninit_sol = solve(analyses.uninitialized(cpg))
    flagged = analyses.uninitialized_uses(cpg, uninit_sol)
    uninit = {n: int(n in flagged) for n in uninit_sol.in_facts}
    taint = analyses.taint_node_codes(cpg, solver=solve)
    return {"live_out": live_out, "uninit": uninit, "taint": taint}



# ---------------------------------------------------------------------------
# line-level dependency labeling


def line_dependencies(cpg: CPG) -> dict[int, set[int]]:
    """Undirected line-level data+control dependency map: REACHING_DEF and
    CDG edges projected onto line numbers, symmetrised, self-loops dropped
    (the reference's per-line ``data``/``control`` context,
    ``helpers/evaluate.py:124-171``, merged into one set per line)."""
    line_of = {i: n.line for i, n in cpg.nodes.items() if n.line is not None}
    deps: dict[int, set[int]] = {}
    for s, d, e in cpg.edges:
        if e not in ("REACHING_DEF", "CDG"):
            continue
        ls, ld = line_of.get(s), line_of.get(d)
        if ls is None or ld is None or ls == ld:
            continue
        deps.setdefault(ls, set()).add(ld)
        deps.setdefault(ld, set()).add(ls)
    return deps


def dep_add_lines(
    before_cpg: CPG, after_cpg: CPG, added_lines: Iterable[int]
) -> list[int]:
    """Lines of the *before* function that are data/control-dependent on
    patch-added lines (computed in the *after* graph)
    (``helpers/evaluate.py:194-218``)."""
    added = set(added_lines)
    deps = line_dependencies(after_cpg)
    dependent: set[int] = set()
    for line in added:
        dependent |= deps.get(line, set())
    before_lines = {n.line for n in before_cpg.nodes.values() if n.line is not None}
    return sorted(dependent & before_lines)

def add_dependence_edges(cpg: CPG, backend: str = "native") -> CPG:
    """Augment a CPG with REACHING_DEF (data) and CDG (control) edges.

    The reference gets both from Joern's engine (``run.ossdataflow``,
    ``get_func_graph.sc:31``); for natively-extracted CPGs we derive them:

    - REACHING_DEF: for each definition ``d`` of variable ``v`` reaching node
      ``n`` (our worklist solver's IN set), an edge ``d → n`` iff ``n``'s
      statement mentions ``v`` (an IDENTIFIER AST-descendant named ``v``, or
      ``n`` itself being that identifier's statement);
    - CDG: control dependence via post-dominance — CFG node ``m`` is
      control-dependent on branch node ``b`` iff ``b`` has a successor path
      to exit avoiding ``m``'s post-dominators but ``m`` post-dominates some
      successor of ``b`` (standard Ferrante-Ottenstein-Warren construction
      on the reverse CFG).

    ``backend`` picks the reaching-definitions solver (one of
    :data:`SOLVER_BACKENDS`); all three reach the same fixpoint, so the
    edge SET does not depend on it.

    Returns a new CPG sharing node objects; existing edges are preserved.
    """
    from deepdfa_tpu_torch.cpg.dataflow import (ReachingDefinitions, _as_ids,
                                                solve_bitvec, solve_native)

    _solver(backend)  # validates the name
    rd = ReachingDefinitions(cpg)
    # They return def-node ids — map back to VariableDefinitions for the
    # var-name matching below.
    if backend == "native":
        # the throughput path: C++ worklist, falling back to the numpy
        # bit-matrix solver where the library cannot build
        try:
            in_ids, out_ids = solve_native(rd)
        except Exception:  # noqa: BLE001 — compiler-less hosts
            in_ids, out_ids = solve_bitvec(rd)
    elif backend == "bitvec":
        in_ids, out_ids = solve_bitvec(rd)
    else:
        in_sets, out_sets = rd.solve()
        in_ids, out_ids = _as_ids(in_sets), _as_ids(out_sets)
    def_by_node = {d.node: d for defs in rd.gen.values() for d in defs}
    in_sets = {n: {def_by_node[i] for i in s} for n, s in in_ids.items()}
    out_sets = {n: {def_by_node[i] for i in s} for n, s in out_ids.items()}
    new_edges: list[tuple[int, int, str]] = list(cpg.edges)

    # --- data dependence. Definitions are matched *textually* (the solver's
    # var is the lvalue's source text, dataflow.py:109-123), so uses must
    # include compound expressions too: "*p", "a[i]", "s->f" are CALL nodes,
    # not bare IDENTIFIERs.
    def mentioned_vars(n: int) -> set[str]:
        out = set()
        for d in [n, *cpg.ast_descendants(n)]:
            nd = cpg.nodes.get(d)
            if nd is not None and nd.label in ("IDENTIFIER", "CALL"):
                out.add(nd.code)
        return out

    for n, defs in in_sets.items():
        uses = mentioned_vars(n)
        if not uses:
            continue
        for d in defs:
            if d.var in uses and d.node != n:
                new_edges.append((d.node, n, "REACHING_DEF"))

    # --- control dependence (post-dominator frontier on the CFG)
    cfg_nodes = sorted(cpg.edge_nodes("CFG"))
    if cfg_nodes:
        succs = {n: list(cpg.successors(n, "CFG")) for n in cfg_nodes}
        preds = {n: list(cpg.predecessors(n, "CFG")) for n in cfg_nodes}
        exits = [n for n in cfg_nodes if not succs[n]]
        # virtual exit -1 joins all sinks so post-dominance is well-defined
        VEXIT = -1
        for n in exits:
            succs[n] = [VEXIT]
        preds[VEXIT] = list(exits)
        succs[VEXIT] = []
        allnodes = cfg_nodes + [VEXIT]
        # iterative post-dominator sets (reverse-CFG dominators)
        full = set(allnodes)
        pdom = {n: ({n} if n == VEXIT else set(full)) for n in allnodes}
        changed = True
        while changed:
            changed = False
            for n in allnodes:
                if n == VEXIT:
                    continue
                ss = succs[n]
                inter = set.intersection(*(pdom[s] for s in ss)) if ss else set()
                new = {n} | inter
                if new != pdom[n]:
                    pdom[n] = new
                    changed = True
        # Ferrante-Ottenstein-Warren: for each branch edge (b, s), every node
        # on the post-dominator chain of s up to (but excluding) b's strict
        # post-dominators is control-dependent on b.
        for b in cfg_nodes:
            if len(succs[b]) < 2:
                continue
            strict_pdom_b = pdom[b] - {b}
            for s in succs[b]:
                if s == VEXIT:
                    continue
                for m in pdom[s] - strict_pdom_b:
                    if m != VEXIT:
                        new_edges.append((b, m, "CDG"))

    seen = set()
    deduped = []
    for e in new_edges:
        if e not in seen:
            seen.add(e)
            deduped.append(e)
    out = CPG(list(cpg.nodes.values()), deduped)
    # cache the fixpoint so downstream label materialisation
    # (graph_from_cpg(dataflow_labels=True)) doesn't re-solve the same CPG
    out.rd_solution = (in_sets, out_sets)
    return out
