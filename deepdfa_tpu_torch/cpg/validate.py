"""CPG structural validator.

A copy of ``deepdfa_tpu/cpg/validate.py``: the same checks, messages and
summary. The extraction/feature pipeline silently assumes a handful of invariants
about the graphs the frontend (or a Joern export) hands it. A malformed
graph does not crash downstream — it quietly corrupts features (a dangling
CFG edge truncates fixpoints, a duplicate ARGUMENT order makes
``assigned_variable`` nondeterministic). :func:`validate_cpg` checks the
invariants explicitly and returns structured :class:`Diagnostic` records:

- ``dangling-edge`` (error) — an edge endpoint that is not a node;
- ``method-root`` (error) — a CFG weakly-connected component with zero or
  multiple METHOD nodes (multi-function CPGs from ``parse_source`` are one
  component per function, so the check is per-component, not global);
- ``unreachable-return`` (error) — a METHOD_RETURN not reachable from its
  METHOD along CFG edges (the fixpoint never sees the exit state);
- ``argument-order-duplicate`` (error) — two ARGUMENT children of one call
  with the same ``order`` (``CPG.arguments`` would silently drop one);
- ``argument-order-sparse`` (warning) — ARGUMENT orders not dense 1..k;
- ``unknown-operator`` (error) — a ``<operator>.X`` call name outside the
  vocabulary the frontend/Joern operator model can emit (definitely a
  corrupt or foreign graph; the dataflow suite would treat it as an
  opaque call);
- ``no-method`` (error) — a CPG with no METHOD node at all.

The call-graph contract (the interprocedural layer,
:mod:`deepdfa_tpu_torch.cpg.interproc`): supergraph construction is total — a
malformed callee reference degrades to a summarized external, never a
KeyError — and THESE checks are where the degradation surfaces as
quarantine-compatible rows:

- ``call-ref-malformed`` (error) — a CALL carrying ARGUMENT children but
  an empty callee name: neither resolvable to a METHOD nor summarizable
  by name;
- ``call-ref-ambiguous`` (warning) — two METHODs share one name, so call
  resolution (lowest METHOD id) is arbitrary;
- ``call-arity`` (warning) — a resolved call whose ARGUMENT count differs
  from the callee's METHOD_PARAMETER_IN count (the supergraph binds the
  common prefix and leaves the rest unconstrained);
- ``call-no-return`` (warning) — a resolved callee METHOD without a
  METHOD_RETURN child (the supergraph links parameters but cannot route
  the return value).

``severity`` is ``"error"`` for invariants whose violation corrupts
features (ingestion drops the graph) and ``"warning"`` for oddities worth
surfacing but survivable. :func:`validate_corpus` aggregates per-dataset
counts for the ingestion summary.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Iterable, Mapping

from deepdfa_tpu_torch.cpg.analyses import ASSIGNMENT_OPS, INC_DEC_OPS
from deepdfa_tpu_torch.cpg.schema import CPG

__all__ = ["Diagnostic", "KNOWN_OPERATOR_NAMES", "validate_cpg", "validate_corpus"]


def _known_operators() -> frozenset[str]:
    from deepdfa_tpu_torch.cpg.frontend import ASSIGN_OPS, BINARY_OPS, UNARY_OPS

    names = set(BINARY_OPS.values()) | set(ASSIGN_OPS.values()) | set(UNARY_OPS.values())
    names |= {
        "indexAccess", "indirectIndexAccess", "fieldAccess",
        "indirectFieldAccess", "cast", "conditional", "sizeOf",
    }
    # Joern-only spellings the frontend never emits but real exports contain
    names |= {op.split(".", 1)[1] for op in ASSIGNMENT_OPS + INC_DEC_OPS}
    return frozenset(f"{pre}.{n}" for pre in ("<operator>", "<operators>") for n in names)


KNOWN_OPERATOR_NAMES = _known_operators()


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    check: str
    severity: str  # "error" | "warning"
    message: str
    node: int | None = None
    edge: tuple[int, int, str] | None = None

    def __str__(self):
        where = f" node={self.node}" if self.node is not None else ""
        where += f" edge={self.edge}" if self.edge is not None else ""
        return f"[{self.severity}] {self.check}:{where} {self.message}"


def _cfg_components(cpg: CPG) -> list[set[int]]:
    """Weakly-connected components of the CFG subgraph."""
    adj: dict[int, set[int]] = defaultdict(set)
    nodes: set[int] = set()
    for s, d, e in cpg.edges:
        if e != "CFG" or s not in cpg.nodes or d not in cpg.nodes:
            continue
        adj[s].add(d)
        adj[d].add(s)
        nodes |= {s, d}
    seen: set[int] = set()
    comps: list[set[int]] = []
    for n in nodes:
        if n in seen:
            continue
        comp: set[int] = set()
        stack = [n]
        while stack:
            x = stack.pop()
            if x in comp:
                continue
            comp.add(x)
            stack.extend(adj[x] - comp)
        seen |= comp
        comps.append(comp)
    return comps


def _cfg_reachable(cpg: CPG, start: int) -> set[int]:
    seen: set[int] = set()
    stack = [start]
    while stack:
        n = stack.pop()
        if n in seen:
            continue
        seen.add(n)
        stack.extend(s for s in cpg.successors(n, "CFG") if s not in seen)
    return seen


def validate_cpg(cpg: CPG) -> list[Diagnostic]:
    """All structural diagnostics for one CPG, errors first."""
    diags: list[Diagnostic] = []

    # -- dangling edge endpoints (any edge type)
    for s, d, e in cpg.edges:
        missing = [x for x in (s, d) if x not in cpg.nodes]
        if missing:
            diags.append(Diagnostic(
                "dangling-edge", "error",
                f"{e} edge references missing node(s) {missing}",
                edge=(s, d, e),
            ))

    methods = [n for n in cpg.nodes.values() if n.label == "METHOD"]
    if not methods:
        diags.append(Diagnostic("no-method", "error", "CPG has no METHOD node"))

    # -- exactly one METHOD root per CFG component (parse_source merges
    #    functions as disjoint components, so the check is local)
    for comp in _cfg_components(cpg):
        roots = [n for n in comp if cpg.nodes[n].label == "METHOD"]
        if len(roots) != 1:
            sample = sorted(comp)[:3]
            diags.append(Diagnostic(
                "method-root", "error",
                f"CFG component containing nodes {sample} has "
                f"{len(roots)} METHOD roots (want exactly 1)",
                node=roots[0] if roots else None,
            ))

    # -- every METHOD_RETURN reachable from its method's entry via CFG
    for m in methods:
        returns = [
            d for d in cpg.ast_descendants(m.id)
            if d in cpg.nodes and cpg.nodes[d].label == "METHOD_RETURN"
        ]
        reach = _cfg_reachable(cpg, m.id)
        for r in returns:
            if r not in reach:
                diags.append(Diagnostic(
                    "unreachable-return", "error",
                    f"METHOD_RETURN {r} of method {m.name!r} is not CFG-"
                    f"reachable from METHOD {m.id}",
                    node=r,
                ))

    # -- ARGUMENT orders: duplicates are data loss, sparseness is suspect
    arg_children: dict[int, list[int]] = defaultdict(list)
    for s, d, e in cpg.edges:
        if e == "ARGUMENT" and s in cpg.nodes and d in cpg.nodes:
            arg_children[s].append(d)
    for call, children in arg_children.items():
        orders = sorted(cpg.nodes[c].order for c in children)
        if len(set(orders)) != len(orders):
            dup = next(o for o in orders if orders.count(o) > 1)
            diags.append(Diagnostic(
                "argument-order-duplicate", "error",
                f"call {call} ({cpg.nodes[call].code!r}) has multiple "
                f"ARGUMENT children with order={dup}",
                node=call,
            ))
        elif orders != list(range(1, len(orders) + 1)):
            diags.append(Diagnostic(
                "argument-order-sparse", "warning",
                f"call {call} ({cpg.nodes[call].code!r}) has non-dense "
                f"ARGUMENT orders {orders} (want 1..{len(orders)})",
                node=call,
            ))

    # -- operator-call names must be in the known vocabulary
    for n in cpg.nodes.values():
        if n.label == "CALL" and n.name.startswith("<operator") \
                and n.name not in KNOWN_OPERATOR_NAMES:
            diags.append(Diagnostic(
                "unknown-operator", "error",
                f"call {n.id} has unknown operator name {n.name!r}",
                node=n.id,
            ))

    diags.extend(_call_ref_diagnostics(cpg))

    diags.sort(key=lambda d: (d.severity != "error", d.check))
    return diags


def _call_ref_diagnostics(cpg: CPG) -> list[Diagnostic]:
    """The call-graph contract: every shape supergraph construction
    degrades on becomes a diagnostic row here (same resolution rules as
    ``cpg.callgraph.build_callgraph`` — by METHOD name, lowest id wins)."""
    from deepdfa_tpu_torch.cpg.callgraph import build_callgraph

    diags: list[Diagnostic] = []
    cg = build_callgraph(cpg)
    for name in cg.ambiguous:
        diags.append(Diagnostic(
            "call-ref-ambiguous", "warning",
            f"method name {name!r} is defined by multiple METHOD nodes — "
            "call resolution picks the lowest id; rename or split the CPG",
            node=cg.methods.get(name),
        ))
    warned_no_return: set[int] = set()
    for site in cg.sites:
        call = cpg.nodes.get(site.call)
        if call is None:
            continue
        if not site.name and cpg.arguments(site.call):
            diags.append(Diagnostic(
                "call-ref-malformed", "error",
                f"call {site.call} has ARGUMENT children but an empty "
                "callee name — not resolvable, not summarizable",
                node=site.call,
            ))
            continue
        if site.callee is None:
            continue  # summarized external: by design, not a diagnostic
        callee = cpg.nodes.get(site.callee)
        n_params = sum(
            1 for d in cpg.successors(site.callee, "AST")
            if d in cpg.nodes and cpg.nodes[d].label == "METHOD_PARAMETER_IN"
        )
        n_args = len(cpg.arguments(site.call))
        if n_args != n_params:
            diags.append(Diagnostic(
                "call-arity", "warning",
                f"call {site.call} passes {n_args} argument(s) but method "
                f"{callee.name!r} declares {n_params} parameter(s) — the "
                "supergraph binds only the common prefix",
                node=site.call,
            ))
        has_return = any(
            d in cpg.nodes and cpg.nodes[d].label == "METHOD_RETURN"
            for d in cpg.successors(site.callee, "AST")
        )
        if not has_return and site.callee not in warned_no_return:
            warned_no_return.add(site.callee)
            diags.append(Diagnostic(
                "call-no-return", "warning",
                f"resolved callee METHOD {site.callee} ({callee.name!r}) "
                "has no METHOD_RETURN child — the supergraph cannot route "
                "its return value",
                node=site.callee,
            ))
    return diags


def validate_corpus(cpgs: Iterable[tuple[object, CPG]]) -> Mapping[str, object]:
    """Validate many graphs; returns the per-dataset summary ingestion
    reports: totals, per-check counts, and the ids of graphs with errors
    (the ones ingestion should drop)."""
    by_check: dict[str, int] = defaultdict(int)
    bad_ids: list[object] = []
    n_graphs = n_warn = 0
    for gid, cpg in cpgs:
        n_graphs += 1
        diags = validate_cpg(cpg)
        has_error = False
        for d in diags:
            by_check[d.check] += 1
            if d.severity == "error":
                has_error = True
            else:
                n_warn += 1
        if has_error:
            bad_ids.append(gid)
    return {
        "graphs": n_graphs,
        "graphs_with_errors": len(bad_ids),
        "warnings": n_warn,
        "by_check": dict(sorted(by_check.items())),
        "error_graph_ids": bad_ids,
    }
