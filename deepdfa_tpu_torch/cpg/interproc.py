"""Interprocedural dataflow: the call-graph supergraph over the gen-kill
framework.

A copy of ``deepdfa_tpu/cpg/interproc.py``. The per-function analyses
(:mod:`deepdfa_tpu_torch.cpg.analyses`) are strictly
per-function — a vulnerability whose source and sink live in different
functions is structurally invisible to them. This module composes those
same analyses over the call graph, host-side, context-insensitively:

**Supergraph** (:func:`build_supergraph`): a NEW derived :class:`CPG`
(fresh object — per-CPG adjacency caches are never mutated) containing
every original node/edge plus, per resolved call site ``c`` in caller ``f``
to callee ``g``:

- one *parameter-binding* node per callee parameter — a synthetic
  ``<operator>.assignment`` whose lvalue IDENTIFIER is the parameter name
  and whose rvalue IDENTIFIERs are the argument expression's mentions;
  bindings chain ``c → b₁ → … → bₖ → METHOD(g)`` in CFG, so the call edge
  carries facts into the callee through ordinary gen/kill transfer
  (strong kill of the parameter + conditional gen from the argument);
- one *return-binding* node ``r`` with ``METHOD_RETURN(g) → r → succ(c)``
  CFG edges — a pure routing node (no gen/kill) that links the callee's
  exit state back to the call-site result position.

Unresolved externals (library calls, function pointers, malformed names)
contribute nothing — the summarized no-op of :mod:`.callgraph`. The
original intraprocedural CFG edges are all retained, so every analysis here
is a *may* over-approximation that strictly extends the per-function
solution.

**Interprocedural reaching definitions**: :func:`reaching_definitions` run
directly on the supergraph — binding nodes are textually real assignments,
so callee parameters acquire definitions owned by the call site. The
``ireach`` feature family counts, per node, the reaching definitions owned
by a *different* method.

**Interprocedural taint** (:func:`solve_interproc_taint`): facts are
qualified ``"method::var"`` strings so same-named locals in different
functions never conflate. The static instance is the per-function
:func:`~deepdfa_tpu_torch.cpg.analyses._taint_static` qualified node-wise by
owner method, plus the call/return transfer: parameter bindings gen the
callee-qualified parameter from caller-qualified argument mentions; RETURN
nodes of called methods gen a ``"g::<ret>"`` fact from their expression
mentions; call-site assignment statements list ``"g::<ret>"`` among their
RHS mentions, closing the loop through the return edge. Parameter seeding
is restricted to *root* methods (no resolved incoming call edge) — with
zero call edges every method is a root, so the projected solution is
bit-equal to the intraprocedural :func:`solve_taint` fixpoint on every
backend.

**Cross-function findings** (:func:`cross_function_taint`): a node is a
cross-function taint use iff it is tainted under source-API-only
interprocedural taint (no parameter seeds at all) but NOT under the same
analysis confined to its own function — per-function scoring cannot see it
by construction. Attribution walks the call graph back to the
source-API-carrying methods.

All solving goes through the existing ``sets``/``bitvec``/``native``
backends untouched; nothing here runs on an accelerator. GGNN inputs stay
per-function buckets — the ``_DFA_ireach``/``_DFA_itaint`` families
(:func:`interproc_node_features`) annotate nodes, they do not grow graphs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

from deepdfa_tpu_torch.cpg import analyses
from deepdfa_tpu_torch.cpg.analyses import (
    DEFAULT_TAINT_SOURCES,
    Problem,
    Solution,
    _subtree,
    _taint_static,
    reaching_definitions,
    solve_bitvec,
)
from deepdfa_tpu_torch.cpg.callgraph import CallGraph, CallSite, build_callgraph, method_owner_map
from deepdfa_tpu_torch.cpg.schema import CPG, Node

__all__ = [
    "RET_FACT",
    "IPROC_ANALYSES",
    "Supergraph",
    "merge_cpgs",
    "build_supergraph",
    "interproc_reaching_definitions",
    "solve_interproc_taint",
    "project_taint",
    "interproc_taint_node_codes",
    "cross_function_taint",
    "interproc_node_features",
    "solve_interproc_analysis",
]

RET_FACT = "<ret>"
BIND_OP = "<operator>.assignment"  # bindings are textually real assignments
RETURN_BIND_OP = "<interproc>.returnBind"  # routing only: no gen, no kill

IPROC_ANALYSES = ("reaching_defs", "taint")


# ------------------------------------------------------------------ merging


def merge_cpgs(cpgs: Sequence[CPG]) -> tuple[CPG, list[dict[int, int]]]:
    """Merge independently-parsed CPGs (overlapping id spaces) into one CPG
    with disjoint ids. Returns the merged graph plus one old→new id map per
    input. Dangling edges (an endpoint missing from the node table) are
    dropped, never KeyError."""
    nodes: list[Node] = []
    edges: list[tuple[int, int, str]] = []
    maps: list[dict[int, int]] = []
    next_base = 0
    for cpg in cpgs:
        ids = sorted(cpg.nodes)
        lo = ids[0] if ids else 0
        idmap = {old: next_base + (old - lo) for old in ids}
        maps.append(idmap)
        for old in ids:
            nodes.append(dataclasses.replace(cpg.nodes[old], id=idmap[old]))
        for s, d, e in cpg.edges:
            ns, nd = idmap.get(s), idmap.get(d)
            if ns is not None and nd is not None:
                edges.append((ns, nd, e))
        if ids:
            next_base += (ids[-1] - lo) + 1000
    return CPG(nodes, edges), maps


# --------------------------------------------------------------- supergraph


@dataclasses.dataclass
class Supergraph:
    """The derived interprocedural CPG plus the bookkeeping the analyses
    need. ``owner`` maps EVERY node (bindings included) to a METHOD id;
    binding nodes belong to their *caller* — the value they carry is caller
    state entering the callee, which is exactly what ``ireach`` counts as
    foreign."""

    base: CPG
    cpg: CPG
    callgraph: CallGraph
    owner: dict[int, int]
    method_names: dict[int, str]
    # bind node id -> (call id, caller METHOD id, callee METHOD id)
    param_binds: dict[int, tuple[int, int, int]]
    return_binds: dict[int, tuple[int, int, int]]
    linked_sites: list[CallSite]

    @property
    def n_call_edges(self) -> int:
        return len(self.linked_sites)

    def owner_name(self, nid: int) -> str:
        mid = self.owner.get(nid)
        return self.method_names.get(mid, "") if mid is not None else ""


def _method_params(cpg: CPG, mid: int) -> list[Node]:
    params = [
        cpg.nodes[d]
        for d in cpg.successors(mid, "AST")
        if d in cpg.nodes and cpg.nodes[d].label == "METHOD_PARAMETER_IN"
    ]
    return sorted(params, key=lambda p: p.order)


def _method_return(cpg: CPG, mid: int) -> int | None:
    for d in cpg.successors(mid, "AST"):
        if d in cpg.nodes and cpg.nodes[d].label == "METHOD_RETURN":
            return d
    return None


def _mention_codes(cpg: CPG, root: int) -> list[str]:
    """IDENTIFIER/CALL codes in ``root``'s subtree (root included) — the
    same textual mention convention as the taint propagation rule."""
    out = []
    for d in _subtree(cpg, root):
        nd = cpg.nodes.get(d)
        if nd is not None and nd.label in ("IDENTIFIER", "CALL") and nd.code:
            out.append(nd.code)
    return sorted(set(out))


def build_supergraph(cpg: CPG) -> Supergraph:
    """Construct the interprocedural supergraph. Total: malformed callee
    references, arity mismatches, missing METHOD_RETURNs and dangling call
    sites all degrade to weaker linking — never an exception."""
    owner = method_owner_map(cpg)
    cg = build_callgraph(cpg, owner)
    method_names = {
        n.id: n.name for n in cpg.nodes.values() if n.label == "METHOD"
    }

    nodes = list(cpg.nodes.values())
    edges = list(cpg.edges)
    next_id = (max(cpg.nodes) + 1000) if cpg.nodes else 1
    param_binds: dict[int, tuple[int, int, int]] = {}
    return_binds: dict[int, tuple[int, int, int]] = {}
    linked: list[CallSite] = []
    sg_owner = dict(owner)

    for site in cg.sites:
        if site.callee is None or site.caller is None:
            continue  # summarized external / unattributable: no-op edge
        c, f, g = site.call, site.caller, site.callee
        succs = list(cpg.successors(c, "CFG"))
        if not succs and not cpg.predecessors(c, "CFG"):
            continue  # dead-code call: not in the CFG, nothing to link
        args = cpg.arguments(c)
        params = _method_params(cpg, g)
        gname = method_names.get(g, "")

        prev = c
        for param in params:
            b = next_id
            next_id += 1
            nodes.append(Node(id=b, label="CALL", name=BIND_OP,
                              code=f"{param.name} := <arg {param.order} of {gname}>",
                              line=cpg.nodes[c].line))
            lv = next_id
            next_id += 1
            nodes.append(Node(id=lv, label="IDENTIFIER", name=param.name,
                              code=param.name, order=1))
            edges.append((b, lv, "AST"))
            edges.append((b, lv, "ARGUMENT"))
            arg = args.get(param.order)
            order = 2
            if arg is not None and arg in cpg.nodes:
                for code in _mention_codes(cpg, arg):
                    m = next_id
                    next_id += 1
                    nodes.append(Node(id=m, label="IDENTIFIER", name=code,
                                      code=code, order=order))
                    order += 1
                    edges.append((b, m, "AST"))
                    edges.append((b, m, "ARGUMENT"))
            edges.append((prev, b, "CFG"))
            param_binds[b] = (c, f, g)
            sg_owner[b] = f
            sg_owner[lv] = f
            prev = b
        edges.append((prev, g, "CFG"))  # enter the callee

        mret = _method_return(cpg, g)
        if mret is not None and succs:
            r = next_id
            next_id += 1
            nodes.append(Node(id=r, label="CALL", name=RETURN_BIND_OP,
                              code=f"{RET_FACT} of {gname}",
                              line=cpg.nodes[c].line))
            edges.append((mret, r, "CFG"))
            for s in succs:
                edges.append((r, s, "CFG"))
            return_binds[r] = (c, f, g)
            sg_owner[r] = f
        linked.append(site)

    super_cpg = CPG(nodes, edges)
    # IDENTIFIER children of bindings: owned by the caller like their parent
    for b in param_binds:
        for d in super_cpg.successors(b, "AST"):
            sg_owner.setdefault(d, param_binds[b][1])
    return Supergraph(base=cpg, cpg=super_cpg, callgraph=cg, owner=sg_owner,
                      method_names=method_names, param_binds=param_binds,
                      return_binds=return_binds, linked_sites=linked)


# ---------------------------------------------------- reaching definitions


def interproc_reaching_definitions(sg: Supergraph) -> Problem:
    """Forward-may reaching defs over the supergraph: the intraprocedural problem
    verbatim — parameter bindings are textually real assignments, so the
    call transfer needs no special casing. With zero call edges the
    supergraph IS the base CPG and the instance is bit-identical."""
    return reaching_definitions(sg.cpg)


# ------------------------------------------------------------------- taint


def _qual(method: str, fact: str) -> str:
    return f"{method}::{fact}"


def _qualify(method: str, facts) -> set[str]:
    return {_qual(method, f) for f in facts}


def _interproc_taint_static(sg: Supergraph, source_apis: frozenset[str],
                            seed_params: str):
    """The qualified interprocedural taint instance.

    Node-wise qualification of the per-function static instance (a pure
    fact rename, so per-node transfer is EXACTLY the intraprocedural semantics), plus
    the call/return machinery described in the module docstring.
    ``seed_params``: "roots" (default analysis), "all" (degenerates to the
    per-function seeding) or "none" (source APIs only — the cross-function
    finding baseline)."""
    cpg = sg.cpg
    facts_u, gen_u, kill_u, dv_u, dr_u = _taint_static(cpg, source_apis)

    roots = sg.callgraph.root_methods()
    called = {s.callee for s in sg.linked_sites}

    facts: set[str] = set()
    base_gen: dict[int, set] = {}
    kill: dict[int, set] = {}
    def_var: dict[int, str] = {}
    def_rhs: dict[int, set[str]] = {}

    for n in gen_u:
        node = cpg.nodes.get(n)
        if n in sg.return_binds:
            base_gen[n], kill[n] = set(), set()
            continue
        if n in sg.param_binds:
            _, fmid, gmid = sg.param_binds[n]
            fname = sg.method_names.get(fmid, "")
            gname = sg.method_names.get(gmid, "")
            base_gen[n] = _qualify(gname, gen_u.get(n, ()))
            kill[n] = _qualify(gname, kill_u.get(n, ()))
            if n in dv_u:
                def_var[n] = _qual(gname, dv_u[n])
                def_rhs[n] = _qualify(fname, dr_u.get(n, ()))
            continue
        mname = sg.owner_name(n)
        gens = gen_u.get(n, set())
        if (node is not None and node.label == "METHOD"
                and seed_params != "all"):
            if seed_params == "none" or n not in roots:
                gens = set()  # params bound at call sites (or unseeded)
        base_gen[n] = _qualify(mname, gens)
        kill[n] = _qualify(mname, kill_u.get(n, ()))
        if n in dv_u:
            def_var[n] = _qual(mname, dv_u[n])
            def_rhs[n] = _qualify(mname, dr_u.get(n, ()))

    # RETURN nodes of called methods define "g::<ret>" from their expression
    # mentions; confined to call targets so a zero-call-edge supergraph adds
    # no machinery at all (the parity property).
    cfg_nodes = set(base_gen)
    for n in cfg_nodes:
        node = cpg.nodes.get(n)
        if node is None or node.label != "RETURN":
            continue
        mid = sg.owner.get(n)
        if mid not in called:
            continue
        gname = sg.method_names.get(mid, "")
        def_var.setdefault(n, _qual(gname, RET_FACT))
        mentions = set(_mention_codes(cpg, n))
        mentions.discard(node.code)
        def_rhs[n] = def_rhs.get(n, set()) | _qualify(gname, mentions)

    # call-site result: an assignment whose subtree holds a resolved call
    # reads "g::<ret>" (routed to it via the return-binding CFG edge)
    callee_of = {s.call: s.callee for s in sg.linked_sites}
    for n, var in list(dv_u.items()):
        if n in sg.param_binds or n not in cfg_nodes:
            continue
        for d in _subtree(cpg, n):
            g = callee_of.get(d)
            if g is not None:
                gname = sg.method_names.get(g, "")
                def_rhs.setdefault(n, set()).add(_qual(gname, RET_FACT))

    for s in base_gen.values():
        facts |= s
    for s in kill.values():
        facts |= s
    facts |= set(def_var.values())
    for s in def_rhs.values():
        facts |= s
    return tuple(sorted(facts)), base_gen, kill, def_var, def_rhs


def _outer_taint_solve(cpg: CPG, static, solver) -> Solution:
    """solve_taint's conditional-gen outer iteration over an explicit
    static instance (gens only grow ⇒ terminates; every backend reaches
    the same fixpoint)."""
    facts, base_gen, kill, def_var, def_rhs = static
    extra: dict[int, set] = {n: set() for n in base_gen}
    while True:
        gen = {n: base_gen[n] | extra[n] for n in base_gen}
        sol = solver(Problem(cpg, "forward", "may", facts, gen, kill,
                             name="interproc_taint"))
        changed = False
        for n, var in def_var.items():
            if var in gen.get(n, set()):
                continue
            if def_rhs.get(n, set()) & sol.in_facts.get(n, set()):
                extra.setdefault(n, set()).add(var)
                changed = True
        if not changed:
            return sol


def solve_interproc_taint(
    sg: Supergraph,
    source_apis: frozenset[str] = DEFAULT_TAINT_SOURCES,
    solver: Callable[[Problem], Solution] = solve_bitvec,
    seed_params: str = "roots",
) -> Solution:
    """Context-insensitive interprocedural taint over the supergraph.
    Facts are ``"method::var"`` qualified; :func:`project_taint` recovers
    the per-function view."""
    if seed_params not in ("roots", "all", "none"):
        raise ValueError(f"seed_params must be roots|all|none, got {seed_params!r}")
    static = _interproc_taint_static(sg, source_apis, seed_params)
    return _outer_taint_solve(sg.cpg, static, solver)


def project_taint(sg: Supergraph, sol: Solution) -> Solution:
    """Per-function view of a qualified solution: restrict to the base
    CPG's nodes, keep each node's own-method facts, strip the qualifier
    and the synthetic ``<ret>`` fact."""
    def proj(table: dict[int, set]) -> dict[int, set]:
        out: dict[int, set] = {}
        for n, fs in table.items():
            if n not in sg.base.nodes:
                continue
            prefix = sg.owner_name(n) + "::"
            out[n] = {
                f[len(prefix):] for f in fs
                if f.startswith(prefix) and f[len(prefix):] != RET_FACT
            }
        return out

    return Solution(proj(sol.in_facts), proj(sol.out_facts))


def _codes_from(sg: Supergraph, sol: Solution, kill: dict[int, set]) -> dict[int, int]:
    """taint_node_codes semantics over qualified facts, original nodes only:
    0 untouched / 1 uses / 2 introduces."""
    cpg = sg.cpg
    out: dict[int, int] = {}
    for n, in_facts in sol.in_facts.items():
        if n not in sg.base.nodes:
            continue
        gens = sol.out_facts.get(n, set()) - (in_facts - kill.get(n, set()))
        if gens:
            out[n] = 2
            continue
        mname = sg.owner_name(n)
        mentions = _qualify(mname, _mention_codes(cpg, n))
        out[n] = 1 if mentions & in_facts else 0
    return out


def interproc_taint_node_codes(
    sg: Supergraph,
    source_apis: frozenset[str] = DEFAULT_TAINT_SOURCES,
    solver: Callable[[Problem], Solution] = solve_bitvec,
    seed_params: str = "roots",
) -> dict[int, int]:
    """Per-node interprocedural taint code (0/1/2) over the base nodes."""
    static = _interproc_taint_static(sg, source_apis, seed_params)
    sol = _outer_taint_solve(sg.cpg, static, solver)
    return _codes_from(sg, sol, static[2])


def cross_function_taint(
    sg: Supergraph,
    source_apis: frozenset[str] = DEFAULT_TAINT_SOURCES,
    solver: Callable[[Problem], Solution] = solve_bitvec,
) -> dict:
    """Nodes tainted ONLY when taint may cross a call boundary.

    Baseline: source-API-only taint confined to each function (no
    parameter seeds, no call edges — what per-function scoring sees).
    Interprocedural: the same seeds propagated through the supergraph.
    Every node flagged here is structurally invisible per-function.

    Returns ``{"nodes": {nid: inter_code}, "findings": [row...],
    "attribution": {method: [source methods]}}``.
    """
    inter = interproc_taint_node_codes(sg, source_apis, solver,
                                       seed_params="none")

    intra_static = _taint_static(sg.base, source_apis)
    facts_u, gen_u, kill_u, dv_u, dr_u = intra_static
    stripped = {
        n: (set() if (sg.base.nodes.get(n) is not None
                      and sg.base.nodes[n].label == "METHOD") else s)
        for n, s in gen_u.items()
    }
    intra_sol = _outer_taint_solve(
        sg.base, (facts_u, stripped, kill_u, dv_u, dr_u), solver)
    intra_codes: dict[int, int] = {}
    for n, in_facts in intra_sol.in_facts.items():
        gens = intra_sol.out_facts.get(n, set()) - (in_facts - kill_u.get(n, set()))
        if gens:
            intra_codes[n] = 2
            continue
        mentions = set(_mention_codes(sg.base, n))
        intra_codes[n] = 1 if mentions & in_facts else 0

    cross = {n: c for n, c in inter.items()
             if c >= 1 and intra_codes.get(n, 0) == 0}

    # attribution: source-API-carrying methods connected to the finding's
    # method in the (undirected) call graph — taint travels caller→callee
    # through params and callee→caller through returns
    source_methods: set[int] = set()
    for n in sg.base.nodes.values():
        if n.label == "CALL" and n.name in source_apis:
            mid = sg.owner.get(n.id)
            if mid is not None:
                source_methods.add(mid)
    adj: dict[int, set[int]] = {}
    for a, b in sg.callgraph.edges:
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set()).add(a)

    def reachable(start: int) -> set[int]:
        seen = {start}
        stack = [start]
        while stack:
            for nxt in adj.get(stack.pop(), ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append(nxt)
        return seen

    attribution: dict[str, list[str]] = {}
    findings = []
    for nid in sorted(cross):
        node = sg.base.nodes[nid]
        mid = sg.owner.get(nid)
        mname = sg.method_names.get(mid, "") if mid is not None else ""
        carriers = sorted(
            sg.method_names.get(m, "")
            for m in (source_methods & reachable(mid) if mid is not None else set())
            if m != mid
        )
        if mname and carriers:
            attribution[mname] = sorted(
                set(attribution.get(mname, [])) | set(carriers))
        findings.append({
            "node": nid,
            "function": mname,
            "line": node.line,
            "code": node.code,
            "taint": cross[nid],
            "sources": carriers,
            "kind": "cross-function-taint",
        })
    return {"nodes": cross, "findings": findings, "attribution": attribution}


# ------------------------------------------------------------ feature view


def interproc_node_features(cpg: CPG, sg: Supergraph | None = None
                            ) -> dict[str, dict[int, int]]:
    """``{"ireach": {node: count}, "itaint": {node: code}}`` over the base
    CPG's nodes — the ``_DFA_ireach``/``_DFA_itaint`` feature families.

    ``ireach``: reaching definitions owned by a different method (call-site
    bindings count as the caller's), the raw interprocedural fan-in signal;
    clipped downstream by ``DFA_FEATURE_DIMS``. ``itaint``: the taint code
    (0/1/2) under root-seeded interprocedural taint, escalated to 3 on
    nodes only a cross-boundary flow can taint. On a single-function CPG
    (zero call edges) ireach is all-zero and itaint equals ``_DFA_taint``
    — the families strictly extend, never perturb, the per-function ones.

    ``sg``: an already-built supergraph of ``cpg`` — callers that hold one
    (the scan's interproc pass, the hierarchical scorer's summaries)
    pass it to skip the rebuild; semantics are identical.
    """
    from deepdfa_tpu_torch.cpg.analyses import solve_native

    if sg is None:
        sg = build_supergraph(cpg)
    rd_sol = solve_native(interproc_reaching_definitions(sg))
    ireach: dict[int, int] = {}
    for n, in_facts in rd_sol.in_facts.items():
        if n not in sg.base.nodes:
            continue
        mine = sg.owner.get(n)
        ireach[n] = sum(1 for d in in_facts if sg.owner.get(d.node) != mine)

    itaint = interproc_taint_node_codes(sg, solver=solve_native)
    if sg.linked_sites:
        for n in cross_function_taint(sg, solver=solve_native)["nodes"]:
            itaint[n] = 3
    return {"ireach": ireach, "itaint": itaint}


# ------------------------------------------------------------ uniform entry


def solve_interproc_analysis(name: str, cpg: CPG,
                             backend: str = "bitvec") -> Solution:
    """Uniform entry mirroring :func:`analyses.solve_analysis`: build the
    supergraph, solve interprocedurally, return the per-function projection
    (original nodes; taint facts unqualified) — directly comparable to the
    intraprocedural solution, and bit-equal to it when the CPG has zero
    call edges."""
    if name not in IPROC_ANALYSES:
        raise ValueError(f"unknown interprocedural analysis {name!r}; "
                         f"known: {IPROC_ANALYSES}")
    solver = analyses._BACKENDS[backend]
    sg = build_supergraph(cpg)
    if name == "reaching_defs":
        sol = solver(interproc_reaching_definitions(sg))
        keep = set(sg.base.nodes)
        return Solution(
            {n: s for n, s in sol.in_facts.items() if n in keep},
            {n: s for n, s in sol.out_facts.items() if n in keep},
        )
    sol = solve_interproc_taint(sg, solver=solver)
    return project_taint(sg, sol)
