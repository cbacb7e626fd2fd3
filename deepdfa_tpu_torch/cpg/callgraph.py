"""Call graph over the Joern-schema CPG — the interprocedural layer's index.

A copy of ``deepdfa_tpu/cpg/callgraph.py``.

The frontend (``cpg/frontend.py``) emits direct function calls as ``CALL``
nodes whose ``name`` is the callee expression's source text, and function
definitions as ``METHOD`` nodes whose ``name`` is the function name (the
native schema carries no ``methodFullName`` column, so name identity IS the
resolution key — same textual-identity convention as the variable model in
``cpg/analyses.py``). :func:`build_callgraph` resolves every non-operator
``CALL`` against the METHODs present in the same (merged) CPG:

- resolved  → a :class:`CallSite` with ``callee`` set, plus a
  ``(caller_method, callee_method)`` edge;
- unresolved (library calls like ``memcpy``, function pointers like
  ``(*fp)(x)``, or malformed empty names) → a *summarized external*: the
  call site is recorded with ``callee=None`` and contributes no transfer
  function — the supergraph treats it as an intraprocedural no-op, exactly
  the per-function semantics the intraprocedural analyses already have.

Degradation is total: nothing here raises on dangling or malformed callee
references — those are the JAX package's ``cpg/validate.py`` diagnostic
rows (``call-ref`` checks; not ported yet), and construction silently falls back to the external
summary. Ambiguous names (two METHODs sharing one name in a merged repo
CPG) resolve to the lowest METHOD id, deterministically.
"""

from __future__ import annotations

import dataclasses

from deepdfa_tpu_torch.cpg.schema import CPG

__all__ = ["CallSite", "CallGraph", "build_callgraph", "method_owner_map"]


@dataclasses.dataclass(frozen=True)
class CallSite:
    """One CALL node: ``callee`` is the resolved METHOD id or None for a
    summarized external."""

    call: int
    caller: int | None
    callee: int | None
    name: str


@dataclasses.dataclass
class CallGraph:
    """``methods``: name → METHOD id (lowest id wins on duplicates);
    ``sites``: every non-operator CALL, resolved or not; ``edges``: the
    resolved (caller, callee) METHOD pairs; ``external``: unresolved callee
    name → call-site count; ``ambiguous``: method names defined more than
    once in the CPG."""

    methods: dict[str, int]
    sites: list[CallSite]
    edges: set[tuple[int, int]]
    external: dict[str, int]
    ambiguous: tuple[str, ...]

    @property
    def n_call_edges(self) -> int:
        return sum(1 for s in self.sites if s.callee is not None)

    def callers_of(self, method: int) -> set[int]:
        return {c for c, t in self.edges if t == method}

    def root_methods(self) -> set[int]:
        """METHODs with no resolved incoming call edge — the entry points
        whose parameters the interprocedural taint seeds (a non-root's
        params are bound at its call sites instead)."""
        targets = {t for _, t in self.edges}
        return set(self.methods.values()) - targets


def method_owner_map(cpg: CPG) -> dict[int, int]:
    """node id → owning METHOD id (the METHOD itself maps to itself).

    Ownership is AST reachability from the METHOD root; nodes outside every
    method body (none in frontend-emitted graphs) are simply absent.
    """
    owner: dict[int, int] = {}
    for n in cpg.nodes.values():
        if n.label != "METHOD":
            continue
        owner[n.id] = n.id
        for d in cpg.ast_descendants(n.id):
            owner[d] = n.id
    return owner


def _is_operator(name: str) -> bool:
    return name.startswith("<operator")


def build_callgraph(cpg: CPG, owner: dict[int, int] | None = None) -> CallGraph:
    """Derive the call graph; never raises on malformed callee references.

    A CALL with an empty/operator name, a name that matches no METHOD, or a
    caller that cannot be attributed (dangling AST) degrades to an external
    summary / ``caller=None`` site rather than an error — the validate
    contract (``call-ref`` checks) reports those rows, construction keeps
    going.
    """
    if owner is None:
        owner = method_owner_map(cpg)
    methods: dict[str, int] = {}
    seen_names: dict[str, int] = {}
    for n in sorted(cpg.nodes.values(), key=lambda x: x.id):
        if n.label != "METHOD" or not n.name:
            continue
        seen_names[n.name] = seen_names.get(n.name, 0) + 1
        methods.setdefault(n.name, n.id)
    ambiguous = tuple(sorted(k for k, c in seen_names.items() if c > 1))

    sites: list[CallSite] = []
    edges: set[tuple[int, int]] = set()
    external: dict[str, int] = {}
    for n in sorted(cpg.nodes.values(), key=lambda x: x.id):
        if n.label != "CALL" or _is_operator(n.name):
            continue
        caller = owner.get(n.id)
        callee = methods.get(n.name) if n.name else None
        if callee == caller and callee is not None:
            pass  # recursion: a real call edge, keep it
        if callee is None:
            external[n.name or "<empty>"] = external.get(n.name or "<empty>", 0) + 1
        elif caller is not None:
            edges.add((caller, callee))
        sites.append(CallSite(call=n.id, caller=caller, callee=callee, name=n.name))
    return CallGraph(methods=methods, sites=sites, edges=edges,
                     external=external, ambiguous=ambiguous)
