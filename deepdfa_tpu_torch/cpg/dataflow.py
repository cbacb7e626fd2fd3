"""Reaching-definitions analysis — the "DFA" in DeepDFA.

A copy of ``deepdfa_tpu/cpg/dataflow.py``: the historical API
(:class:`ReachingDefinitions`, :func:`solve_bitvec`, :func:`solve_native`)
on top of the generic framework of :mod:`deepdfa_tpu_torch.cpg.analyses`,
with the reference's semantics (``DDFA/code_gnn/analysis/dataflow.py``):

- a node generates a definition iff it is a call named by one of the 18
  assignment / inc-dec operators (both ``<operator>.*`` and the
  ``<operators>`` spelling Joern sometimes emits);
- the defined variable is the ``code`` of the call's first ARGUMENT child
  (lowest ``order``);
- a definition of ``v`` kills every other definition of ``v``;
- MOP fixpoint over the CFG via a chaotic-iteration worklist.
"""

from __future__ import annotations

from deepdfa_tpu_torch.cpg import analyses
from deepdfa_tpu_torch.cpg.analyses import (
    ASSIGNMENT_OPS,
    INC_DEC_OPS,
    MOD_OPS,
    Problem,
    VariableDefinition,
    reaching_definitions,
)
from deepdfa_tpu_torch.cpg.schema import CPG

__all__ = [
    "ASSIGNMENT_OPS",
    "INC_DEC_OPS",
    "MOD_OPS",
    "VariableDefinition",
    "ReachingDefinitions",
    "solve_bitvec",
    "solve_native",
]


class ReachingDefinitions:
    """Gen/kill construction + solver entry points over a CPG's CFG."""

    def __init__(self, cpg: CPG):
        self.cpg = cpg
        self.cfg_nodes = sorted(cpg.edge_nodes("CFG"))
        self.gen: dict[int, set[VariableDefinition]] = {}
        for nid in cpg.nodes:
            var = self.assigned_variable(nid)
            if var is not None:
                self.gen[nid] = {
                    VariableDefinition(var, nid, cpg.nodes[nid].code)
                }
            else:
                self.gen[nid] = set()

    @property
    def domain(self) -> set[VariableDefinition]:
        return set().union(*self.gen.values()) if self.gen else set()

    def kill(self, nid: int, defs: set[VariableDefinition]) -> set[VariableDefinition]:
        """The definitions of ``defs`` that node ``nid`` kills: every other
        definition of the variable it assigns."""
        var = self.assigned_variable(nid)
        if var is None:
            return set()
        return {d for d in defs if d.var == var and d.node != nid}

    def assigned_variable(self, nid: int) -> str | None:
        """The defined variable's source text, or None (first ARGUMENT child
        by ``order`` of a mod-op call; textual, handles ``*p``, ``a[i]``)."""
        return analyses.assigned_variable(self.cpg, nid)

    def to_problem(self) -> Problem:
        """The framework formulation of this instance (forward-may)."""
        return reaching_definitions(self.cpg)

    def solve(self) -> tuple[dict[int, set], dict[int, set]]:
        """Worklist MOP fixpoint; returns (in_sets, out_sets) of
        :class:`VariableDefinition` keyed by CFG node."""
        sol = analyses.solve_sets(self.to_problem())
        return sol.in_facts, sol.out_facts


def _as_ids(sets: dict[int, set]) -> dict[int, set[int]]:
    return {nid: {d.node for d in s} for nid, s in sets.items()}


def solve_bitvec(rd: ReachingDefinitions):
    """NumPy bit-matrix worklist; returns (in_sets, out_sets) as
    {node_id: set[def_node_id]}."""
    sol = analyses.solve_bitvec(rd.to_problem())
    return _as_ids(sol.in_facts), _as_ids(sol.out_facts)


def solve_native(rd: ReachingDefinitions):
    """C++ worklist solver; identical output contract to :func:`solve_bitvec`.
    Falls back to the bit-vector solver (one warning) on toolchain-less
    machines — see :func:`deepdfa_tpu_torch.cpg.analyses.solve_native`."""
    sol = analyses.solve_native(rd.to_problem())
    if not sol.in_facts and not sol.out_facts:
        return {}, {}
    return _as_ids(sol.in_facts), _as_ids(sol.out_facts)
