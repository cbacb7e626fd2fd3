"""Generic monotone bit-vector dataflow framework + the analysis suite.

A copy of ``deepdfa_tpu/cpg/analyses.py``. The analysis is data: a
:class:`Problem` declares ``(direction, meet, gen, kill)`` over a CPG's CFG
and any of the three backends solves it —

1. :func:`solve_sets`   — reference-shaped Python sets worklist;
2. :func:`solve_bitvec` — NumPy bit-matrix worklist (facts as bit positions);
3. :func:`solve_native` — C++ CSR worklist (``native/dfa_solver.cpp``,
   built by the host compiler into ``deepdfa_tpu_torch/_build/`` at first
   use, see :func:`deepdfa_tpu_torch.ops._build.build_host`) via ctypes,
   falling back to :func:`solve_bitvec` (with one warning) on hosts
   without a C++ compiler; :func:`native_available` says which ran.

Transfer function is the classic gen/kill form ``out = gen ∪ (in − kill)``.
``direction="backward"`` runs the same engine on the reversed CFG and swaps
the returned sets so :attr:`Solution.in_facts` is always the program-order
*entry* state (for liveness: ``in_facts = live_in``, ``out_facts =
live_out``). ``meet="may"`` is union (⊥ = ∅ start); ``meet="must"`` is
intersection (TOP start, boundary nodes pinned to ∅).

Shipped analyses, all under the Joern operator model of ``frontend.py``
(textual variable identity — ``*p`` and ``a[i]`` are variables, matching the
reference's reaching-defs semantics):

- :func:`reaching_definitions` — forward-may; facts are
  :class:`VariableDefinition`; the first client of the framework
  (``cpg/dataflow.py`` keeps the historical API on top of it);
- :func:`liveness` — backward-may; facts are variable codes; a plain
  assignment's bare-identifier lvalue is not a read, compound ops read
  their lvalue;
- :func:`uninitialized` — forward-may possibly-uninitialized locals: gen at
  METHOD entry (all of that method's LOCALs), strong kill at bare-identifier
  defs; :func:`uninitialized_uses` flags IDENTIFIER reads of in-set vars
  (``&x`` is not a read);
- :func:`solve_taint` — forward-may reachability from METHOD_PARAMETER_IN
  names and configurable source APIs (:data:`DEFAULT_TAINT_SOURCES`);
  assignment propagation is gen/kill with an outer monotone iteration
  (gens only grow, so the loop terminates).
"""

from __future__ import annotations

import ctypes
import dataclasses
import warnings
from pathlib import Path
from typing import Callable, Hashable, Iterable, Mapping

import numpy as np

from deepdfa_tpu_torch.cpg.schema import CPG

__all__ = [
    "ASSIGNMENT_OPS",
    "INC_DEC_OPS",
    "MOD_OPS",
    "PLAIN_ASSIGNMENT",
    "VariableDefinition",
    "assigned_variable",
    "defined_identifier",
    "Problem",
    "Solution",
    "solve_sets",
    "solve_bitvec",
    "solve_native",
    "native_available",
    "reaching_definitions",
    "liveness",
    "uninitialized",
    "uninitialized_uses",
    "DEFAULT_TAINT_SOURCES",
    "solve_taint",
    "taint_node_codes",
    "ANALYSES",
    "solve_analysis",
]

# ---------------------------------------------------------------- operators

ASSIGNMENT_OPS = tuple(
    "<operator>." + n
    for n in (
        "assignment",
        "assignmentAnd",
        "assignmentArithmeticShiftRight",
        "assignmentDivision",
        "assignmentExponentiation",
        "assignmentLogicalShiftRight",
        "assignmentMinus",
        "assignmentModulo",
        "assignmentMultiplication",
        "assignmentOr",
        "assignmentPlus",
        "assignmentShiftLeft",
        "assignmentXor",
    )
)
INC_DEC_OPS = tuple(
    "<operator>." + n
    for n in ("incBy", "postDecrement", "postIncrement", "preDecrement", "preIncrement")
)
# Joern emits "<operators>" for some programs; accept both spellings.
MOD_OPS = frozenset(
    ASSIGNMENT_OPS
    + INC_DEC_OPS
    + tuple(op.replace("<operator>", "<operators>") for op in ASSIGNMENT_OPS + INC_DEC_OPS)
)
# `x = e` does not read x; `x += e` / `x++` do.
PLAIN_ASSIGNMENT = frozenset({"<operator>.assignment", "<operators>.assignment"})
_ADDRESS_OF = frozenset({"<operator>.addressOf", "<operators>.addressOf"})


@dataclasses.dataclass(frozen=True)
class VariableDefinition:
    var: str
    node: int
    code: str = ""

    def __hash__(self):
        return self.node

    def __eq__(self, other):
        return self.node == other.node


def assigned_variable(cpg: CPG, nid: int) -> str | None:
    """The defined variable's source text, or None.

    First ARGUMENT child by ``order`` of a mod-op call; the child's ``code``
    is the variable expression (handles ``*p``, ``a[i]`` the way the
    reference does — textually).
    """
    node = cpg.nodes.get(nid)
    if node is None or node.name not in MOD_OPS:
        return None
    args = cpg.arguments(nid)
    if not args:
        return None
    first = args[min(args)]
    return cpg.nodes[first].code if first in cpg.nodes else None


def defined_identifier(cpg: CPG, nid: int) -> str | None:
    """The defined variable's name iff the lvalue is a bare IDENTIFIER — the
    only shape that admits a strong update (``*p``/``a[i]`` may alias)."""
    node = cpg.nodes.get(nid)
    if node is None or node.name not in MOD_OPS:
        return None
    args = cpg.arguments(nid)
    if not args:
        return None
    first = cpg.nodes.get(args[min(args)])
    if first is not None and first.label == "IDENTIFIER":
        return first.code
    return None


def _subtree(cpg: CPG, nid: int) -> list[int]:
    return [nid, *cpg.ast_descendants(nid)]


def _unread_lvalue_nodes(cpg: CPG, nid: int) -> set[int]:
    """AST nodes under ``nid`` that are written, not read: the lvalue root of
    every plain assignment in the subtree (a compound lvalue's *children*
    are still read — the address computation)."""
    out: set[int] = set()
    for c in _subtree(cpg, nid):
        node = cpg.nodes.get(c)
        if node is not None and node.name in PLAIN_ASSIGNMENT:
            args = cpg.arguments(c)
            if args:
                out.add(args[min(args)])
    return out


def _address_of_args(cpg: CPG, nid: int) -> set[int]:
    """Arguments of ``&x`` operators under ``nid`` — taking an address is
    not a read of the value."""
    out: set[int] = set()
    for c in _subtree(cpg, nid):
        node = cpg.nodes.get(c)
        if node is not None and node.name in _ADDRESS_OF:
            args = cpg.arguments(c)
            if args:
                out.add(args[min(args)])
    return out


# ---------------------------------------------------------------- framework


@dataclasses.dataclass
class Problem:
    """One monotone gen/kill dataflow instance over ``cpg``'s CFG.

    ``facts`` fixes the bit-vector layout (bit j = ``facts[j]``); ``gen`` /
    ``kill`` map CFG node id → set of facts. Transfer is
    ``out = gen ∪ (in − kill)`` on the direction-adjusted graph.
    """

    cpg: CPG
    direction: str  # "forward" | "backward"
    meet: str  # "may" | "must"
    facts: tuple[Hashable, ...]
    gen: Mapping[int, set]
    kill: Mapping[int, set]
    name: str = ""

    def __post_init__(self):
        if self.direction not in ("forward", "backward"):
            raise ValueError(f"direction must be forward|backward, got {self.direction!r}")
        if self.meet not in ("may", "must"):
            raise ValueError(f"meet must be may|must, got {self.meet!r}")
        self.nodes: list[int] = sorted(self.cpg.edge_nodes("CFG"))
        # Clip gen/kill to the declared fact universe so every backend sees
        # the same instance (a kill of a non-fact is a no-op anyway, but the
        # sets backend would otherwise happily gen one).
        universe = set(self.facts)
        self.gen = {n: set(s) & universe for n, s in self.gen.items()}
        self.kill = {n: set(s) & universe for n, s in self.kill.items()}

    def _edges(self, nid: int, incoming: bool) -> list[int]:
        """Direction-adjusted CFG neighbours: a backward problem walks the
        reversed graph, so its "predecessors" are CFG successors."""
        fwd = self.direction == "forward"
        if incoming == fwd:
            return self.cpg.predecessors(nid, "CFG")
        return self.cpg.successors(nid, "CFG")


@dataclasses.dataclass
class Solution:
    """Program-order fixpoint: ``in_facts[n]`` holds *before* node ``n``
    executes, ``out_facts[n]`` after — for backward problems too (the solver
    swaps its reversed-graph orientation back)."""

    in_facts: dict[int, set]
    out_facts: dict[int, set]


def _oriented(p: Problem, solver_in: dict, solver_out: dict) -> Solution:
    if p.direction == "forward":
        return Solution(solver_in, solver_out)
    return Solution(solver_out, solver_in)


def solve_sets(p: Problem) -> Solution:
    """Reference Python-sets chaotic-iteration worklist."""
    nodes = p.nodes
    known = set(nodes)
    must = p.meet == "must"
    full = set(p.facts)
    out_sets: dict[int, set] = {n: (set(full) if must else set()) for n in nodes}
    in_sets: dict[int, set] = {n: set() for n in nodes}
    work = list(nodes)
    while work:
        n = work.pop()
        preds = [q for q in p._edges(n, incoming=True) if q in known]
        if not preds:
            in_n: set = set()
        elif must:
            in_n = set.intersection(*(out_sets[q] for q in preds))
        else:
            in_n = set().union(*(out_sets[q] for q in preds))
        in_sets[n] = in_n
        new_out = set(p.gen.get(n, ())) | (in_n - set(p.kill.get(n, ())))
        if new_out != out_sets[n]:
            out_sets[n] = new_out
            work.extend(s for s in p._edges(n, incoming=False) if s in known)
    return _oriented(p, in_sets, out_sets)


def _encode(p: Problem):
    """Index nodes and facts; gen/kill bool matrices + direction-adjusted
    predecessor/successor index lists (shared by the vector solvers)."""
    nodes = p.nodes
    idx = {n: i for i, n in enumerate(nodes)}
    fidx = {f: j for j, f in enumerate(p.facts)}
    n, m = len(nodes), len(p.facts)
    gen = np.zeros((n, m), dtype=bool)
    kill = np.zeros((n, m), dtype=bool)
    for nid in nodes:
        i = idx[nid]
        for f in p.gen.get(nid, ()):
            gen[i, fidx[f]] = True
        for f in p.kill.get(nid, ()):
            kill[i, fidx[f]] = True
    preds = [[idx[q] for q in p._edges(nid, incoming=True) if q in idx] for nid in nodes]
    succs = [[idx[q] for q in p._edges(nid, incoming=False) if q in idx] for nid in nodes]
    return nodes, gen, kill, preds, succs


def _decode(p: Problem, nodes: list[int], mat: np.ndarray) -> dict[int, set]:
    facts = np.empty(len(p.facts), dtype=object)
    for j, f in enumerate(p.facts):
        facts[j] = f
    return {nid: set(facts[mat[i]].tolist()) for i, nid in enumerate(nodes)}


def solve_bitvec(p: Problem) -> Solution:
    """NumPy bit-matrix worklist."""
    nodes, gen, kill, preds, succs = _encode(p)
    n, m = gen.shape
    if n == 0:
        return Solution({}, {})
    must = p.meet == "must"
    out = np.ones((n, m), dtype=bool) if must else np.zeros((n, m), dtype=bool)
    inn = np.zeros((n, m), dtype=bool)
    reduce_ = np.logical_and.reduce if must else np.logical_or.reduce
    work = list(range(n))
    in_work = [True] * n
    while work:
        i = work.pop()
        in_work[i] = False
        x = reduce_(out[preds[i]], axis=0) if preds[i] else np.zeros(m, dtype=bool)
        inn[i] = x
        new_out = gen[i] | (x & ~kill[i])
        if not np.array_equal(new_out, out[i]):
            out[i] = new_out
            for s in succs[i]:
                if not in_work[s]:
                    work.append(s)
                    in_work[s] = True
    return _oriented(p, _decode(p, nodes, inn), _decode(p, nodes, out))


# ---------------------------------------------------------------- native

# the repository's C++ solver; the JAX package builds it in place with make,
# the port with the host compiler into its own build directory
NATIVE_SOURCE = Path(__file__).resolve().parents[2] / "native" / "dfa_solver.cpp"

_LIB: ctypes.CDLL | None = None
_NATIVE_ERROR: str | None = None


def _native_lib() -> ctypes.CDLL:
    """Build (a no-op when the digest-named library exists) and load the
    C++ solver. Raises on compiler-less hosts — :func:`solve_native`
    catches and falls back."""
    global _LIB
    if _LIB is not None:
        return _LIB
    from deepdfa_tpu_torch.ops import _build

    lib = _build.load_host("dfa_solver", NATIVE_SOURCE)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.solve_dataflow.restype = ctypes.c_int
    lib.solve_dataflow.argtypes = [
        ctypes.c_int32,  # n_nodes
        ctypes.c_int32,  # n_facts
        ctypes.c_int32,  # meet_is_must
        i32p, i32p,  # pred CSR (direction-adjusted)
        i32p, i32p,  # succ CSR
        u64p, u64p,  # gen, kill [n * words]
        u64p, u64p,  # out: in / out [n * words], caller-initialised
    ]
    _LIB = lib
    return lib


def native_available() -> bool:
    """Whether the C++ solver built and loaded (else :func:`solve_native`
    runs the bit-vector solver)."""
    return _try_native_lib() is not None


def _try_native_lib() -> ctypes.CDLL | None:
    """One warning per process when the native solver can't build/load; all
    later calls silently take the bit-vector fallback."""
    global _NATIVE_ERROR
    if _NATIVE_ERROR is not None:
        return None
    try:
        return _native_lib()
    except Exception as exc:  # noqa: BLE001 — toolchain-less hosts
        _NATIVE_ERROR = f"{type(exc).__name__}: {exc}"
        warnings.warn(
            f"native dataflow solver unavailable ({_NATIVE_ERROR}); "
            "falling back to the NumPy bit-vector solver (identical "
            "fixpoints, slower on large functions)",
            RuntimeWarning,
            stacklevel=3,
        )
        return None


def _pack_bits(mat: np.ndarray) -> np.ndarray:
    """bool [n, m] → uint64 [n, ceil(m/64)] little-endian bit packing."""
    n, m = mat.shape
    words = max((m + 63) // 64, 1)
    padded = np.zeros((n, words * 64), dtype=bool)
    padded[:, :m] = mat
    b = np.packbits(padded, axis=1, bitorder="little")
    return b.reshape(n, words, 8).view(np.uint64).reshape(n, words)


def _unpack_bits(packed: np.ndarray, m: int) -> np.ndarray:
    n, words = packed.shape
    bytes_ = packed.reshape(n, words, 1).view(np.uint8).reshape(n, words * 8)
    bits = np.unpackbits(bytes_, axis=1, bitorder="little")
    return bits[:, :m].astype(bool)


def _csr(lists: list[list[int]]) -> tuple[np.ndarray, np.ndarray]:
    indptr = np.zeros(len(lists) + 1, dtype=np.int32)
    for i, l in enumerate(lists):
        indptr[i + 1] = indptr[i] + len(l)
    indices = np.concatenate([np.array(l, dtype=np.int32) for l in lists]) if any(lists) else np.zeros(0, np.int32)
    return indptr, indices


def solve_native(p: Problem) -> Solution:
    """C++ CSR worklist; output contract identical to :func:`solve_bitvec`.
    Falls back to the bit-vector solver when no C++ compiler is available
    (one warning per process)."""
    lib = _try_native_lib()
    if lib is None:
        return solve_bitvec(p)
    nodes, gen, kill, preds, succs = _encode(p)
    n, m = gen.shape
    if n == 0:
        return Solution({}, {})
    words = max((m + 63) // 64, 1)
    must = p.meet == "must"
    gen_p = np.ascontiguousarray(_pack_bits(gen))
    kill_p = np.ascontiguousarray(_pack_bits(kill))
    in_p = np.zeros((n, words), dtype=np.uint64)
    # must starts at TOP (all facts, padding bits included — they are
    # sliced off at unpack), may at ⊥
    fill = np.uint64(0xFFFFFFFFFFFFFFFF) if must else np.uint64(0)
    out_p = np.full((n, words), fill, dtype=np.uint64)
    pp, pi = _csr(preds)
    sp, si = _csr(succs)

    as_u64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
    as_i32 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    rc = lib.solve_dataflow(
        n, m, int(must), as_i32(pp), as_i32(pi), as_i32(sp), as_i32(si),
        as_u64(gen_p), as_u64(kill_p), as_u64(in_p), as_u64(out_p),
    )
    if rc != 0:
        raise RuntimeError(f"native solver failed with rc={rc}")
    inn = _unpack_bits(in_p, m)
    out = _unpack_bits(out_p, m)
    return _oriented(p, _decode(p, nodes, inn), _decode(p, nodes, out))


# ---------------------------------------------------------------- analyses


def _sorted_codes(codes: Iterable[str]) -> tuple[str, ...]:
    return tuple(sorted(set(codes)))


def reaching_definitions(cpg: CPG) -> Problem:
    """Forward-may reaching definitions — the framework formulation of the
    historical :class:`deepdfa_tpu_torch.cpg.dataflow.ReachingDefinitions` (which
    now delegates here; identical semantics incl. the textual-variable and
    ``<operators>`` quirks)."""
    gen: dict[int, set] = {}
    by_var: dict[str, set[VariableDefinition]] = {}
    for nid in cpg.nodes:
        var = assigned_variable(cpg, nid)
        if var is None:
            gen[nid] = set()
            continue
        d = VariableDefinition(var, nid, cpg.nodes[nid].code)
        gen[nid] = {d}
        by_var.setdefault(var, set()).add(d)
    kill = {
        nid: {d for d in by_var.get(assigned_variable(cpg, nid) or "", ()) if d.node != nid}
        for nid in cpg.nodes
    }
    facts = tuple(sorted(set().union(*by_var.values()) if by_var else set(), key=lambda d: d.node))
    return Problem(cpg, "forward", "may", facts, gen, kill, name="reaching_defs")


def liveness(cpg: CPG) -> Problem:
    """Backward-may live variables over textual variable codes.

    ``use(n)``: IDENTIFIER codes in the statement's subtree (minus plain-
    assignment lvalues) plus compound lvalue codes (``*p``, ``a[i]``) that
    are defined somewhere in the function; ``def(n)``: the assigned code.
    Program-order ``out_facts`` is ``live_out`` — the feature family
    ``_DFA_live_out`` counts it.
    """
    def_codes = {assigned_variable(cpg, n) for n in cpg.nodes} - {None}
    cfg_nodes = cpg.edge_nodes("CFG")
    gen: dict[int, set] = {}
    kill: dict[int, set] = {}
    all_uses: set[str] = set()
    for n in cfg_nodes:
        unread = _unread_lvalue_nodes(cpg, n)
        uses: set[str] = set()
        for d in _subtree(cpg, n):
            if d in unread:
                continue
            nd = cpg.nodes.get(d)
            if nd is None:
                continue
            if nd.label == "IDENTIFIER" or (nd.label == "CALL" and nd.code in def_codes):
                uses.add(nd.code)
        var = assigned_variable(cpg, n)
        gen[n] = uses
        kill[n] = {var} if var is not None else set()
        all_uses |= uses
    facts = _sorted_codes(all_uses | def_codes)
    return Problem(cpg, "backward", "may", facts, gen, kill, name="liveness")


def _method_ast_map(cpg: CPG, label: str) -> dict[int, set[str]]:
    """METHOD node id → names of its ``label``-labelled AST descendants
    (per-method scoping for merged multi-function CPGs)."""
    out: dict[int, set[str]] = {}
    for n in cpg.nodes.values():
        if n.label != "METHOD":
            continue
        out[n.id] = {
            cpg.nodes[d].name
            for d in cpg.ast_descendants(n.id)
            if d in cpg.nodes and cpg.nodes[d].label == label and cpg.nodes[d].name
        }
    return out


def uninitialized(cpg: CPG) -> Problem:
    """Forward-may possibly-uninitialized locals: every LOCAL of a method is
    generated at its METHOD entry and killed by a bare-identifier definition.
    A node reads a possibly-uninit var iff it uses a name still in its IN set
    (:func:`uninitialized_uses`)."""
    locals_by_method = _method_ast_map(cpg, "LOCAL")
    cfg_nodes = cpg.edge_nodes("CFG")
    gen = {n: set() for n in cfg_nodes}
    for mid, names in locals_by_method.items():
        if mid in gen:
            gen[mid] = set(names)
    kill: dict[int, set] = {}
    for n in cfg_nodes:
        name = defined_identifier(cpg, n)
        kill[n] = {name} if name is not None else set()
    facts = _sorted_codes(set().union(*locals_by_method.values()) if locals_by_method else set())
    return Problem(cpg, "forward", "may", facts, gen, kill, name="uninit")


def uninitialized_uses(cpg: CPG, solution: Solution) -> dict[int, set[str]]:
    """Node id → local names read while possibly uninitialized. Reads are
    bare IDENTIFIERs only; plain-assignment lvalues and ``&x`` arguments are
    writes/address-takes, not reads."""
    flags: dict[int, set[str]] = {}
    for n, in_facts in solution.in_facts.items():
        if not in_facts:
            continue
        skip = _unread_lvalue_nodes(cpg, n) | _address_of_args(cpg, n)
        reads = {
            cpg.nodes[d].code
            for d in _subtree(cpg, n)
            if d not in skip and d in cpg.nodes and cpg.nodes[d].label == "IDENTIFIER"
        }
        bad = reads & in_facts
        if bad:
            flags[n] = bad
    return flags


DEFAULT_TAINT_SOURCES = frozenset({
    "fgetc", "fgets", "fread", "fscanf", "getc", "getchar", "getenv",
    "gets", "read", "recv", "recvfrom", "scanf",
})


def _taint_static(cpg: CPG, source_apis: frozenset[str]):
    """Static part of the taint instance: seed gens (params at METHOD entry,
    source-API results, identifier and address-of arguments of source calls
    — ``gets(buf)`` writes through buf), strong kills at defs, per-def RHS
    mention sets for the propagation rounds."""
    params_by_method = _method_ast_map(cpg, "METHOD_PARAMETER_IN")
    cfg_nodes = cpg.edge_nodes("CFG")
    base_gen: dict[int, set] = {n: set() for n in cfg_nodes}
    kill: dict[int, set] = {n: set() for n in cfg_nodes}
    def_var: dict[int, str] = {}
    def_rhs: dict[int, set[str]] = {}
    facts: set[str] = set().union(*params_by_method.values()) if params_by_method else set()

    for mid, names in params_by_method.items():
        if mid in base_gen:
            base_gen[mid] = set(names)

    for n in cfg_nodes:
        var = assigned_variable(cpg, n)
        sub = _subtree(cpg, n)
        # the METHOD entry's AST subtree is the whole function — scanning it
        # for source calls would taint their args from entry; a call's taint
        # belongs to the statement node that contains it
        source_calls = [] if cpg.nodes[n].label == "METHOD" else [
            c for c in sub
            if c in cpg.nodes
            and cpg.nodes[c].label == "CALL"
            and cpg.nodes[c].name in source_apis
        ]
        if var is not None:
            facts.add(var)
            kill[n] = {var}
            def_var[n] = var
            # RHS mentions (textual, compound codes included) drive the
            # propagation rounds; the plain-assignment lvalue subtree is
            # written, not read, so `x = 0` untaints x
            excl: set[int] = set()
            node = cpg.nodes.get(n)
            if node is not None and node.name in PLAIN_ASSIGNMENT:
                args = cpg.arguments(n)
                if args:
                    lv = args[min(args)]
                    excl = {lv, *cpg.ast_descendants(lv)}
            def_rhs[n] = {
                cpg.nodes[d].code
                for d in sub
                if d not in excl and d != n and d in cpg.nodes
                and cpg.nodes[d].label in ("IDENTIFIER", "CALL")
            }
            if source_calls:
                base_gen[n].add(var)
        for c in source_calls:
            # out-buffers are passed bare (array decay: gets(buf)) or by
            # address (scanf("%d", &x)); both taint the argument.  Bare
            # identifier args over-taint counts/fds — conservative for may.
            tainted_args = {
                a for a in cpg.arguments(c).values()
                if a in cpg.nodes and cpg.nodes[a].label == "IDENTIFIER"
            }
            tainted_args |= _address_of_args(cpg, c)
            for a in tainted_args:
                nd = cpg.nodes.get(a)
                if nd is not None and nd.code:
                    facts.add(nd.code)
                    base_gen[n].add(nd.code)
    return _sorted_codes(facts), base_gen, kill, def_var, def_rhs


def solve_taint(
    cpg: CPG,
    source_apis: frozenset[str] = DEFAULT_TAINT_SOURCES,
    solver: Callable[[Problem], Solution] = solve_bitvec,
) -> Solution:
    """Parameter/API taint reachability fixpoint.

    Assignment propagation ("``x = f(y)`` taints x when y is tainted") makes
    gen depend on the solution, so the inner gen/kill solve sits in an outer
    iteration that re-derives the conditional gens from the last fixpoint.
    Gens only ever grow (in-sets grow monotonically with gens), so the loop
    terminates in ≤ |facts| rounds — and every backend reaches the same
    fixpoint because each round's Problem is identical across backends.
    """
    facts, base_gen, kill, def_var, def_rhs = _taint_static(cpg, source_apis)
    extra: dict[int, set] = {n: set() for n in base_gen}
    while True:
        gen = {n: base_gen[n] | extra[n] for n in base_gen}
        sol = solver(Problem(cpg, "forward", "may", facts, gen, kill, name="taint"))
        changed = False
        for n, var in def_var.items():
            if var in gen[n]:
                continue
            if def_rhs[n] & sol.in_facts.get(n, set()):
                extra[n].add(var)
                changed = True
        if not changed:
            return sol


def taint_node_codes(
    cpg: CPG,
    source_apis: frozenset[str] = DEFAULT_TAINT_SOURCES,
    solver: Callable[[Problem], Solution] = solve_bitvec,
) -> dict[int, int]:
    """Per-CFG-node taint code for the ``_DFA_taint`` feature family:
    0 = untouched, 1 = uses a tainted variable, 2 = introduces/propagates
    taint (source call, tainted assignment, or parameter entry)."""
    facts, base_gen, kill, def_var, def_rhs = _taint_static(cpg, source_apis)
    sol = solve_taint(cpg, source_apis, solver)
    out: dict[int, int] = {}
    for n, in_facts in sol.in_facts.items():
        # a node introduces taint iff its OUT has facts survival can't explain
        gens = sol.out_facts.get(n, set()) - (in_facts - kill.get(n, set()))
        if gens:
            out[n] = 2
            continue
        mentions = {
            cpg.nodes[d].code
            for d in _subtree(cpg, n)
            if d in cpg.nodes and cpg.nodes[d].label in ("IDENTIFIER", "CALL")
        }
        out[n] = 1 if mentions & in_facts else 0
    return out


# ------------------------------------------------------------- registry

ANALYSES = ("reaching_defs", "liveness", "uninit", "taint")

_BACKENDS: dict[str, Callable[[Problem], Solution]] = {
    "sets": solve_sets,
    "bitvec": solve_bitvec,
    "native": solve_native,
}


def solve_analysis(name: str, cpg: CPG, backend: str = "bitvec") -> Solution:
    """Solve one named analysis with one backend — the uniform entry point
    used by the parity tests and the throughput bench."""
    solver = _BACKENDS[backend]
    if name == "taint":
        return solve_taint(cpg, solver=solver)
    problems = {
        "reaching_defs": reaching_definitions,
        "liveness": liveness,
        "uninit": uninitialized,
    }
    return solver(problems[name](cpg))
