"""The port's C front end and CPG analyses against the JAX package's, on the
CPU: the same C source goes through both packages' modules.

- CPGs equal node for node (id, label, name, code, line, order, type) and
  edge for edge, in order, on every ``realworld`` fixture and on
  ``interproc/cross_taint.c``;
- ``goldens.json``'s line facts reproduced by each of the port's three
  solver backends (Python sets, numpy bit matrix, the C++ worklist built
  by the host compiler);
- every analysis (reaching definitions, liveness, uninitialized, taint)
  and the static-analysis feature families equal on every fixture and
  backend;
- the interprocedural layer on ``cross_taint.c``: the supergraph, the
  cross-function taint findings, ``interproc_node_features`` and
  ``unit_summaries``;
- the synthetic C generators text for text;
- every case of ``scripts/frontend_torture.py`` (the same CPGs and
  dependence edges, or the same front-end error) and the depth-controlled
  ``chain_depth`` functions of ``demo_corpus``, before and after the
  patch.

Everything here is host code with no arithmetic in floating point beyond
``unit_summaries`` (float32 ``log1p`` of the same integers): all equal
exactly.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("pycparser")

from deepdfa_tpu.cpg import analyses as jan  # noqa: E402
from deepdfa_tpu.cpg import features as jfeat  # noqa: E402
from deepdfa_tpu.cpg import interproc as jip  # noqa: E402
from deepdfa_tpu.cpg.frontend import parse_functions as jparse_functions  # noqa: E402
from deepdfa_tpu.cpg.frontend import parse_source as jparse  # noqa: E402
from deepdfa_tpu.data import codegen as jcodegen  # noqa: E402
from deepdfa_tpu.models import ggnn_hier as jhier  # noqa: E402

from deepdfa_tpu_torch.cpg import analyses as an  # noqa: E402
from deepdfa_tpu_torch.cpg import features as feat  # noqa: E402
from deepdfa_tpu_torch.cpg import interproc as ip  # noqa: E402
from deepdfa_tpu_torch.cpg.dataflow import ReachingDefinitions  # noqa: E402
from deepdfa_tpu_torch.cpg.frontend import (FrontendError,  # noqa: E402
                                            parse_function, parse_functions,
                                            parse_source)
from deepdfa_tpu_torch.data import codegen  # noqa: E402
from deepdfa_tpu_torch.models import ggnn_hier as hier  # noqa: E402

FIXTURES = Path(__file__).parent / "fixtures"
REALWORLD = FIXTURES / "realworld"
GOLDENS = json.loads((REALWORLD / "goldens.json").read_text())
CROSS_TAINT = FIXTURES / "interproc" / "cross_taint.c"
SOURCES = {p.stem: p for p in sorted(REALWORLD.glob("*.c"))}
SOURCES["cross_taint"] = CROSS_TAINT
BACKENDS = ("sets", "bitvec", "native")


def _nodes(cpg):
    return [dataclasses.astuple(n) for n in cpg.nodes.values()]


def _facts(sol):
    """A solution as plain sorted data (reaching definitions by node id)."""
    def norm(facts):
        return sorted(f.node if isinstance(f, (an.VariableDefinition,
                                               jan.VariableDefinition))
                      else f for f in facts)
    return ({n: norm(s) for n, s in sol.in_facts.items()},
            {n: norm(s) for n, s in sol.out_facts.items()})


def test_the_native_solver_builds_on_this_host():
    assert an.native_available()
    assert an.NATIVE_SOURCE.name == "dfa_solver.cpp"


# ------------------------------------------------------------------ CPGs


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_cpg_equals_jax_node_for_node(name):
    code = SOURCES[name].read_text()
    got, want = parse_functions(code), jparse_functions(code)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert _nodes(a) == _nodes(b)
        assert a.edges == b.edges
    merged = parse_source(code)
    assert _nodes(merged) == _nodes(jparse(code))
    assert merged.edges == jparse(code).edges


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_dependence_edges_equal_jax_on_every_backend(name):
    code = SOURCES[name].read_text()
    want = jfeat.add_dependence_edges(jparse(code))
    for backend in BACKENDS:
        got = feat.add_dependence_edges(parse_source(code), backend=backend)
        assert sorted(got.edges) == sorted(want.edges), backend
        if backend == "native":  # the JAX package's own path: same order
            assert got.edges == want.edges


def test_frontend_errors_and_the_single_function_entry():
    with pytest.raises(FrontendError, match="no function definition"):
        parse_source("int x;")
    with pytest.raises(FrontendError):
        parse_source("int f( { return")
    code = SOURCES["early_return"].read_text()
    assert _nodes(parse_function(code)) == _nodes(parse_source(code))
    with pytest.raises(ValueError, match="backend"):
        feat.add_dependence_edges(parse_source(code), backend="gpu")


# -------------------------------------------------------------- goldens


def _line_facts(cpg, backend):
    rd = ReachingDefinitions(cpg)
    solver = {"sets": an.solve_sets, "bitvec": an.solve_bitvec,
              "native": an.solve_native}[backend]
    in_sets = solver(rd.to_problem()).in_facts
    line = lambda n: cpg.nodes[n].line  # noqa: E731
    reaches = sorted({
        (line(d.node), d.var, line(n))
        for n, defs in in_sets.items() for d in defs
        if line(d.node) is not None and line(n) is not None})

    def pairs(etype):
        return sorted({(line(s), line(t)) for s, t, e in cpg.edges
                       if e == etype and line(s) is not None
                       and line(t) is not None})

    return reaches, pairs("REACHING_DEF"), pairs("CDG")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_goldens_hold_on_every_backend(name, backend):
    src = (REALWORLD / f"{name}.c").read_text()
    cpg = feat.add_dependence_edges(parse_source(src), backend=backend)
    reaches, dd, cd = _line_facts(cpg, backend)
    gold = GOLDENS[name]
    assert reaches == [tuple(r) for r in gold["reaches"]]
    assert dd == [tuple(p) for p in gold["data_dep_lines"]]
    assert cd == [tuple(p) for p in gold["control_dep_lines"]]
    assert len(cpg.nodes) == gold["n_nodes"]


# ------------------------------------------------------------- analyses


@pytest.mark.parametrize("analysis", an.ANALYSES)
def test_every_analysis_equals_jax_on_every_backend(analysis):
    for name, path in SOURCES.items():
        code = path.read_text()
        want = _facts(jan.solve_analysis(analysis, jparse(code), "bitvec"))
        for backend in BACKENDS:
            got = _facts(an.solve_analysis(analysis, parse_source(code),
                                           backend))
            assert got == want, (name, backend)


@pytest.mark.parametrize("backend", BACKENDS)
def test_dataflow_families_equal_jax(backend):
    for name, path in SOURCES.items():
        code = path.read_text()
        want = jfeat.dataflow_node_features(jparse(code))
        got = feat.dataflow_node_features(parse_source(code), backend=backend)
        assert got == want, name


# ------------------------------------------------------------ interproc


@pytest.fixture(scope="module")
def supergraphs():
    code = CROSS_TAINT.read_text()
    jm, _ = jip.merge_cpgs([c for _, c in jparse_functions(code)])
    tm, _ = ip.merge_cpgs([c for _, c in parse_functions(code)])
    return ip.build_supergraph(tm), jip.build_supergraph(jm)


def test_supergraph_equals_jax(supergraphs):
    sg, jsg = supergraphs
    assert _nodes(sg.cpg) == _nodes(jsg.cpg)
    assert sg.cpg.edges == jsg.cpg.edges
    assert sg.owner == jsg.owner and sg.method_names == jsg.method_names
    assert sg.param_binds == jsg.param_binds
    assert sg.return_binds == jsg.return_binds
    assert sg.n_call_edges == jsg.n_call_edges == 1
    assert sorted(sg.callgraph.edges) == sorted(jsg.callgraph.edges)
    assert sg.callgraph.external == jsg.callgraph.external
    assert [dataclasses.astuple(s) for s in sg.callgraph.sites] == [
        dataclasses.astuple(s) for s in jsg.callgraph.sites]


@pytest.mark.parametrize("backend", BACKENDS)
def test_cross_function_taint_equals_jax(supergraphs, backend):
    sg, jsg = supergraphs
    got = ip.cross_function_taint(sg, solver=an._BACKENDS[backend])
    want = jip.cross_function_taint(jsg)
    assert got == want
    assert got["findings"], "cross_taint.c holds a cross-function flow"


def test_interproc_node_features_and_summaries_equal_jax(supergraphs):
    sg, jsg = supergraphs
    assert ip.interproc_node_features(sg.base, sg=sg) == \
        jip.interproc_node_features(jsg.base, sg=jsg)
    names = sorted(sg.method_names.values())
    got = hier.unit_summaries(sg, names)
    np.testing.assert_array_equal(got, jhier.unit_summaries(jsg, names))
    assert got.dtype == np.float32
    unit = hier.unit_graph(sg, names)
    snd, rcv = jhier.unit_call_edges(jsg, names)
    np.testing.assert_array_equal(unit.senders, snd)
    np.testing.assert_array_equal(unit.receivers, rcv)
    assert unit.n_call_edges == jsg.n_call_edges


@pytest.mark.parametrize("analysis", jip.IPROC_ANALYSES)
def test_interproc_analyses_equal_jax(analysis):
    code = CROSS_TAINT.read_text()
    want = _facts(jip.solve_interproc_analysis(analysis, jparse(code)))
    for backend in BACKENDS:
        got = _facts(ip.solve_interproc_analysis(analysis, parse_source(code),
                                                 backend))
        assert got == want, backend


# ------------------------------------------------------------- codegen


@pytest.mark.parametrize("kind", ["easy", "hard"])
def test_generators_equal_jax_text_for_text(kind):
    fn = {"easy": (codegen.generate_function, jcodegen.generate_function),
          "hard": (codegen.generate_hard_function,
                   jcodegen.generate_hard_function)}[kind]
    rng_a, rng_b = np.random.default_rng(5), np.random.default_rng(5)
    for fid in range(40):
        vul = fid % 2 == 0
        assert fn[0](fid, vul, rng_a) == fn[1](fid, vul, rng_b)
    row = fn[0](0, True, np.random.default_rng(1))
    assert parse_functions(row["before"]) and row["removed"]


# ------------------------------------------- the wider differential


def _torture_cases():
    spec = importlib.util.spec_from_file_location(
        "_frontend_torture", Path(__file__).resolve().parent.parent
        / "scripts" / "frontend_torture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.CASES


TORTURE = _torture_cases()


def _assert_front_ends_agree(code: str) -> None:
    """Both front ends on ``code``: the same function names, CPGs node for
    node and edge for edge, the same dependence edges in the same order;
    or the same front-end error."""
    try:
        want = jparse_functions(code)
    except Exception as exc:  # noqa: BLE001 — the port must fail alike
        with pytest.raises(FrontendError) as got:
            parse_functions(code)
        assert (type(exc).__name__, str(exc)) == ("FrontendError",
                                                  str(got.value))
        return
    got = parse_functions(code)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert _nodes(a) == _nodes(b)
        assert a.edges == b.edges
        assert feat.add_dependence_edges(a).edges == \
            jfeat.add_dependence_edges(b).edges


@pytest.mark.parametrize("case", TORTURE,
                         ids=[f"{c}-{n}" for c, n, _ in TORTURE])
def test_torture_case_equals_jax(case):
    _assert_front_ends_agree(case[2])


@pytest.mark.parametrize("depth", range(1, 7))
def test_chain_depth_functions_equal_jax(depth):
    rows = codegen.demo_corpus(10, seed=depth, chain_depth=depth)
    assert rows == jcodegen.demo_corpus(10, seed=depth,
                                        chain_depth=depth).to_dict("records")
    for row in rows:
        _assert_front_ends_agree(row["before"])
        _assert_front_ends_agree(row["after"])
