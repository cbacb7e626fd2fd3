"""The port's Joern ingestion, REPL driver and fault points against the JAX
package's, on the CPU.

- ``cpg/joern.py``: ``read_raw``/``load_tables`` row for row against the
  pandas tables, ``load_cpg`` node for node and edge for edge, on
  ``tests/fixtures/sample.c.*.json`` and on a copy with every cleanup case
  (a missing line number, ``<empty>`` code, dropped labels and edge types,
  repeated edges, endpoints that are not numbers); ``load_dataflow``;
  ``reexport_dataflow``'s JSON and summary bytes; ``JoernRunner``;
- ``cpg/schema.py``: ``CPG.from_tables``, ``edge_arrays``, ``attr`` and
  ``khop_neighbours`` on both packages' CPG;
- ``cpg/joern_session.py`` on a fake prompt-driven REPL (the protocol
  cases of ``tests/test_joern_session.py``) and on the three transcript
  replays of ``tests/fixtures/joern_transcripts/``, with the ``joern.die``
  and ``joern.hang`` faults through the extraction supervisor;
- ``resilience/faults.py``: the spec grammar and the ``(seed, point,
  hit)`` schedule equal to the JAX registry's.

Tables and CPGs are compared exactly (a NaN equals a NaN), files byte for
byte.
"""

import json
import os
import shutil
import stat
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("scipy")

from deepdfa_tpu.cpg import joern as jjoern  # noqa: E402
from deepdfa_tpu.cpg import schema as jschema  # noqa: E402
from deepdfa_tpu.resilience import faults as jfaults  # noqa: E402

from deepdfa_tpu_torch.cpg import joern, schema  # noqa: E402
from deepdfa_tpu_torch.cpg.joern_session import (JoernSession,  # noqa: E402
                                                  JoernTimeout,
                                                  joern_available,
                                                  marshal_params, strip_ansi)
from deepdfa_tpu_torch.resilience import faults  # noqa: E402
from deepdfa_tpu_torch.resilience.supervisor import (  # noqa: E402
    ExtractionSupervisor, QuarantinedError)

FIXTURES = Path(__file__).resolve().parent / "fixtures"
SAMPLE = FIXTURES / "sample.c"
TRANSCRIPTS = FIXTURES / "joern_transcripts"


def plain(value):
    if isinstance(value, dict):
        return {k: plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [plain(v) for v in value]
    if isinstance(value, np.generic):
        value = value.item()
    if isinstance(value, float) and value != value:
        return "<NaN>"
    return value


def assert_rows_equal(rows, df):
    assert [plain(r) for r in rows] == [plain(r) for r in df.to_dict("records")]
    if rows:
        assert list(rows[0]) == list(df.columns)


def cpg_tuple(cpg):
    return ([(n.id, n.label, n.name, n.code, n.line, n.order,
              n.type_full_name) for n in cpg.nodes.values()], cpg.edges)


def messy_artifacts(tmp_path: Path) -> Path:
    """sample.c's artifacts with every cleanup case added."""
    nodes = json.loads((FIXTURES / "sample.c.nodes.json").read_text())
    edges = json.loads((FIXTURES / "sample.c.edges.json").read_text())
    nodes += [
        {"id": 90, "_label": "CALL", "name": "g", "code": "<empty>",
         "lineNumber": 4, "order": 2},
        {"id": 91, "_label": "IDENTIFIER", "name": "q", "code": "",
         "lineNumber": "5", "typeFullName": "int"},
        {"id": 92, "_label": "LOCAL", "name": "r", "code": None},
        {"id": 93, "_label": "COMMENT", "code": "// c", "lineNumber": 2},
        {"id": 94, "_label": "LITERAL", "name": "1", "code": "1",
         "lineNumber": 6, "columnNumber": 3, "fullName": None},
    ]
    edges += [
        [90, 1, "AST", None], [90, 1, "AST", "x"], [91, 90, "ARGUMENT", None],
        [92, 1, "AST"], ["93", "1", "AST", None], ["x", 1, "CFG", None],
        [94, 91, "REACHING_DEF", "q"], [94, 1, "DOMINATE", None],
        [99, 94, "CFG", None],
    ]
    stem = tmp_path / "messy.c"
    Path(f"{stem}.nodes.json").write_text(json.dumps(nodes))
    Path(f"{stem}.edges.json").write_text(json.dumps(edges))
    return stem


@pytest.fixture(params=["sample", "messy"])
def stem(request, tmp_path):
    return SAMPLE if request.param == "sample" else messy_artifacts(tmp_path)


# ------------------------------------------------------------ artifacts


def test_read_raw_and_load_tables_match_jax(stem):
    for mine, ref in zip(joern.read_raw(stem), jjoern.read_raw(stem)):
        assert_rows_equal(mine, ref)
    nodes, edges = joern.load_tables(stem)
    jnodes, jedges = jjoern.load_tables(stem)
    assert_rows_equal(nodes, jnodes)
    assert_rows_equal(edges, jedges)


def test_load_cpg_matches_jax_node_for_node(stem):
    got, want = joern.load_cpg(stem), jjoern.load_cpg(stem)
    assert cpg_tuple(got) == cpg_tuple(want) and len(got) > 3
    for etype in ("AST", "CFG", "REACHING_DEF", "ARGUMENT"):
        for a, b in zip(got.edge_arrays(etype), want.edge_arrays(etype)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    for name in ("line", "code", "order", "label"):
        assert got.attr(name) == want.attr(name)


def test_from_tables_matches_jax(stem):
    import pandas as pd

    nodes, edges = joern.load_tables(stem)
    jnodes, jedges = jjoern.load_tables(stem)
    nodes = [n for n in nodes if n["lineNumber"] == n["lineNumber"]]
    jnodes = jnodes[jnodes.lineNumber.notna()]
    assert cpg_tuple(schema.CPG.from_tables(nodes, edges)) == \
        cpg_tuple(jschema.CPG.from_tables(jnodes, jedges))
    assert isinstance(jnodes, pd.DataFrame)


def test_a_graph_without_a_method_raises(tmp_path):
    stem = tmp_path / "nomethod.c"
    Path(f"{stem}.nodes.json").write_text(json.dumps(
        [{"id": 1, "_label": "CALL", "lineNumber": 1}]))
    Path(f"{stem}.edges.json").write_text("[]")
    for load in (joern.load_tables, jjoern.load_tables):
        with pytest.raises(ValueError, match="no METHOD node"):
            load(stem)


@pytest.mark.parametrize("gtype", ["all", "cfg", "pdg", "ast"])
@pytest.mark.parametrize("hop,intermediate", [(1, True), (2, True), (2, False),
                                              (3, True)])
def test_khop_neighbours_match_jax(gtype, hop, intermediate):
    got, want = joern.load_cpg(SAMPLE), jjoern.load_cpg(SAMPLE)
    ids = sorted(got.nodes)
    assert schema.khop_neighbours(got, ids, hop, gtype, intermediate) == \
        jschema.khop_neighbours(want, ids, hop, gtype, intermediate)


def test_load_dataflow_matches_jax():
    path = f"{SAMPLE}.dataflow.json"
    assert joern.load_dataflow(path) == jjoern.load_dataflow(path)


def test_reexport_dataflow_writes_the_jax_bytes(tmp_path, stem):
    for side in ("jax", "port"):
        d = tmp_path / side
        d.mkdir()
        for ext in (".nodes.json", ".edges.json"):
            shutil.copyfile(f"{stem}{ext}", d / f"f.c{ext}")
    out = joern.reexport_dataflow(tmp_path / "port" / "f.c")
    jout = jjoern.reexport_dataflow(tmp_path / "jax" / "f.c")
    for suffix in (".dataflow.json", ".dataflow.summary.json"):
        assert Path(f"{tmp_path / 'port' / 'f.c'}{suffix}").read_bytes() == \
            Path(f"{tmp_path / 'jax' / 'f.c'}{suffix}").read_bytes()
    assert json.loads(out.read_text()) == json.loads(jout.read_text())
    # the summary marker makes the next call a no-op; cache=False re-solves
    out.write_text("{}")
    assert joern.reexport_dataflow(tmp_path / "port" / "f.c").read_text() == "{}"
    joern.reexport_dataflow(tmp_path / "port" / "f.c", cache=False)
    assert out.read_bytes() == jout.read_bytes()


def test_joern_runner_without_a_binary(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    runner = joern.JoernRunner()
    assert runner.script.read_bytes() == (
        Path(jjoern.__file__).parent / "queries" / "export_func_graph.sc"
    ).read_bytes()
    assert not runner.available
    c_file = tmp_path / "f.c"
    with pytest.raises(RuntimeError, match="not on PATH"):
        runner.run(c_file)
    with pytest.raises(RuntimeError, match="not on PATH"):
        runner.reexport_dataflow(c_file)
    for ext in (".nodes.json", ".edges.json"):   # artifacts present: skipped
        shutil.copyfile(f"{SAMPLE}{ext}", f"{c_file}{ext}")
    assert runner.run(c_file) == c_file


# ------------------------------------------------------------ the session


def install_fake_joern(bindir: Path) -> Path:
    """A ``joern`` on ``bindir`` that speaks the REPL surface: a prompt, an
    ack of each command, the exit question, and
    ``export_func_graph.exec(filename="…")`` answered by copying
    sample.c's artifacts next to the named file."""
    bindir.mkdir(parents=True, exist_ok=True)
    script = bindir / "joern"
    script.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import shutil, sys
        FIXTURE = {str(SAMPLE)!r}
        HEAD = 'export_func_graph.exec(filename="'
        sys.stdout.write("fake joern booting\\njoern> ")
        sys.stdout.flush()
        for line in sys.stdin:
            line = line.rstrip("\\n")
            if line == "exit":
                sys.stdout.write("really exit? [y/N]\\n")
                sys.stdout.flush()
                continue
            if line == "y":
                break
            if line.startswith(HEAD):
                stem = line[len(HEAD):].split('"')[0]
                for ext in (".nodes.json", ".edges.json", ".dataflow.json"):
                    shutil.copyfile(FIXTURE + ext, stem + ext)
            sys.stdout.write("ack:" + line + "\\njoern> ")
            sys.stdout.flush()
        """))
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return script


@pytest.fixture()
def fake_joern(tmp_path, monkeypatch):
    script = install_fake_joern(tmp_path / "bin")
    monkeypatch.setenv("PATH", f"{tmp_path / 'bin'}{os.pathsep}{os.environ['PATH']}")
    return script


def test_strip_ansi_and_marshal_params():
    assert strip_ansi("\x1b[1mjoern>\x1b[0m ok\x1b[2K") == "joern> ok"
    out = marshal_params({"filename": Path("/tmp/a.c"), "runOssDataflow": True,
                          "n": 3, "weird": 'a"b\\c'})
    assert out == 'filename="/tmp/a.c", runOssDataflow=true, n=3, weird="a\\"b\\\\c"'
    with pytest.raises(TypeError):
        marshal_params({"x": object()})


def test_session_prompt_sync_and_close(fake_joern, tmp_path):
    sess = JoernSession(cwd=tmp_path, timeout=20)
    try:
        assert sess.run_command("workspace") == "ack:workspace"
        assert sess.run_command("print(1)") == "ack:print(1)"
    finally:
        sess.close()
    assert sess.proc.returncode == 0


def test_session_run_script_stages_marshals_and_exports(fake_joern, tmp_path):
    c_file = tmp_path / "f.c"
    with JoernSession(worker_id=3, cwd=tmp_path, timeout=20) as sess:
        out = sess.run_script("export_func_graph",
                              {"filename": str(c_file), "exportCpg": False})
    staged = tmp_path / "deepdfa_joern_scripts" / "export_func_graph.sc"
    assert staged.read_bytes() == (
        Path(jjoern.__file__).parent / "queries" / "export_func_graph.sc"
    ).read_bytes()
    assert out == f'ack:export_func_graph.exec(filename="{c_file}", exportCpg=false)'
    assert cpg_tuple(joern.load_cpg(c_file)) == cpg_tuple(joern.load_cpg(SAMPLE))


def test_session_missing_binary_and_timeout(fake_joern, tmp_path, monkeypatch):
    sess = JoernSession(cwd=tmp_path, timeout=20)
    try:
        # 'exit' makes the fake REPL answer without a prompt → the timeout
        sess.proc.stdin.write("exit\n")
        sess.proc.stdin.flush()
        with pytest.raises(JoernTimeout, match="no joern prompt") as info:
            sess.read_until_prompt(timeout=1.0)
        assert isinstance(info.value, TimeoutError)
        assert "really exit?" in info.value.partial
    finally:
        sess.close()
    monkeypatch.setenv("PATH", str(tmp_path / "nothing"))
    assert not joern_available()
    with pytest.raises(RuntimeError, match="not on PATH"):
        JoernSession(cwd=tmp_path)


@pytest.mark.faults
def test_die_and_hang_faults(fake_joern, tmp_path):
    sess = JoernSession(cwd=tmp_path, timeout=20)
    try:
        with faults.installed("joern.hang@1"):
            with pytest.raises(JoernTimeout):
                sess.run_command("workspace", timeout=1.0)
        assert sess.run_command("ping") == "ack:ping"   # re-synced
        with faults.installed("joern.die@1"):
            with pytest.raises(RuntimeError, match="exited unexpectedly"):
                sess.run_command("workspace")
    finally:
        sess.close()


@pytest.mark.faults
def test_supervisor_restarts_and_quarantines_real_sessions(fake_joern, tmp_path):
    sup = ExtractionSupervisor(lambda: JoernSession(cwd=tmp_path, timeout=20),
                               attempts_per_item=2, sleep=lambda _s: None)
    with sup:
        with faults.installed("joern.die@1"):
            assert sup.run("f1", lambda s: s.run_command("x f1")) == "ack:x f1"
        assert sup.restarts == 1
        with faults.installed("joern.hang@1,2"):
            with pytest.raises(QuarantinedError):
                sup.run("poison", lambda s: s.run_command("x p", timeout=0.5))
            assert sup.run("good", lambda s: s.run_command("x g")) == "ack:x g"
    report = sup.report()
    assert [e["key"] for e in report["quarantined"]] == ["poison"]
    assert "no joern prompt" in report["quarantined"][0]["error"]
    assert "partial" in report["quarantined"][0]
    assert report["restarts"] == 3


@pytest.fixture()
def joern_replay(tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    target = bindir / "joern"
    target.write_text(f"#!/bin/sh\nexec {sys.executable} "
                      f"{TRANSCRIPTS / 'replay_repl.py'} \"$@\"\n")
    target.chmod(target.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")

    def use(name: str) -> None:
        monkeypatch.setenv("JOERN_TRANSCRIPT", str(TRANSCRIPTS / f"{name}.json"))

    return use


def test_transcript_import_script_export(joern_replay, tmp_path):
    joern_replay("import_script_export")
    before = tmp_path / "before"
    before.mkdir()
    c_file = before / "f0.c"
    c_file.write_text("int f0(int x) { return x; }\n")
    proj = tmp_path / "workspace" / "f0.c"
    proj.mkdir(parents=True)
    (proj / "cpg.bin").write_bytes(b"CPGBIN")
    with JoernSession(cwd=tmp_path, timeout=30) as sess:
        out = sess.import_cpg(c_file)
        assert "Code successfully imported" in out
        assert Path(str(c_file) + ".cpg.bin").read_bytes() == b"CPGBIN"
        out = sess.run_script(
            "export_func_graph",
            {"filename": str(c_file), "runOssDataflow": True,
             "exportJson": True, "exportCpg": False})
    assert "wrote" in out and "res2" in out and "\x1b" not in out


def test_transcript_worker_workspace(joern_replay, tmp_path):
    joern_replay("worker_workspace")
    with JoernSession(worker_id=2, cwd=tmp_path, timeout=30) as sess:
        out = sess.list_workspace()
    assert "overlays" in out and "\x1b" not in out


def test_transcript_import_cpg_direct_and_mismatch(joern_replay, tmp_path):
    joern_replay("import_cpg_direct")
    before = tmp_path / "before"
    before.mkdir()
    c_file = before / "f1.c"
    c_file.write_text("int f1(void) { return 1; }\n")
    Path(str(c_file) + ".cpg.bin").write_bytes(b"CPGBIN")
    with JoernSession(cwd=tmp_path, timeout=30) as sess:
        assert "res0" in sess.import_cpg(c_file)
        sess.delete_project()
    sess = JoernSession(cwd=tmp_path, timeout=30)
    try:
        with pytest.raises(RuntimeError, match="TRANSCRIPT MISMATCH"):
            sess.run_command("workspace")   # the transcript expects importCpg
    finally:
        sess.close()


# ------------------------------------------------------------ fault points


SPECS = ["joern.die@2", "joern.die@3,4,5", "joern.hang:p=0.25:seed=7:max=2",
         "joern.hang", "joern.hang:p=0.5:seed=3;joern.die:p=0.1:seed=9",
         "step.nan_grads@1;joern.die@1"]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_schedule_equals_jax(spec):
    mine, ref = faults.parse_spec(spec), jfaults.parse_spec(spec)
    assert list(mine) == list(ref)
    for point in mine:
        assert mine[point].schedule(200) == ref[point].schedule(200)
    with faults.installed(spec), jfaults.installed(spec):
        fired = [(faults.fire(p), jfaults.fire(p))
                 for _ in range(50) for p in ("joern.die", "joern.hang")]
        assert [a for a, _ in fired] == [b for _, b in fired]
        assert faults.counters() == jfaults.counters()


def test_the_port_declares_only_the_points_it_fires():
    assert faults.KNOWN_POINTS == (
        "ckpt.crash_between_state_and_meta", "step.nan_grads",
        "prefetch.producer_raises", "joern.hang", "joern.die",
        "serve.drop_request", "serve.engine_raises", "preempt.sigterm",
        "mesh.device_lost", "step.hang", "obs.trace_drop", "obs.flight_drop",
        "autoscale.spawn_fail", "autoscale.replica_crash",
        "extract.worker_crash", "extract.cache_corrupt",
        "cascade.tier2_timeout", "cascade.escalation_drop",
        "frontend.worker_crash", "frontend.spawn_fail",
        "embcache.cache_corrupt", "admission.bucket_exhausted",
        "admission.deadline_blown", "admission.brownout_force",
        "continual.capture_drop", "continual.rollout_crash",
        "continual.rollback_trigger", "federation.cell_kill",
        "federation.spillover_drop", "federation.probe_partition")
    assert set(faults.KNOWN_POINTS) <= set(jfaults.KNOWN_POINTS)
    assert set(faults.POINT_DOCS) == set(faults.KNOWN_POINTS)
    for point in faults.KNOWN_POINTS:
        assert faults.POINT_DOCS[point] == jfaults.POINT_DOCS[point]
    with pytest.raises(ValueError, match="unknown fault option"):
        faults.parse_spec("joern.die:q=1")
