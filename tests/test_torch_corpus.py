"""The port's corpus side against the JAX package's, on the CPU: the same
inputs through both packages.

- ``demo_corpus`` rows (easy, hard, ``chain_depth`` 2 and 5, two seeds);
- the line-level labels (``line_dependencies``, ``dep_add_lines``), the
  IVDetect features and ``statement_labels`` over the ``realworld``
  fixtures and demo before/after pairs, and a label cache the JAX package
  wrote, read through the port's plain-data unpickler;
- the structural validator over the fixtures, ``scripts/frontend_torture.py``'s
  ``CASES`` and deliberately broken graphs; ``to_dot``; the pure ingest
  helpers (comments, diffs, named splits);
- ``CorpusBuilder.build`` graphs bit for bit (senders, receivers, every
  feature key in order, dtypes) and vocabularies, with the feature families
  on and off and with ``dataflow_labels`` on and off;
- ``save_shards`` file bytes and ``manifest.json``, each package loading
  the other's shards, ``ShardIntegrityError``;
- the port's preprocess against ``scripts/preprocess.py`` over ``demo`` n
  80 in two storage trees (shards, ``splits.json``, ``split.txt``,
  ``vocab.json``, statement labels, summary counts, hash rows), with a
  random and a named cross-project split; the split-marker guard and a
  journal resume after a crash mid-build;
- the same over the real-dataset readers on files written in the
  published schemas: Big-Vul with the fixed (LineVul) and the random
  split, Devign with its fixed (CodeXGLUE) split and graph labels,
  DiverseVul, a mutated set, and Big-Vul through ``--frontend joern``
  under a fake ``joern`` REPL that answers each export with
  ``tests/fixtures/sample.c``'s artifacts;
- ``load_corpus`` per split against the JAX package's on the same
  directory (random split, the named split's repartition, the leakage
  guard), and one ``fit`` step on a shard batch (demo, Big-Vul and the
  graph-level Devign shards) against the JAX trainer's.

All host-side outputs are compared exactly. The train step uses
``tests/test_torch_train_loop.py``'s tolerances (loss and gradients atol
2e-5, rtol 1e-4; parameters 1e-6 where the gradient is above 1e-6). Every
test points ``DEEPDFA_STORAGE`` at a temporary directory.
"""

import copy
import csv
import gzip
import hashlib
import importlib.util
import json
import os
import pickle
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("pycparser")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepdfa_tpu.config import DataConfig as JData  # noqa: E402
from deepdfa_tpu.config import ExperimentConfig as JExp  # noqa: E402
from deepdfa_tpu.config import FeatureConfig as JFeat  # noqa: E402
from deepdfa_tpu.config import GGNNConfig as JCfg  # noqa: E402
from deepdfa_tpu.cpg import features as jfeat  # noqa: E402
from deepdfa_tpu.cpg import ivdetect as jivd  # noqa: E402
from deepdfa_tpu.cpg import plot as jplot  # noqa: E402
from deepdfa_tpu.cpg import schema as jschema  # noqa: E402
from deepdfa_tpu.cpg import validate as jvalidate  # noqa: E402
from deepdfa_tpu.cpg.dataflow import ReachingDefinitions as JRD  # noqa: E402
from deepdfa_tpu.cpg.frontend import parse_source as jparse  # noqa: E402
from deepdfa_tpu.data import codegen as jcodegen  # noqa: E402
from deepdfa_tpu.data import graphs as jgraphs  # noqa: E402
from deepdfa_tpu.data import ingest as jingest  # noqa: E402
from deepdfa_tpu.data.materialize import CorpusBuilder as JBuilder  # noqa: E402
from deepdfa_tpu.models import make_model as jmake_model  # noqa: E402
from deepdfa_tpu.train import cli as jcli  # noqa: E402
from deepdfa_tpu.train import loop as jloop  # noqa: E402
from deepdfa_tpu.train import metrics as jmetrics  # noqa: E402

from deepdfa_tpu_torch import bridge, preprocess  # noqa: E402
from deepdfa_tpu_torch.config import (DataConfig, ExperimentConfig,  # noqa: E402
                                      FeatureConfig, GGNNConfig)
from deepdfa_tpu_torch.cpg import features as feat  # noqa: E402
from deepdfa_tpu_torch.cpg import ivdetect, plot, schema, validate  # noqa: E402
from deepdfa_tpu_torch.cpg.dataflow import ReachingDefinitions  # noqa: E402
from deepdfa_tpu_torch.cpg.frontend import FrontendError, parse_source  # noqa: E402
from deepdfa_tpu_torch.data import codegen, graphs, ingest  # noqa: E402
from deepdfa_tpu_torch.data.graphs import batch_np, to_device  # noqa: E402
from deepdfa_tpu_torch.data.materialize import CorpusBuilder  # noqa: E402
from deepdfa_tpu_torch.models import make_model  # noqa: E402
from deepdfa_tpu_torch.train import fit as fit_mod  # noqa: E402
from deepdfa_tpu_torch.train import loop  # noqa: E402
from deepdfa_tpu_torch.train.metrics import ConfusionState  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
REALWORLD = Path(__file__).parent / "fixtures" / "realworld"
FIXTURES = {p.stem: p.read_text() for p in sorted(REALWORLD.glob("*.c"))}
N_DEMO = 80
FOLD = "cross_project_fold_0"


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TORTURE = _load_script("frontend_torture").CASES


@pytest.fixture(autouse=True)
def _own_storage(tmp_path_factory, monkeypatch):
    monkeypatch.setenv("DEEPDFA_STORAGE", str(tmp_path_factory.mktemp("storage")))


def _both(code: str):
    """(port CPG, JAX CPG) of ``code`` with dependence edges."""
    return (feat.add_dependence_edges(parse_source(code)),
            jfeat.add_dependence_edges(jparse(code)))


def _pairs(n: int = 24, seed: int = 5):
    """Vulnerable demo rows of both generators (before/after pairs)."""
    rows = codegen.demo_corpus(n, seed=seed) + codegen.demo_corpus(
        n, seed=seed, style="hard")
    return [r for r in rows if r["vul"]]


# ------------------------------------------------------------- codegen


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("kind", [{}, {"style": "hard"}, {"chain_depth": 2},
                                  {"chain_depth": 5}],
                         ids=["easy", "hard", "chain2", "chain5"])
def test_demo_corpus_rows_equal_jax(kind, seed):
    got = codegen.demo_corpus(60, seed=seed, **kind)
    want = jcodegen.demo_corpus(60, seed=seed, **kind).to_dict("records")
    assert got == want
    assert {type(v) for r in got for v in r.values()} == {
        type(v) for r in want for v in r.values()}


# ------------------------------------------------------- line labels


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_line_labels_and_ivdetect_features_equal_jax(name):
    cpg, jcpg = _both(FIXTURES[name])
    assert feat.line_dependencies(cpg) == jfeat.line_dependencies(jcpg)
    assert ivdetect.line_dependency_context(cpg) == \
        jivd.line_dependency_context(jcpg)
    assert ivdetect.feature_extraction(cpg) == jivd.feature_extraction(jcpg)


def test_dep_add_lines_and_features_equal_jax_on_demo_pairs():
    for row in _pairs():
        before, jbefore = _both(row["before"])
        after, jafter = _both(row["after"])
        assert feat.dep_add_lines(before, after, row["added"]) == \
            jfeat.dep_add_lines(jbefore, jafter, row["added"])
        assert ivdetect.feature_extraction(after) == \
            jivd.feature_extraction(jafter)


def test_feature_extraction_cache_round_trips(tmp_path):
    cpg, _ = _both(FIXTURES["early_return"])
    first = ivdetect.feature_extraction(cpg, cache_dir=tmp_path, key="f")
    assert (tmp_path / "f.pkl").exists()
    assert ivdetect.feature_extraction(None, cache_dir=tmp_path,
                                       key="f") == first


def test_statement_labels_equal_jax_and_read_a_jax_cache(tmp_path):
    rows = codegen.demo_corpus(40, seed=2) + [
        dict(r, id=r["id"] + 100) for r in codegen.demo_corpus(
            20, seed=2, style="hard")]
    cpgs = {r["id"]: _both(r["before"])[0] for r in rows}
    jcpgs = {r["id"]: _both(r["before"])[1] for r in rows}
    got = ivdetect.statement_labels(rows, cpgs, parse_source)
    want = jivd.statement_labels(rows, jcpgs, jparse)
    assert got == want and got
    # a cache the JAX package wrote is plain data: the port loads it
    path = tmp_path / "statement_labels.pkl"
    jivd.statement_labels(rows, jcpgs, jparse, cache_path=path)
    assert ivdetect.statement_labels(rows, {}, parse_source,
                                     cache_path=path) == want
    # and writes the same bytes for the same labels
    port_path = tmp_path / "port.pkl"
    ivdetect.statement_labels(rows, cpgs, parse_source, cache_path=port_path)
    assert port_path.read_bytes() == path.read_bytes()


def test_a_label_cache_naming_a_class_is_refused_and_recomputed(tmp_path):
    rows = [r for r in codegen.demo_corpus(10, seed=1) if r["vul"]]
    cpgs = {r["id"]: _both(r["before"])[0] for r in rows}
    path = tmp_path / "labels.pkl"
    path.write_bytes(pickle.dumps({"x": Path("/")}))
    got = ivdetect.statement_labels(rows, cpgs, parse_source, cache_path=path)
    assert set(got) == {r["id"] for r in rows}
    assert ivdetect.statement_labels(rows, {}, parse_source,
                                     cache_path=path) == got


# ----------------------------------------------------------- validator


def _diags(diags):
    return [(d.check, d.severity, d.message, d.node, d.edge) for d in diags]


def _tables(cpg):
    return ([dict(vars(n)) for n in cpg.nodes.values()], list(cpg.edges))


def _rebuild(nodes, edges):
    """The same node and edge tables as a port CPG and a JAX CPG."""
    return (schema.CPG([schema.Node(**n) for n in nodes], edges),
            jschema.CPG([jschema.Node(**n) for n in nodes], edges))


def _break(kind: str, nodes, edges):
    """A deliberately malformed copy of a parsed function's tables."""
    nodes, edges = copy.deepcopy(nodes), list(edges)
    ids = [n["id"] for n in nodes]
    if kind == "dangling-edge":
        edges.append((ids[0], max(ids) + 1000, "CFG"))
    elif kind == "no-method":
        nodes = [n for n in nodes if n["label"] != "METHOD"]
    elif kind == "unreachable-return":
        ret = next(n["id"] for n in nodes if n["label"] == "METHOD_RETURN")
        edges = [e for e in edges if not (e[2] == "CFG" and e[1] == ret)]
    elif kind == "unknown-operator":
        call = next(n for n in nodes if n["name"].startswith("<operator>."))
        call["name"] = "<operator>.bogus"
    elif kind == "argument-order-duplicate":
        by_call: dict = {}
        for s, d, e in edges:
            if e == "ARGUMENT":
                by_call.setdefault(s, []).append(d)
        args = next(v for v in by_call.values() if len(v) >= 2)
        for n in nodes:
            if n["id"] in args:
                n["order"] = 1
    return nodes, edges


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_validator_equals_jax_on_fixtures(name):
    cpg, jcpg = _both(FIXTURES[name])
    assert _diags(validate.validate_cpg(cpg)) == \
        _diags(jvalidate.validate_cpg(jcpg))


@pytest.mark.parametrize("case", TORTURE, ids=[f"{c}-{n}" for c, n, _ in TORTURE])
def test_validator_equals_jax_on_torture_cases(case):
    _, _, code = case
    try:
        want = jparse(code)
    except Exception as exc:  # noqa: BLE001 — the port must fail alike
        with pytest.raises(FrontendError) as got:
            parse_source(code)
        assert (type(exc).__name__, str(exc)) == ("FrontendError",
                                                  str(got.value))
        return
    got = parse_source(code)
    assert _diags(validate.validate_cpg(got)) == \
        _diags(jvalidate.validate_cpg(want))


@pytest.mark.parametrize("kind", ["dangling-edge", "no-method",
                                  "unreachable-return", "unknown-operator",
                                  "argument-order-duplicate"])
def test_validator_flags_broken_graphs_as_jax_does(kind):
    cpg, _ = _both(FIXTURES["ptr_walk"])
    tcpg, jcpg = _rebuild(*_break(kind, *_tables(cpg)))
    got = validate.validate_cpg(tcpg)
    assert _diags(got) == _diags(jvalidate.validate_cpg(jcpg))
    assert kind in {d.check for d in got}
    corpus = {0: tcpg, 1: _both(FIXTURES["early_return"])[0]}
    jcorpus = {0: jcpg, 1: _both(FIXTURES["early_return"])[1]}
    assert dict(validate.validate_corpus(corpus.items())) == \
        dict(jvalidate.validate_corpus(jcorpus.items()))
    kept, summary = ingest.validate_cpgs(corpus)
    jkept, jsummary = jingest.validate_cpgs(jcorpus)
    assert list(kept) == list(jkept) == [1] and summary == jsummary


@pytest.mark.parametrize("gtype", ["all", "cfg"])
def test_to_dot_equals_jax(gtype, tmp_path):
    for name, code in FIXTURES.items():
        cpg, jcpg = _both(code)
        rd = ReachingDefinitions(cpg).solve()[1]
        jrd = JRD(jcpg).solve()[1]
        assert plot.to_dot(cpg, gtype, rd_out=rd) == \
            jplot.to_dot(jcpg, gtype, rd_out=jrd), name
    plot.write_dot(cpg, tmp_path / "a.dot", gtype=gtype)
    jplot.write_dot(jcpg, tmp_path / "b.dot", gtype=gtype)
    assert (tmp_path / "a.dot").read_bytes() == (tmp_path / "b.dot").read_bytes()


def test_ingest_helpers_equal_jax(tmp_path):
    for row in _pairs(12):
        text = "/* head */ " + row["before"] + ' // "tail"\nchar *s = "//x";'
        assert ingest.remove_comments(text) == jingest.remove_comments(text)
        assert ingest.diff_lines(row["before"], row["after"]) == \
            jingest.diff_lines(row["before"], row["after"])
    ids = list(range(30))
    smap = {i: ("train" if i % 3 else "test") for i in ids[:25]}
    assert ingest.partition_ids(ids, smap) == jingest.partition_ids(ids, smap)
    path = _fold_csvs(tmp_path, N_DEMO) / f"{FOLD}_holdout.csv"
    assert ingest.named_splits("x", path) == \
        jingest.named_splits("x", path).to_dict()
    report = {"quarantined": [{"key": 3, "reason": "boom"}]}
    ingest.write_quarantine(tmp_path, report)
    assert ingest.read_quarantine(tmp_path) == jingest.read_quarantine(tmp_path)
    assert ingest.read_quarantine(tmp_path / "none")["quarantined"] == []


# ---------------------------------------------------------- the builder


@pytest.fixture(scope="module")
def corpus_cpgs():
    """Demo functions of both generators and the fixtures (one graph per
    file), as port and JAX CPGs under the same ids."""
    rows = codegen.demo_corpus(24, seed=4) + [
        dict(r, id=r["id"] + 100)
        for r in codegen.demo_corpus(12, seed=4, style="hard")]
    sources = {r["id"]: r["before"] for r in rows}
    for k, code in enumerate(FIXTURES.values()):
        sources[1000 + k] = code
    pairs = {fid: _both(code) for fid, code in sources.items()}
    vuln = {r["id"]: set(r["removed"]) for r in rows}
    vuln.update({fid: {3, 5} for fid in sources if fid >= 1000})
    return ({k: v[0] for k, v in pairs.items()},
            {k: v[1] for k, v in pairs.items()}, vuln)


def assert_graphs_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.gid == b.gid
        for field in ("senders", "receivers"):
            x, y = getattr(a, field), getattr(b, field)
            assert x.dtype == y.dtype and np.array_equal(x, y)
        assert list(a.node_feats) == list(b.node_feats)
        for k, v in a.node_feats.items():
            w = b.node_feats[k]
            assert v.dtype == w.dtype and np.array_equal(v, w), k


@pytest.mark.parametrize("dataflow_labels", [False, True])
@pytest.mark.parametrize("families", ["none", "dataflow", "dataflow+interproc"])
def test_corpus_builder_graphs_equal_jax(corpus_cpgs, families,
                                         dataflow_labels):
    cpgs, jcpgs, vuln = corpus_cpgs
    flags = dict(dataflow_families="dataflow" in families,
                 interproc_families="interproc" in families)
    train = sorted(cpgs)[::2]
    builder = CorpusBuilder(FeatureConfig(limit_all=40, limit_subkeys=30,
                                          **flags))
    jbuilder = JBuilder(JFeat(limit_all=40, limit_subkeys=30, **flags))
    got, vocabs = builder.build(cpgs, train, vuln_lines=vuln,
                                dataflow_labels=dataflow_labels)
    want, jvocabs = jbuilder.build(jcpgs, train, vuln_lines=vuln,
                                   dataflow_labels=dataflow_labels)
    assert_graphs_equal(got, want)
    assert {k: v.to_dict() for k, v in vocabs.items()} == {
        k: v.to_dict() for k, v in jvocabs.items()}
    assert builder.hash_rows == jbuilder.hash_df.to_dict("records")
    if flags["interproc_families"]:
        assert "_DFA_itaint" in got[0].node_feats


def test_corpus_builder_graph_labels_equal_jax(corpus_cpgs):
    cpgs, jcpgs, _ = corpus_cpgs
    labels = {k: k % 2 for k in cpgs}
    got, _ = CorpusBuilder().build(cpgs, list(cpgs), graph_labels=labels)
    want, _ = JBuilder().build(jcpgs, list(jcpgs), graph_labels=labels)
    assert_graphs_equal(got, want)
    with pytest.raises(ValueError, match="exactly one"):
        CorpusBuilder().build(cpgs, list(cpgs))


# ---------------------------------------------------------------- shards


@pytest.fixture(scope="module")
def built(corpus_cpgs):
    cpgs, _, vuln = corpus_cpgs
    got, _ = CorpusBuilder(FeatureConfig(dataflow_families=True)).build(
        cpgs, list(cpgs), vuln_lines=vuln, dataflow_labels=True)
    return got


def test_save_shards_bytes_and_manifest_equal_jax(built, tmp_path):
    assert graphs.save_shards(built, tmp_path / "port", shard_size=16) == \
        jgraphs.save_shards(built, tmp_path / "jax", shard_size=16) == 3
    port = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert port == sorted(p.name for p in (tmp_path / "jax").iterdir())
    for name in port:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    # each package loads the other's shards
    assert_graphs_equal(graphs.load_shards(tmp_path / "jax"), built)
    assert_graphs_equal(jgraphs.load_shards(tmp_path / "port"), built)


@pytest.mark.parametrize("fault", ["flipped", "missing", "foreign"])
def test_shard_integrity_errors(built, tmp_path, fault):
    d = tmp_path / "shards"
    graphs.save_shards(built, d, shard_size=16)
    target = d / "shard_00001.npz"
    if fault == "flipped":
        data = bytearray(target.read_bytes())
        data[len(data) // 2] ^= 0xFF
        target.write_bytes(bytes(data))
        match = "shard_00001.npz is corrupt"
    elif fault == "missing":
        target.unlink()
        match = "missing on disk: shard_00001.npz"
    else:
        shutil.copy(target, d / "shard_00009.npz")
        match = "shard_00009.npz present on disk but not in"
    with pytest.raises(graphs.ShardIntegrityError, match=match):
        graphs.load_shards(d)
    with pytest.raises(jgraphs.ShardIntegrityError, match=match):
        jgraphs.load_shards(d)


def test_shards_without_a_manifest_load_unverified(built, tmp_path):
    graphs.save_shards(built, tmp_path, shard_size=16)
    (tmp_path / "manifest.json").unlink()
    assert_graphs_equal(graphs.load_shards(tmp_path), built)


# ------------------------------------------------------------ preprocess


def _fold_csvs(root: Path, n: int) -> Path:
    """Fold-0 split files over demo ids 0..n-1, in the reference's csv
    shape (a leading row-index column): "project A" = the first 3/4 of the
    ids (train/valid/test), "project B" the rest (holdout)."""
    splits_dir = root / "external" / "splits"
    splits_dir.mkdir(parents=True, exist_ok=True)
    cut = 3 * n // 4
    rows_ds = [",example_index,split"]
    rows_ho = [",example_index,split"]
    for i in range(cut):
        part = "valid" if i % 10 == 8 else "test" if i % 10 == 9 else "train"
        rows_ds.append(f"{i},{i},{part}")
        rows_ho.append(f"{i},{i},train")
    for j, i in enumerate(range(cut, n)):
        rows_ho.append(f"{cut + j},{i},holdout")
    (splits_dir / f"{FOLD}_dataset.csv").write_text("\n".join(rows_ds))
    (splits_dir / f"{FOLD}_holdout.csv").write_text("\n".join(rows_ho))
    return splits_dir


N_REAL = 40


def _write_datasets(root: Path) -> None:
    """The real-dataset files in their published schemas under
    ``root/external``: a full-schema MSR CSV of generated pairs (every
    tenth a dataflow-hard one) plus rows the quality filters drop, the
    LineVul split (one id unassigned), Devign's ``function.json`` with the
    CodeXGLUE split, a DiverseVul JSONL and a mutated JSONL over the
    Big-Vul ids (one repeated)."""
    import pandas as pd

    from test_torch_ingest import (SIX, _msr_base, devign_objs,
                                   diversevul_objs, write_json)

    ext = root / "external"
    (ext / "mutated").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(11)
    pairs = []
    for i in range(N_REAL):
        r = (codegen.generate_hard_function(i, i % 2 == 0, rng, chain_depth=6)
             if i % 10 == 9 else codegen.generate_function(i, i % 2 == 0, rng))
        pairs.append((r["before"], r["after"], r["vul"]))
    pairs += [(SIX, SIX, 1), (SIX + "foo(x);", SIX + "foo(y);", 1)]
    pd.DataFrame([dict(_msr_base(i), func_before=b, func_after=a, vul=v)
                  for i, (b, a, v) in enumerate(pairs)]).to_csv(
        ext / "MSR_data_cleaned.csv")
    parts = ["train"] * 7 + ["valid", "test", "test"]
    (ext / "linevul_splits.csv").write_text("index,split\n" + "".join(
        f"{i},{parts[i % 10]}\n" for i in range(len(pairs)) if i != 5))
    objs = devign_objs(N_REAL)
    write_json(ext / "function.json", objs, False)
    (ext / "codexglue_splits.csv").write_text("example_index,split\n" + "".join(
        f"{i},{parts[i % 10]}\n" for i in range(len(objs))))
    write_json(ext / "diversevul.json", diversevul_objs(), True)
    mrng = np.random.default_rng(12)
    write_json(ext / "mutated" / "c_rename.jsonl", [
        {"idx": i, "source": codegen.generate_function(i, True, mrng)["before"],
         "target": codegen.generate_function(i, False, mrng)["before"]}
        for i in [0, 1, 2, 3, 3, 4, 6, 8, 10, 12, 14, 17, 20, 23, 27, 31]],
        True)


def _run_both(root: Path, argv: list[str]):
    """The JAX script and the port's entry over the same arguments and input
    files, each in its own storage tree (and working directory, where a
    Joern session stages its scripts); returns their summaries."""
    from test_torch_joern import install_fake_joern

    jpre = _load_script("preprocess")
    install_fake_joern(root / "bin")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PATH", f"{root / 'bin'}{os.pathsep}{os.environ['PATH']}")
        for side, main in (("jax", lambda: jpre.main(argv + ["--workers", "1"])),
                           ("port", lambda: preprocess.main(
                               argv + ["--workers", "3"]))):
            _fold_csvs(root / side, N_DEMO)
            _write_datasets(root / side)
            mp.setenv("DEEPDFA_STORAGE", str(root / side))
            mp.chdir(root / side)
            out[side] = main()
    return out["jax"], out["port"]


def _hash_rows(shard_dir: Path) -> list[dict]:
    parquet = shard_dir / "hashes.parquet"
    if parquet.exists():
        import pandas as pd

        df = pd.read_parquet(parquet)
    else:
        import pandas as pd

        df = pd.read_csv(shard_dir / "hashes.csv.gz")
    return df.to_dict("records")


@pytest.fixture(scope="module", params=["random", f"{FOLD}_dataset"])
def preprocessed(request, tmp_path_factory):
    root = tmp_path_factory.mktemp("pre")
    argv = ["--dataset", "demo", "--n", str(N_DEMO), "--split", request.param]
    want, got = _run_both(root, argv)
    return root, want, got


COUNTS = ("status", "functions", "cpgs", "graphs", "failed", "failed_rate",
          "shards", "vul_graphs")


def assert_same_outputs(want: dict, got: dict, labels: bool = True):
    """Equal summary counts, the same files byte for byte (the stage-2
    hash table as rows: pandas may write it as parquet)."""
    jdir, tdir = Path(want["out"]), Path(got["out"])
    assert {k: got[k] for k in COUNTS} == {k: want[k] for k in COUNTS}
    assert got["extraction"]["extracted"] == want["extraction"]["extracted"]
    names = sorted(p.name for p in jdir.iterdir()
                   if not p.name.startswith("hashes."))
    assert names == sorted(p.name for p in tdir.iterdir()
                           if not p.name.startswith("hashes."))
    assert any(n.startswith("statement_labels") for n in names) == labels
    for name in names:
        a, b = (jdir / name).read_bytes(), (tdir / name).read_bytes()
        assert hashlib.sha256(a).digest() == hashlib.sha256(b).digest(), name
    with gzip.open(tdir / "hashes.csv.gz", "rt", newline="") as f:
        rows = [{"graph_id": int(r["graph_id"]), "node_id": int(r["node_id"]),
                 "hash": r["hash"]} for r in csv.DictReader(f)]
    assert rows == _hash_rows(jdir) and rows


def test_preprocess_writes_the_jax_script_files(preprocessed):
    _, want, got = preprocessed
    assert_same_outputs(want, got)


REAL = {
    "bigvul-fixed": ["--dataset", "bigvul", "--split", "fixed"],
    "bigvul-random": ["--dataset", "bigvul"],
    "devign-fixed": ["--dataset", "devign", "--split", "fixed"],
    "diversevul": ["--dataset", "diversevul"],
    "mutated-fixed": ["--dataset", "mutated_rename", "--split", "fixed"],
    "bigvul-joern": ["--dataset", "bigvul", "--split", "fixed",
                     "--frontend", "joern"],
}
_REAL_BUILT: dict = {}


def _real(name: str, tmp_path_factory):
    """Both packages' preprocess over the real-dataset files, built once a
    module."""
    if name not in _REAL_BUILT:
        root = tmp_path_factory.mktemp(name)
        _REAL_BUILT[name] = (root, *_run_both(root, REAL[name]))
    return _REAL_BUILT[name]


@pytest.fixture(scope="module", params=list(REAL))
def real_preprocessed(request, tmp_path_factory):
    return request.param, *_real(request.param, tmp_path_factory)


def test_real_dataset_preprocess_writes_the_jax_script_files(real_preprocessed):
    name, _, want, got = real_preprocessed
    assert_same_outputs(want, got, labels=not name.startswith("devign"))
    assert got["ingest"] if name.startswith("bigvul") else "ingest" not in got
    if name == "bigvul-joern":
        # every export answers with sample.c's graph, whose lines are not
        # the generated functions' removed lines
        assert got["graphs"] > 20 and got["vul_graphs"] == 0
    elif name.startswith(("bigvul", "devign")):
        assert got["vul_graphs"] > 0 and got["graphs"] > 20
    else:
        # DiverseVul and the mutated sets carry no removed lines and are not
        # graph-level: no positive graph in either package (ROADMAP queue C)
        assert got["vul_graphs"] == want["vul_graphs"] == 0 < got["graphs"]
    splits = json.loads((Path(got["out"]) / "splits.json").read_text())
    if "fixed" in name:
        assert sum(map(len, splits.values())) <= got["graphs"]
    assert_graphs_equal(graphs.load_shards(want["out"]),
                        jgraphs.load_shards(got["out"]))


def test_joern_path_writes_content_addressed_sources(tmp_path_factory):
    root, want, got = _real("bigvul-joern", tmp_path_factory)
    for side in ("jax", "port"):
        before = root / side / "processed" / "bigvul" / "before"
        names = sorted(p.name for p in before.glob("*.c"))
        assert names and all("_" in n for n in names)
        assert (root / side / "deepdfa_joern_scripts"
                / "export_func_graph.sc").exists()
        assert sorted(p.name for p in (before.parent / "after").glob("*.c"))
    assert sorted(p.name for p in (root / "port" / "processed" / "bigvul"
                                   / "before").iterdir()) == \
        sorted(p.name for p in (root / "jax" / "processed" / "bigvul"
                                / "before").iterdir())
    assert got["extraction"]["restarts"] == want["extraction"]["restarts"] == 0


def test_each_package_loads_the_others_shards(preprocessed):
    _, want, got = preprocessed
    assert_graphs_equal(graphs.load_shards(want["out"]),
                        jgraphs.load_shards(got["out"]))


def _cfgs(split: str):
    return (ExperimentConfig(data=DataConfig(dsname="demo", split=split)),
            JExp(data=JData(dsname="demo", split=split)))


@pytest.mark.parametrize("split", ["random", f"{FOLD}_holdout"])
def test_load_corpus_equals_jax(preprocessed, split, monkeypatch):
    root, want, _ = preprocessed
    monkeypatch.setenv("DEEPDFA_STORAGE", str(root / "jax"))
    cfg, jcfg = _cfgs(split)
    got, ref = fit_mod.load_corpus(cfg), jcli.load_corpus(jcfg)
    assert list(got) == list(ref)
    for part in got:
        assert_graphs_equal(got[part], ref[part])
    splits = json.loads((Path(want["out"]) / "splits.json").read_text())
    sizes = {k: len(v) for k, v in got.items()}
    if split == "random":
        assert sizes == {k: len(splits[k]) for k in sizes}
    else:  # the holdout fold: project B is the test split
        assert sizes["test"] == N_DEMO - 3 * N_DEMO // 4


def test_load_corpus_leakage_guard_and_synthetic_fallback(preprocessed,
                                                          tmp_path,
                                                          monkeypatch):
    _, want, _ = preprocessed
    shard_dir = tmp_path / "processed" / "demo" / "shards"
    shutil.copytree(want["out"], shard_dir)
    splits = json.loads((shard_dir / "splits.json").read_text())
    splits["val"].append(splits["train"][0])
    (shard_dir / "splits.json").write_text(json.dumps(splits))
    monkeypatch.setenv("DEEPDFA_STORAGE", str(tmp_path))
    cfg, jcfg = _cfgs("random")
    with pytest.raises(ValueError, match="split leakage: train∩val"):
        jcli.load_corpus(jcfg)
    with pytest.raises(ValueError, match="split leakage: train∩val"):
        fit_mod.load_corpus(cfg)
    # a named split that matches no shard graph
    empty = tmp_path / "external" / "splits"
    empty.mkdir(parents=True)
    (empty / "nowhere.csv").write_text(",example_index,split\n0,99999,train")
    for load, c in ((fit_mod.load_corpus, cfg), (jcli.load_corpus, jcfg)):
        with pytest.raises(ValueError, match="matched NONE"):
            load(type(c)(data=type(c.data)(dsname="demo", split="nowhere")))
    # no shards: the synthetic corpus, as the JAX package falls back
    other, jother = (ExperimentConfig(data=DataConfig(dsname="none")),
                     JExp(data=JData(dsname="none")))
    assert {k: [g.gid for g in v] for k, v in
            fit_mod.load_corpus(other).items()} == {
        k: [g.gid for g in v] for k, v in jcli.load_corpus(jother).items()}


def test_split_marker_guard(tmp_path, monkeypatch):
    monkeypatch.setenv("DEEPDFA_STORAGE", str(tmp_path))
    argv = ["--dataset", "demo", "--n", "30", "--workers", "2"]
    assert preprocess.main(argv)["status"] == "ok"
    assert preprocess.main(argv)["status"] == "exists"
    _fold_csvs(tmp_path, 30)
    with pytest.raises(SystemExit, match="built with split 'random'"):
        preprocess.main(argv + ["--split", f"{FOLD}_dataset"])
    out = preprocess.main(argv + ["--split", f"{FOLD}_dataset", "--overwrite"])
    assert out["status"] == "ok"
    assert (Path(out["out"]) / "split.txt").read_text() == f"{FOLD}_dataset"


def test_journal_resumes_after_a_crash_mid_build(tmp_path, monkeypatch):
    argv = ["--dataset", "demo_hard", "--n", "40", "--workers", "2",
            "--shard-size", "8"]
    monkeypatch.setenv("DEEPDFA_STORAGE", str(tmp_path / "straight"))
    straight = preprocess.main(argv)
    monkeypatch.setenv("DEEPDFA_STORAGE", str(tmp_path / "crashed"))
    real_build = CorpusBuilder.build

    def crash(*args, **kwargs):
        raise RuntimeError("killed mid-build")

    monkeypatch.setattr(CorpusBuilder, "build", crash)
    with pytest.raises(RuntimeError, match="killed"):
        preprocess.main(argv)
    monkeypatch.setattr(CorpusBuilder, "build", real_build)
    resumed = preprocess.main(argv)
    ext = resumed["extraction"]
    assert ext["resumed_from_shard"] == ext["extraction_shards"] == 5
    assert ext["extracted"] == 0 and ext["cache_hits"] == 40
    for name in ("shard_00000.npz", "manifest.json", "splits.json",
                 "vocab.json"):
        assert (Path(resumed["out"]) / name).read_bytes() == \
            (Path(straight["out"]) / name).read_bytes()


@pytest.mark.parametrize("argv", [["--dataset", "bigvul"],
                                  ["--dataset", "devign"],
                                  ["--dataset", "mutated_rename"],
                                  ["--frontend", "joern", "--n", "24"]])
def test_the_real_dataset_argvs_build_shards(argv, tmp_path, monkeypatch):
    """The argvs that raised NotImplementedError before the readers were
    ported now build shards."""
    from test_torch_joern import install_fake_joern

    install_fake_joern(tmp_path / "bin")
    monkeypatch.setenv("PATH", f"{tmp_path / 'bin'}{os.pathsep}"
                       f"{os.environ['PATH']}")
    monkeypatch.setenv("DEEPDFA_STORAGE", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    _write_datasets(tmp_path)
    out = preprocess.main(argv + ["--workers", "2"])
    assert out["status"] == "ok" and out["graphs"] > 10
    # truncated Devign functions are failure rows, never a build abort; a
    # mutated set's repeated idx yields one graph
    assert out["cpgs"] + out["failed"] <= out["functions"]
    assert len(graphs.load_shards(out["out"])) == out["graphs"] == out["cpgs"]


# ----------------------------------------------------------- a fit step


@pytest.mark.parametrize("layout", ["segment", "fused"])
def test_one_fit_step_on_a_shard_batch_matches_jax(preprocessed, layout):
    _, _, got = preprocessed
    assert_fit_step_matches_jax(got["out"], layout)


@pytest.mark.parametrize("layout", ["segment", "fused"])
@pytest.mark.parametrize("name", ["bigvul-fixed", "devign-fixed"])
def test_one_fit_step_on_a_shard_batch_matches_jax_on_real_data(
        name, layout, tmp_path_factory):
    """The Big-Vul shards (line labels) and the Devign shards (graph labels
    broadcast to every node)."""
    _, _, got = _real(name, tmp_path_factory)
    assert_fit_step_matches_jax(got["out"], layout)


def assert_fit_step_matches_jax(shard_dir, layout: str):
    small = dict(hidden_dim=8, n_steps=3, num_output_layers=2)
    jcfg = JExp(model=JCfg(**small, layout=layout))
    cfg = ExperimentConfig(model=GGNNConfig(**small, layout=layout))
    input_dim = cfg.input_dim
    train = graphs.load_shards(shard_dir)[:4]
    assert {int(g.node_feats["_VULN"].max()) for g in
            graphs.load_shards(shard_dir)} == {0, 1}
    batch = batch_np(train, 6, 256, 640)
    jmodel = jmake_model(jcfg.model, input_dim)
    jb = jax.tree.map(jnp.asarray, batch)
    params = jmodel.init(jax.random.key(0), jb)["params"]
    pw = 2.0
    jtrainer = jloop.Trainer(jmodel, jcfg, pos_weight=pw)
    jstate = jloop.TrainState(params, jtrainer.optimizer.init(params),
                              jax.random.key(0), jnp.zeros((), jnp.int32))
    jnew, jm, jl, _ = jtrainer.train_step(jstate, jb,
                                          jmetrics.ConfusionState.zeros())

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jb)
        labels, weights = jloop.extract_labels(jb, "graph")
        return jloop.bce_with_logits(logits, labels, weights, pw)

    to_torch = lambda tree: bridge.flax_to_torch(  # noqa: E731
        jax.tree.map(np.asarray, tree), cfg.model, input_dim)
    jgrads = to_torch(jax.grad(loss_fn)(params))
    model = make_model(cfg.model, input_dim, device="cpu")
    model.load_state_dict(to_torch(params))
    trainer = loop.Trainer(model, cfg, pos_weight=pw)
    state, m, loss, _ = trainer.train_step(
        trainer.init_state(), to_device(batch, "cpu"), ConfusionState.zeros())
    np.testing.assert_allclose(float(loss), float(jl), atol=2e-5, rtol=1e-4)
    assert [float(x) for x in m] == [float(x) for x in jm]
    new = to_torch(jnew.params)
    for name, p in model.named_parameters():
        g, jg = p.grad.numpy(), jgrads[name].numpy()
        np.testing.assert_allclose(g, jg, atol=2e-5, rtol=1e-4, err_msg=name)
        diff = np.abs(p.detach().numpy() - new[name].numpy())
        assert diff.max() <= 2 * cfg.optim.lr, name
        assert diff[np.abs(jg) > 1e-6].max(initial=0.0) <= 1e-6, name


def test_frontend_error_is_a_failure_row(tmp_path, monkeypatch):
    """An unparseable function is a ``failed_frontend.txt`` row, never a
    build abort."""
    monkeypatch.setenv("DEEPDFA_STORAGE", str(tmp_path))
    rows = codegen.demo_corpus(12, seed=0)
    rows[3] = dict(rows[3], before="int f( {{{ not C")
    with pytest.raises(FrontendError):
        parse_source(rows[3]["before"])
    cpgs, failures, report = preprocess.extract_streaming(
        rows, tmp_path, workers=2, dataset="demo")
    assert len(cpgs) == 11 and len(failures) == 1
    assert failures[0].startswith("3\tFrontendError")
    assert report["extracted"] == 11
