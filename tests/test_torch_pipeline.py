"""The port's encode pipeline against the JAX package's, on the CPU: stage-2
hash strings, vocabularies, encoded graphs and the vocabulary file, fed the
same C source; and the port's extraction machinery (the work-stealing
pool, the supervisor, the content-addressed cache and the encode
sessions).

- ``features_to_hashes`` strings equal byte for byte, row for row;
- ``build_vocab`` (and the per-subkey grid) equal dict for dict, ids and
  key order included, on a corpus built to have many tied counts, across
  limits and ``include_unknown``;
- ``encode_source`` graphs equal bit for bit (senders, receivers, every
  ``node_feats`` array with its dtype, ``gid``, the CFG node order) on all
  ten ``realworld`` fixtures and ``cross_taint.c``;
- a ``vocab.json`` the JAX package wrote loads in the port with an equal
  ``vocab_content_hash``.

No floating point is involved: every comparison is exact.
"""

import json
import pickle
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

pytest.importorskip("torch")
pytest.importorskip("pycparser")

from deepdfa_tpu.config import FeatureConfig as JFeatureConfig  # noqa: E402
from deepdfa_tpu.cpg import features as jfeat  # noqa: E402
from deepdfa_tpu.cpg.frontend import parse_source as jparse  # noqa: E402
from deepdfa_tpu.data import vocab as jvocab  # noqa: E402
from deepdfa_tpu.data.codegen import demo_corpus  # noqa: E402
from deepdfa_tpu.data.extract_cache import ExtractCache as JCache  # noqa: E402
from deepdfa_tpu.data.materialize import CorpusBuilder  # noqa: E402
from deepdfa_tpu.pipeline import encode_source as jencode  # noqa: E402
from deepdfa_tpu.pipeline import vocab_content_hash as jvocab_hash  # noqa: E402

from deepdfa_tpu_torch.config import FeatureConfig  # noqa: E402
from deepdfa_tpu_torch.cpg import features as feat  # noqa: E402
from deepdfa_tpu_torch.cpg.frontend import parse_source  # noqa: E402
from deepdfa_tpu_torch.data import vocab  # noqa: E402
from deepdfa_tpu_torch.data.extract_cache import ExtractCache  # noqa: E402
from deepdfa_tpu_torch.data.extraction import ExtractionPool  # noqa: E402
from deepdfa_tpu_torch.data.materialize import (corpus_hashes,  # noqa: E402
                                                corpus_vocabs, graph_from_cpg)
from deepdfa_tpu_torch.pipeline import (all_subkeys, encode_source,  # noqa: E402
                                        load_vocabs, vocab_content_hash)
from deepdfa_tpu_torch.resilience.retry import (RetryExhausted,  # noqa: E402
                                                RetryPolicy, retry_call)
from deepdfa_tpu_torch.serve.frontend import (ENCODE_ITEM_ERRORS,  # noqa: E402
                                              ThreadEncodeSession,
                                              encode_session_factory)

FIXTURES = Path(__file__).parent / "fixtures"
SOURCES = sorted((FIXTURES / "realworld").glob("*.c")) + [
    FIXTURES / "interproc" / "cross_taint.c"]


@pytest.fixture(scope="module")
def corpus():
    """A seeded demo corpus parsed by each package, the JAX package's hash
    table and its vocabularies over the first 20 functions."""
    rows = demo_corpus(30, seed=0).to_dict("records")
    jcpgs = {int(r["id"]): jfeat.add_dependence_edges(jparse(r["before"]))
             for r in rows}
    tcpgs = {int(r["id"]): feat.add_dependence_edges(parse_source(r["before"]))
             for r in rows}
    builder = CorpusBuilder(JFeatureConfig())
    _, jvocabs = builder.build(jcpgs, list(jcpgs)[:20],
                               graph_labels={k: int(r["vul"]) for k, r in
                                             zip(jcpgs, rows)})
    return tcpgs, jcpgs, builder.hash_df, jvocabs


@pytest.fixture(scope="module")
def vocabs(corpus):
    tcpgs = corpus[0]
    return corpus_vocabs(corpus_hashes(tcpgs, FeatureConfig().subkeys),
                         list(tcpgs)[:20])


def _rows(df):
    return [tuple(r) for r in df.itertuples(index=False, name=None)]


# ------------------------------------------------------------ stage 1 + 2


@pytest.mark.parametrize("subkeys", [None, ("operator", "api"), ("datatype",)])
def test_hash_strings_equal_jax_byte_for_byte(corpus, subkeys):
    tcpgs, jcpgs, _, _ = corpus
    subkeys = subkeys or FeatureConfig().subkeys
    feats_t, feats_j = [], []
    for path in SOURCES:
        feats_t += feat.extract_features(parse_source(path.read_text()), 7)
        feats_j.append(jfeat.extract_features(jparse(path.read_text()), 7))
    for gid in tcpgs:
        feats_t += feat.extract_features(tcpgs[gid], gid)
        feats_j.append(jfeat.extract_features(jcpgs[gid], gid))
    want = jfeat.features_to_hashes(pd.concat(feats_j, ignore_index=True),
                                    subkeys)
    got = feat.features_to_hashes(feats_t, subkeys)
    assert [(r["graph_id"], r["node_id"], r["hash"]) for r in got] == _rows(
        want[["graph_id", "node_id", "hash"]])


def test_feature_rows_equal_jax():
    for path in SOURCES:
        got = feat.extract_features(parse_source(path.read_text()), 3)
        want = jfeat.extract_features(jparse(path.read_text()), 3)
        assert list(want.columns) == list(feat.FEATURE_COLUMNS)
        assert [tuple(r[c] for c in feat.FEATURE_COLUMNS) for r in got] == \
            _rows(want)
    assert feat.features_to_hashes([], ["api"]) == []


# ----------------------------------------------------------- vocabularies


def _tied_hashes(seed: int) -> pd.DataFrame:
    """Definition hashes drawn from small pools, so that many values and
    combined hashes share a count."""
    rng = np.random.default_rng(seed)
    pools = {"api": ["memcpy", "strlen", "read", "free", "malloc"],
             "datatype": ["int", "char *", "size_t", "long"],
             "literal": ["0", "1", "16", "64"],
             "operator": ["addition", "assignment", "lessThan", "cast"]}
    rows = []
    for gid in range(40):
        for nid in range(int(rng.integers(1, 6))):
            h = {sk: sorted(set(rng.choice(pool, size=int(rng.integers(0, 3)))
                                .tolist()))
                 for sk, pool in pools.items()}
            rows.append({"graph_id": gid, "node_id": 1000 + nid,
                         "hash": json.dumps(h)})
    return pd.DataFrame(rows)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("limits", [(1000, 1000), (3, 5), (2, 1), (None, None)])
@pytest.mark.parametrize("include_unknown", [False, True])
def test_build_vocab_equals_jax_on_tied_counts(seed, limits, include_unknown):
    df = _tied_hashes(seed)
    train = list(range(0, 40, 2)) + [39]
    kw = dict(limit_subkeys=limits[0], limit_all=limits[1],
              include_unknown=include_unknown)
    for subkeys in (FeatureConfig().subkeys, ("literal",), ("api", "operator")):
        want = jvocab.build_vocab(df, train, JFeatureConfig(subkeys=subkeys,
                                                             **kw))
        got = vocab.build_vocab(df.to_dict("records"), train,
                                FeatureConfig(subkeys=subkeys, **kw))
        assert list(got.subkey_vocabs) == list(want.subkey_vocabs)
        for sk in got.subkey_vocabs:
            assert list(got.subkey_vocabs[sk].items()) == list(
                want.subkey_vocabs[sk].items())
        assert list(got.all_vocab.items()) == list(want.all_vocab.items())
        assert got.to_dict() == want.to_dict()


def test_corpus_vocabs_equal_jax(corpus, vocabs):
    tcpgs, _, hash_df, jvocabs = corpus
    got = corpus_hashes(tcpgs, FeatureConfig().subkeys)
    assert [(r["graph_id"], r["node_id"], r["hash"]) for r in got] == _rows(
        hash_df[["graph_id", "node_id", "hash"]])
    assert list(vocabs) == list(jvocabs)
    for name in vocabs:
        assert vocabs[name].to_dict() == jvocabs[name].to_dict()
        assert list(vocabs[name].all_vocab.items()) == list(
            jvocabs[name].all_vocab.items())
    assert vocab_content_hash(vocabs) == jvocab_hash(jvocabs)
    assert all_subkeys(vocabs) == FeatureConfig().subkeys


def test_jax_written_vocab_json_loads_with_the_same_hash(corpus, tmp_path):
    jvocabs = corpus[3]
    (tmp_path / "vocab.json").write_text(json.dumps(
        {name: v.to_dict() for name, v in jvocabs.items()}))
    loaded = load_vocabs(tmp_path)
    assert vocab_content_hash(loaded) == jvocab_hash(jvocabs)
    assert {k: v.to_dict() for k, v in loaded.items()} == {
        k: v.to_dict() for k, v in jvocabs.items()}
    (tmp_path / "vocab.json").write_text(json.dumps(
        {"_ABS_DATAFLOW": {"x": 1}}))
    with pytest.raises(ValueError, match="legacy"):
        load_vocabs(tmp_path)


def test_feature_ids_and_dfa_clipping(vocabs):
    voc = vocabs["_ABS_DATAFLOW"]
    assert voc.feature_id(None) == 0
    unknown = json.dumps({"api": ["__never__"], "datatype": [], "literal": [],
                          "operator": []})
    assert voc.feature_id(unknown) == 1
    known = next(iter(voc.all_vocab))
    assert voc.feature_id(known) == voc.all_vocab[known] + 1 >= 2
    assert vocab.encode_nodes([5, 6], {5: known}, voc) == [voc.feature_id(known), 0]
    assert vocab.encode_dfa_nodes([1, 2, 3], {1: 99, 2: -4}, "taint") == [2, 0, 0]


# ---------------------------------------------------------- encode_source


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.stem)
def test_encoded_graphs_equal_jax_bit_for_bit(path, corpus, vocabs):
    jvocabs = corpus[3]
    code = path.read_text()
    got, want = encode_source(code, vocabs), jencode(code, jvocabs)
    assert [f.name for f in got] == [f.name for f in want]
    for a, b in zip(got, want):
        assert a.error == b.error and a.node_ids == b.node_ids
        for name in ("senders", "receivers"):
            x, y = getattr(a.graph, name), getattr(b.graph, name)
            assert x.dtype == y.dtype and np.array_equal(x, y)
        assert a.graph.gid == b.graph.gid
        assert list(a.graph.node_feats) == list(b.graph.node_feats)
        for k, v in b.graph.node_feats.items():
            assert a.graph.node_feats[k].dtype == v.dtype
            np.testing.assert_array_equal(a.graph.node_feats[k], v)
        assert a.cpg.edges == b.cpg.edges
    for backend in ("sets", "bitvec"):
        other = encode_source(code, vocabs, keep_cpg=False, backend=backend)
        for a, b in zip(other, got):
            assert a.cpg is None and a.node_ids == b.node_ids
            np.testing.assert_array_equal(a.graph.senders, b.graph.senders)
            for k, v in b.graph.node_feats.items():
                np.testing.assert_array_equal(a.graph.node_feats[k], v)


def test_graph_from_cpg_labels_and_dataflow_bits():
    from deepdfa_tpu.data.materialize import graph_from_cpg as jgraph

    code = SOURCES[0].read_text()
    cpg = feat.add_dependence_edges(parse_source(code))
    jcpg = jfeat.add_dependence_edges(jparse(code))
    lines = {3, 4}
    got = graph_from_cpg(cpg, 5, {}, vuln_lines=lines, dataflow_labels=True)
    want = jgraph(jcpg, 5, {}, vuln_lines=lines, dataflow_labels=True)
    assert list(got.node_feats) == ["_VULN", "_DF_IN", "_DF_OUT"]
    for k, v in want.node_feats.items():
        np.testing.assert_array_equal(got.node_feats[k], v)
    with pytest.raises(ValueError, match="exactly one"):
        graph_from_cpg(cpg, 5, {})


# ------------------------------------------------------- extraction cache


def test_a_jax_cache_entry_is_a_miss_here(tmp_path):
    code = "int f(void) { return 1; }"
    jcache = JCache(tmp_path, salt="v")
    jcache.put(jcache.key(code), {"jax": 1})
    cache = ExtractCache(tmp_path, salt="v")
    assert cache.key(code) != jcache.key(code)
    assert cache.get(cache.key(code)) is None
    # even under the JAX key, a pickle naming the JAX package is refused
    (tmp_path / "x.pkl").write_bytes(pickle.dumps(JFeatureConfig()))
    import hashlib
    blob = (tmp_path / "x.pkl").read_bytes()
    (tmp_path / "x.json").write_text(json.dumps(
        {"schema": 1, "sha256": hashlib.sha256(blob).hexdigest()}))
    assert cache.get("x") is None
    assert cache.stats()["corrupt"] == 1


def test_cache_round_trips_encoded_functions(tmp_path, vocabs):
    cache = ExtractCache(tmp_path, salt="v")
    code = SOURCES[1].read_text()
    fns = encode_source(code, vocabs)
    cache.put(cache.key(code), fns)
    back = ExtractCache(tmp_path, salt="v").get(cache.key(code))
    assert [f.name for f in back] == [f.name for f in fns]
    np.testing.assert_array_equal(back[0].graph.senders, fns[0].graph.senders)
    assert back[0].cpg.edges == fns[0].cpg.edges
    assert ExtractCache(tmp_path, salt="w").get(
        ExtractCache(tmp_path, salt="w").key(code)) is None


def test_cache_torn_and_corrupt_entries_read_as_miss(tmp_path):
    cache = ExtractCache(tmp_path)
    k = cache.key("code")
    payload, meta = tmp_path / f"{k}.pkl", tmp_path / f"{k}.json"
    payload.write_bytes(pickle.dumps("v"))  # no meta marker: uncommitted
    assert cache.get(k) is None and not meta.exists()
    cache.put(k, "good")
    assert cache.get(k) == "good"
    payload.write_bytes(b"garbage")
    assert cache.get(k) is None
    assert cache.stats()["corrupt"] == 1
    assert cache.stats()["hits"] == 1 and cache.stats()["misses"] == 2


# -------------------------------------------------- pool, supervisor, retry


class _Session:
    def __init__(self, plan=None, delay=0.0):
        self.plan, self.delay = plan or {}, delay

    def extract(self, payload):
        import time
        if self.delay and payload.startswith("s"):
            time.sleep(self.delay)
        out = self.plan.get(payload)
        if isinstance(out, BaseException):
            raise out
        return f"done:{payload}"

    def close(self):
        pass


def _pool(plan=None, delay=0.0, n_workers=3, **kw):
    return ExtractionPool(
        lambda wid: _Session(plan, delay), n_workers=n_workers,
        spawn_policy=RetryPolicy(attempts=2, base_delay=0.0, jitter=0.0),
        sleep=lambda _s: None, **kw)


def test_pool_returns_input_order_and_failure_rows():
    items = [(f"k{i}", f"s{i}" if i % 3 == 0 else f"p{i}") for i in range(24)]
    items += [("bad", "bad"), ("poison", "poison")]
    pool = _pool({"bad": ValueError("malformed"),
                  "poison": TimeoutError("hung")}, delay=0.01, n_workers=3)
    results = pool.run(items, lambda s, p: s.extract(p))
    assert [r.key for r in results] == [k for k, _ in items]
    assert [r.value for r in results[:24]] == [f"done:{p}" for _, p in
                                              items[:24]]
    assert results[24].error == "ValueError: malformed"
    assert results[25].quarantined and results[25].error.startswith(
        "Quarantined:")
    report = pool.report()
    assert report["quarantined"][0]["key"] == "poison"
    assert report["restarts"] >= 1 and report["steals"] >= 1
    assert report["extracted"] == 24


def test_pool_cache_makes_a_warm_run_extract_nothing(tmp_path):
    items = [(f"k{i}", f"code {i}") for i in range(8)]
    cold = _pool(cache=ExtractCache(tmp_path), cache_code=lambda p: p)
    cold.run(items, lambda s, p: s.extract(p))
    warm_cache = ExtractCache(tmp_path)
    warm = _pool(cache=warm_cache, cache_code=lambda p: p)
    results = warm.run(items, lambda s, p: s.extract(p))
    assert warm.report()["extracted"] == 0 and all(r.cache_hit for r in results)
    assert warm_cache.stats()["hit_rate"] == 1.0
    with pytest.raises(ValueError):
        ExtractionPool(lambda: None, n_workers=0)


def test_retry_backoff_is_deterministic_and_bounded():
    from deepdfa_tpu.resilience.retry import RetryPolicy as JPolicy

    policy = RetryPolicy(attempts=4, base_delay=0.5)
    assert [policy.delay(n) for n in (1, 2, 3)] == [
        JPolicy(attempts=4, base_delay=0.5).delay(n) for n in (1, 2, 3)]
    calls, slept = [], []

    def flaky():
        calls.append(1)
        raise OSError("down")

    with pytest.raises(RetryExhausted):
        retry_call(flaky, policy, sleep=slept.append)
    assert len(calls) == 4 and len(slept) == 3


def test_encode_sessions(vocabs):
    session = encode_session_factory(vocabs)(0)
    assert isinstance(session, ThreadEncodeSession)
    fns = session.encode(SOURCES[0].read_text())
    assert fns[0].graph is not None and fns[0].cpg is None
    kept = encode_session_factory(vocabs, keep_cpg=True)(1).encode(
        SOURCES[0].read_text())
    assert kept[0].cpg is not None
    with pytest.raises(ENCODE_ITEM_ERRORS):
        session.encode("int f( { nope")
