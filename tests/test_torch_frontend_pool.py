"""The port's frontend encode pool, its process sessions and the extraction
pool's worker-crash point, against the JAX package's, on the CPU.

Thread-mode and process-mode pools encode bit for bit what the JAX
package's ``encode_source`` encodes (the same vocabularies, carried across
with ``Vocabulary.from_dict``): names, node ids, senders, receivers, gids
and every feature column equal. ``ProcessSession`` runs the same extractor
reference as the JAX package's and answers the same values and the same
item errors. The fault points behave as the JAX package's:
``frontend.worker_crash`` re-queues the in-flight source, completed once
by the survivor (and a pool whose last worker dies degrades the server to
inline encode, never a 5xx); ``frontend.spawn_fail`` is retried by the
supervisor, and quarantines the item when every spawn fails;
``extract.worker_crash`` re-queues the item and the run completes with the
JAX pool's results. A process-mode pool and session never spawn more than
two children at once.
"""

import contextlib
import http.client
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("pycparser")

from deepdfa_tpu.config import FeatureConfig as JFeatureConfig  # noqa: E402
from deepdfa_tpu.cpg.features import add_dependence_edges  # noqa: E402
from deepdfa_tpu.cpg.frontend import parse_source  # noqa: E402
from deepdfa_tpu.data.codegen import demo_corpus  # noqa: E402
from deepdfa_tpu.data.extraction import ExtractionPool as JPool  # noqa: E402
from deepdfa_tpu.data.extraction import ProcessSession as JSession  # noqa: E402
from deepdfa_tpu.data.materialize import CorpusBuilder  # noqa: E402
from deepdfa_tpu.pipeline import encode_source as jencode  # noqa: E402
from deepdfa_tpu.resilience import faults as jfaults  # noqa: E402

from deepdfa_tpu_torch.config import FrontendConfig, ServeConfig  # noqa: E402
from deepdfa_tpu_torch.data.extraction import (  # noqa: E402
    ExtractionItemError, ExtractionPool, ProcessSession)
from deepdfa_tpu_torch.data.vocab import Vocabulary  # noqa: E402
from deepdfa_tpu_torch.pipeline import vocab_content_hash  # noqa: E402
from deepdfa_tpu_torch.resilience import faults  # noqa: E402
from deepdfa_tpu_torch.resilience.retry import RetryPolicy  # noqa: E402
from deepdfa_tpu_torch.resilience.supervisor import (  # noqa: E402
    QuarantinedError)
from deepdfa_tpu_torch.serve import (FrontendPool,  # noqa: E402
                                     FrontendProcessSession, QueueFullError,
                                     ScoringEngine, VocabHashMismatch,
                                     serve_buckets)
from deepdfa_tpu_torch.serve.server import ScoreServer  # noqa: E402


@pytest.fixture(scope="module")
def demo():
    rows = demo_corpus(6, seed=0).to_dict("records")
    cpgs = {int(r["id"]): add_dependence_edges(parse_source(r["before"]))
            for r in rows}
    labels = {int(r["id"]): int(r["vul"]) for r in rows}
    _, jvocabs = CorpusBuilder(JFeatureConfig()).build(
        cpgs, list(cpgs), graph_labels=labels)
    tvocabs = {k: Vocabulary.from_dict(v.to_dict()) for k, v in jvocabs.items()}
    return jvocabs, tvocabs, [r["before"] for r in rows]


def _same_encoding(got, want) -> None:
    assert [f.name for f in got] == [f.name for f in want]
    for x, y in zip(got, want):
        assert x.error == y.error and x.node_ids == y.node_ids
        assert (x.graph is None) == (y.graph is None)
        if x.graph is None:
            continue
        np.testing.assert_array_equal(x.graph.senders, y.graph.senders)
        np.testing.assert_array_equal(x.graph.receivers, y.graph.receivers)
        assert x.graph.gid == y.graph.gid
        assert list(x.graph.node_feats) == list(y.graph.node_feats)
        for k, v in x.graph.node_feats.items():
            assert v.dtype == y.graph.node_feats[k].dtype
            np.testing.assert_array_equal(v, y.graph.node_feats[k])


def _pool(vocabs, mode="thread", workers=2, max_queue=256, **kw):
    kw.setdefault("spawn_policy",
                  RetryPolicy(attempts=2, base_delay=0.0, jitter=0.0))
    kw.setdefault("sleep", lambda _s: None)
    return FrontendPool(vocabs, FrontendConfig(mode=mode, workers=workers,
                                               max_queue=max_queue), **kw)


def _engine(vocabs):
    fn = lambda batch: np.full(batch.max_graphs, 0.5, np.float32)  # noqa: E731
    return ScoringEngine(fn, serve_buckets(4), feat_keys=tuple(vocabs))


@contextlib.contextmanager
def _server(vocabs, mode="thread", workers=2, shard_dir=None):
    srv = ScoreServer(
        _engine(vocabs), vocabs,
        ServeConfig(port=0, max_wait_ms=2.0,
                    frontend=FrontendConfig(mode=mode, workers=workers)),
        vocab_source=shard_dir).start()
    try:
        yield srv
    finally:
        srv.shutdown()


def _post(port, source, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/score", body=json.dumps({"source": source}),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def test_thread_pool_encodes_bit_for_bit_the_jax_encode(demo):
    jv, tv, sources = demo
    pool = _pool(tv, workers=3).start()
    try:
        futs = [pool.submit(src) for src in sources]
        for src, fut in zip(sources, futs):
            _same_encoding(fut.result(timeout=60),
                           jencode(src, jv, keep_cpg=False))
        rep = pool.report()
        assert rep["encoded"] == rep["submitted"] == len(sources)
        assert rep["vocab_hash"] == vocab_content_hash(tv)
        assert pool.alive
    finally:
        pool.stop()
    assert not pool.alive
    with pytest.raises(RuntimeError, match="not accepting"):
        pool.submit(sources[0])
    assert FrontendPool.from_config(tv, FrontendConfig(mode="inline")) is None


def test_process_mode_encodes_bit_for_bit_and_serves_http(demo, tmp_path):
    """Two spawned children load the vocabularies from a shard dir's
    ``vocab.json``; their encodings equal the JAX package's, through the
    pool and through the server."""
    jv, tv, sources = demo
    (tmp_path / "vocab.json").write_text(
        json.dumps({k: v.to_dict() for k, v in tv.items()}))
    with _server(tv, mode="process", workers=2, shard_dir=tmp_path) as srv:
        pool = srv.frontend
        futs = [pool.submit(src) for src in sources]
        for src, fut in zip(sources, futs):
            _same_encoding(fut.result(timeout=120),
                           jencode(src, jv, keep_cpg=False))
        for src in sources[:2]:
            status, body = _post(srv.port, src + "\n// http\n")
            assert status == 200 and body["results"]
        status, body = _post(srv.port, "int broken({{{{")
        assert status == 422 and "ExtractionItemError" in body["error"]
        health = json.loads(_get(srv.port, "/healthz")[1])
        assert health["frontend"] == {"mode": "process", "alive": True}
        rep = pool.report()
        assert rep["alive"] == 2 and rep["encoded"] >= len(sources) + 2
        assert srv.metrics.snapshot()["frontend_inline_total"] == 0


def test_vocab_hash_mismatch_fails_at_start(demo):
    _, tv, _ = demo
    with pytest.raises(VocabHashMismatch, match="divergent"):
        FrontendProcessSession(tv, expect_hash="0" * 16)
    pool = FrontendPool(tv, FrontendConfig(mode="process", workers=2))

    def mismatch(worker_id=0):
        raise VocabHashMismatch("worker hash deadbeef != serving hash")

    pool._factory = mismatch
    with pytest.raises(VocabHashMismatch):
        pool.start()
    assert not pool._prespawned


def test_process_session_equals_jax_on_the_same_extractor():
    ref = "json:loads"
    mine, theirs = ProcessSession(ref), JSession(ref)
    try:
        for payload in ('{"a": [1, 2.5, null]}', "[]", '"x"'):
            assert mine.extract(payload) == theirs.extract(payload)
        errors = []
        for sess in (mine, theirs):
            with pytest.raises(ValueError) as exc:
                sess.extract("{nope")
            errors.append(str(exc.value))
        assert errors[0] == errors[1] and "JSONDecodeError" in errors[0]
        assert mine.extract("[3]") == [3]  # the session outlives the error
    finally:
        mine.close()
        theirs.close()
    with pytest.raises(RuntimeError, match="failed to spawn"):
        ProcessSession("no_such_module_anywhere:fn")


def test_worker_crash_requeues_exactly_once_through_http(demo):
    _, tv, sources = demo
    with _server(tv, workers=2) as srv:
        with faults.installed("frontend.worker_crash@1"):
            for i, src in enumerate(sources):
                status, body = _post(srv.port, src + f"\n// {i}\n")
                assert status == 200 and body["results"], body
        rep = srv.frontend.report()
        assert rep["requeued"] == 1 and len(rep["crashed_workers"]) == 1
        assert rep["alive"] == 1 and rep["encoded"] == rep["submitted"]
        assert not any(int(c) >= 500 for c in
                       srv.metrics.snapshot()["responses_total"])


def test_pool_death_degrades_to_inline_over_http(demo):
    _, tv, sources = demo
    with _server(tv, workers=1) as srv:
        with faults.installed("frontend.worker_crash@1"):
            for i, src in enumerate(sources[:4]):
                status, body = _post(srv.port, src + f"\n// d{i}\n")
                assert status == 200, body
        assert srv.frontend.alive is False
        snap = srv.metrics.snapshot()
        assert snap["frontend_inline_total"] >= 1
        assert not any(int(c) >= 500 for c in snap["responses_total"])
        status, raw = _get(srv.port, "/healthz")
        health = json.loads(raw)
        assert status == 200 and health["status"] == "ok"
        assert health["frontend"] == {"mode": "thread", "alive": False}


def test_spawn_fail_is_retried_then_quarantines(demo):
    _, tv, sources = demo
    with faults.installed("frontend.spawn_fail@1"):
        pool = _pool(tv, workers=1).start()
        try:
            assert pool.submit(sources[0]).result(timeout=60)
        finally:
            pool.stop()
        assert faults.counters()["fires"]["frontend.spawn_fail"] == 1
    with faults.installed("frontend.spawn_fail"):  # every spawn fails
        pool = _pool(tv, workers=1).start()
        try:
            with pytest.raises(QuarantinedError):
                pool.submit(sources[0]).result(timeout=60)
        finally:
            pool.stop()


class _Blocking:
    """An encode session that blocks until released."""

    def __init__(self, entered, release):
        self.entered, self.release = entered, release

    def encode(self, source):
        self.entered.set()
        assert self.release.wait(timeout=30)
        return [source]

    def close(self):
        pass


def test_backpressure_and_stop_without_drain(demo):
    _, tv, _ = demo
    entered, release = threading.Event(), threading.Event()
    pool = _pool(tv, workers=1, max_queue=2)
    pool._factory = lambda worker_id=0: _Blocking(entered, release)
    pool.start()
    try:
        first = pool.submit("a")
        assert entered.wait(timeout=30)  # the worker holds "a"
        queued = [pool.submit("b"), pool.submit("c")]
        with pytest.raises(QueueFullError, match="capacity"):
            pool.submit("d")
        pool.stop(drain=False, timeout=0.0)
        for fut in queued:
            with pytest.raises(RuntimeError, match="shutting down"):
                fut.result(timeout=30)
        release.set()
        assert first.result(timeout=30) == ["a"]
    finally:
        release.set()
        pool.stop()


class _Session:
    def close(self):
        pass


def test_extract_worker_crash_completes_as_the_jax_pool_does():
    items = [(f"k{i}", i) for i in range(12)]
    fn = lambda session, x: x * x  # noqa: E731
    runs = []
    for pool_cls, registry in ((ExtractionPool, faults), (JPool, jfaults)):
        with registry.installed("extract.worker_crash@2"):
            pool = pool_cls(lambda worker_id=0: _Session(), n_workers=3,
                            sleep=lambda _s: None)
            res = pool.run(items, fn)
        rep = pool.report()
        runs.append(([(r.key, r.value, r.error) for r in res],
                     rep["requeued"], len(rep["crashed_workers"]),
                     sorted(rep)))
    assert runs[0] == runs[1]
    assert runs[0][0] == [(f"k{i}", i * i, None) for i in range(12)]
    assert runs[0][1] == 1 and runs[0][2] == 1
    with faults.installed("extract.worker_crash"):  # every worker dies
        res = ExtractionPool(lambda worker_id=0: _Session(), n_workers=2,
                             sleep=lambda _s: None).run(items, fn)
    assert [r.value for r in res] == [i * i for i in range(12)]


def test_item_errors_stay_item_errors(demo):
    _, tv, _ = demo
    pool = _pool(tv, workers=1).start()
    try:
        with pytest.raises(ExtractionItemError):
            pool.submit("int broken({{{{").result(timeout=60)
    finally:
        pool.stop()
