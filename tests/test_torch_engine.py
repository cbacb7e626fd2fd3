"""The port's serving path (deepdfa_tpu_torch/serve) against the JAX
package's ``ScoringEngine`` over the same bridged parameters: ``score`` on
every ladder bucket, ``score_packed`` on a mixed window (input order,
over-budget graphs through the ladder, ``OversizeGraphError``), and
``MicroBatcher`` futures. The port runs its fused layout on the CPU (the
kernel's plain version); the JAX side runs its segment layout, whose math
equals the fused layout's (tests/test_torch_models.py holds the port against
the interpret-mode kernel).

Tolerance: atol=2e-5, rtol=1e-4 on probabilities (matmul summation order).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepdfa_tpu.config import GGNNConfig as JCfg  # noqa: E402
from deepdfa_tpu.data.graphs import Graph as JGraph  # noqa: E402
from deepdfa_tpu.data.graphs import batch_np as jbatch_np  # noqa: E402
from deepdfa_tpu.models.ggnn import GGNN as JGGNN  # noqa: E402
from deepdfa_tpu.serve.engine import OversizeGraphError as JOversize  # noqa: E402
from deepdfa_tpu.serve.engine import ScoringEngine as JEngine  # noqa: E402

from deepdfa_tpu_torch import bridge  # noqa: E402
from deepdfa_tpu_torch.config import ALL_SUBKEYS, GGNNConfig  # noqa: E402
from deepdfa_tpu_torch.data.graphs import Graph  # noqa: E402
from deepdfa_tpu_torch.data.synthetic import random_dataset  # noqa: E402
from deepdfa_tpu_torch.models import make_model  # noqa: E402
from deepdfa_tpu_torch.serve import (MicroBatcher, OversizeGraphError,  # noqa: E402
                                     ScoringEngine, mega_bucket, serve_buckets)

ATOL, RTOL = 2e-5, 1e-4
INPUT_DIM = 40
MAX_BATCH = 4
SMALL = dict(hidden_dim=8, n_steps=2, num_output_layers=2)
KEYS = tuple(f"_ABS_DATAFLOW_{sk}" for sk in ALL_SUBKEYS)


def _chain(n, seed):
    """An n-node CFG chain with self-loops and seeded feature ids."""
    rng = np.random.default_rng(seed)
    feats = {k: rng.integers(0, INPUT_DIM, n).astype(np.int32) for k in KEYS}
    return Graph(senders=np.arange(n - 1, dtype=np.int32),
                 receivers=np.arange(1, n, dtype=np.int32),
                 node_feats=feats).with_self_loops()


def _spec(b):
    return dataclasses.astuple(b.spec)


def _jax(g):
    return JGraph(senders=g.senders, receivers=g.receivers,
                  node_feats=g.node_feats)


@pytest.fixture(scope="module")
def engines():
    jcfg = JCfg(**SMALL)
    jmodel = JGGNN(cfg=jcfg, input_dim=INPUT_DIM)
    example = jax.tree.map(jnp.asarray, jbatch_np([_jax(_chain(6, 0))], 2, 16, 64))
    params = jmodel.init(jax.random.key(0), example)["params"]
    jeng = JEngine.from_model(jmodel, params, "graph", feat_keys=KEYS,
                              max_batch=MAX_BATCH, megabatch=True)
    cfg = GGNNConfig(**SMALL, layout="fused")
    state = bridge.flax_to_torch(jax.tree.map(np.asarray, params), cfg,
                                 INPUT_DIM)
    teng = ScoringEngine.from_model(
        make_model(cfg, INPUT_DIM, device="cpu"), state, "graph",
        feat_keys=KEYS, max_batch=MAX_BATCH, megabatch=True, device="cpu")
    return jeng, teng


def _requests():
    small = random_dataset(9, seed=2, input_dim=INPUT_DIM, mean_nodes=14)
    return small + [_chain(300, 1), _chain(700, 2), _chain(2500, 3)]


def test_ladder_and_mega_shapes_match_the_jax_engine(engines):
    jeng, teng = engines
    assert [_spec(b) for b in teng.buckets] == [_spec(b) for b in jeng.buckets]
    assert _spec(teng.mega_bucket) == _spec(jeng.mega_bucket)
    assert teng.buckets == serve_buckets(MAX_BATCH)
    assert teng.mega_bucket == mega_bucket(MAX_BATCH)


def test_score_on_every_ladder_bucket(engines):
    jeng, teng = engines
    reqs = _requests()
    by_bucket = {}
    for g in reqs:
        b = teng.assign_bucket(g)
        assert _spec(jeng.assign_bucket(_jax(g))) == _spec(b)
        by_bucket.setdefault(b, []).append(g)
    assert set(by_bucket) == set(teng.buckets)
    jb = {_spec(b): b for b in jeng.buckets}
    for b, gs in by_bucket.items():
        gs = gs[: b.capacity]
        got = teng.score(gs, b)
        want = jeng.score([_jax(g) for g in gs], jb[_spec(b)])
        assert got.shape == (len(gs),) and np.all(np.isfinite(got))
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_score_packed_mixed_window(engines):
    jeng, teng = engines
    reqs = _requests()
    before = teng.n_dispatches
    got = teng.score_packed(reqs)
    want = jeng.score_packed([_jax(g) for g in reqs])
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # the 11 graphs under the budget fill two mega batches of 8 slots; the
    # 2500-node graph goes through the ladder
    assert teng.n_dispatches - before == 3
    assert teng.last_padding_efficiency == pytest.approx(
        jeng.last_padding_efficiency)
    # input order: each probability is the graph's own
    singles = [teng.score([g], teng.assign_bucket(g))[0] for g in reqs]
    np.testing.assert_allclose(got, singles, atol=ATOL, rtol=RTOL)


def test_oversize_graph_raises_in_both(engines):
    jeng, teng = engines
    big = _chain(5000, 4)
    with pytest.raises(OversizeGraphError, match="5000 nodes"):
        teng.assign_bucket(big)
    with pytest.raises(OversizeGraphError):
        teng.score_packed([_chain(5, 5), big])
    with pytest.raises(JOversize):
        jeng.score_packed([_jax(big)])


def test_micro_batcher_futures_match_the_jax_engine(engines):
    jeng, teng = engines
    reqs = random_dataset(11, seed=8, input_dim=INPUT_DIM, mean_nodes=20)
    batcher = MicroBatcher(teng, max_batch=MAX_BATCH, max_wait_ms=20).start()
    try:
        futures = [batcher.submit(g) for g in reqs]
        got = np.array([f.result(timeout=60) for f in futures], np.float32)
    finally:
        batcher.stop()
    want = np.array([jeng.score([_jax(g)], jeng.assign_bucket(_jax(g)))[0]
                     for g in reqs])
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    with pytest.raises(RuntimeError, match="draining"):
        batcher.submit(reqs[0])


def test_warmup_runs_every_shape_without_counting(engines):
    _, teng = engines
    before = teng.n_dispatches
    report = teng.warmup()
    assert set(report["per_bucket"]) == {"126", "1022", "4094", "mega"}
    assert teng.n_dispatches == before
    assert teng.warm_buckets == [126, 1022, 4094]


def test_model_rev_names_framework_and_state(engines):
    _, teng = engines
    cfg = GGNNConfig(**SMALL, layout="fused")
    a = ScoringEngine.from_model(make_model(cfg, INPUT_DIM, device="cpu",
                                            seed=1), None, device="cpu",
                                 feat_keys=KEYS)
    b = ScoringEngine.from_model(make_model(cfg, INPUT_DIM, device="cpu",
                                            seed=2), None, device="cpu",
                                 feat_keys=KEYS)
    assert a.model_rev != b.model_rev != teng.model_rev
    assert len(a.model_rev) == 16


@pytest.mark.parametrize("kw,match", [(dict(precision="int8"), "A9"),
                                      (dict(mesh=object()), "A11")])
def test_unported_engine_options_raise(kw, match):
    cfg = GGNNConfig(**SMALL, layout="fused")
    with pytest.raises(NotImplementedError, match=match):
        ScoringEngine.from_model(make_model(cfg, INPUT_DIM, device="cpu"),
                                 None, feat_keys=KEYS, device="cpu", **kw)


def test_from_model_without_device_raises_on_a_gpu_less_host():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the default device is usable")
    cfg = GGNNConfig(**SMALL, layout="fused")
    model = make_model(cfg, INPUT_DIM, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ScoringEngine.from_model(model, None, "graph", feat_keys=KEYS)
    assert next(model.parameters()).device.type == "cpu"
