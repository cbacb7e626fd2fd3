"""Node and dataflow-solution labels in the port against the JAX package,
on the CPU.

- ``extract_labels`` for the four label styles (``cut_nodef`` for
  ``dataflow_solution_in``) and the masked BCE on them: exact labels and
  weights, the loss within 1e-6;
- the node undersampling of the loss: every positive kept, padding never,
  and the negatives' keep rate ``factor · n_pos / n_neg`` (the keep mask
  comes from a ``torch.Generator``, so it is held to its rate, not to
  ``jax.random.bernoulli``'s bits; parity runs pass the factor as None);
- ``eval_statements`` and ``eval_statements_list``: equal to the JAX
  package's (exact: integer hits and their means);
- the gradient with respect to ``taps`` (dL/dh_t): atol=2e-5, rtol=1e-4;
- through both command lines on the same demo shards (80 functions, hidden
  8 × 4 subkeys, 3 rounds): a ``node`` ``fit`` (fused layout) →
  ``test`` → ``predict`` → ``scan``, and a ``dataflow_solution_out`` fit
  with ``union_relu`` (segment layout) → ``test``. JAX's ``test`` and
  ``predict`` run on the port's weights carried by
  ``bridge.torch_to_flax``: equal keys, confusion counts and
  ``statement_hit@k`` exact, losses and probabilities within 1e-5 (float32
  sums in another order).
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("pycparser")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepdfa_tpu.config import GGNNConfig as JCfg  # noqa: E402
from deepdfa_tpu.config import load_config as jload_config  # noqa: E402
from deepdfa_tpu.data.graphs import batch_np as jbatch_np  # noqa: E402
from deepdfa_tpu.data.synthetic import random_dataset as jdataset  # noqa: E402
from deepdfa_tpu.models.ggnn import GGNN as JGGNN  # noqa: E402
from deepdfa_tpu.train import checkpoint as jckpt  # noqa: E402
from deepdfa_tpu.train import cli as jcli  # noqa: E402
from deepdfa_tpu.train import loop as jloop  # noqa: E402
from deepdfa_tpu.train import metrics as jmetrics  # noqa: E402

from deepdfa_tpu_torch import bridge, preprocess  # noqa: E402
from deepdfa_tpu_torch.config import GGNNConfig, load_config  # noqa: E402
from deepdfa_tpu_torch.data.graphs import to_device  # noqa: E402
from deepdfa_tpu_torch.models import make_model  # noqa: E402
from deepdfa_tpu_torch.train import cli  # noqa: E402
from deepdfa_tpu_torch.train import loop  # noqa: E402
from deepdfa_tpu_torch.train import metrics  # noqa: E402
from deepdfa_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
REALWORLD = REPO / "tests" / "fixtures" / "realworld"
ATOL, RTOL = 2e-5, 1e-4
INPUT_DIM = 52
SMALL = dict(hidden_dim=8, n_steps=3, num_output_layers=2)
STYLES = ("graph", "node", "dataflow_solution_in", "dataflow_solution_out")
OVERRIDES = {
    "model.hidden_dim": 8, "model.n_steps": 3, "model.num_output_layers": 2,
    "model.label_style": "node", "model.layout": "fused",
    "data.dsname": "demo", "data.split": "random", "data.undersample": None,
    "data.feature.limit_all": 50, "data.feature.limit_subkeys": 50,
    "data.batch.batch_graphs": 16, "optim.max_epochs": 2}
DATAFLOW = OVERRIDES | {"model.label_style": "dataflow_solution_out",
                        "model.aggregation": "union_relu",
                        "model.layout": "segment", "optim.max_epochs": 1}


def _sets(overrides):
    return [a for k, v in overrides.items()
            for a in ("--set", f"{k}={json.dumps(v)}")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small fits (six test workers
    with a thread per core each oversubscribe the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=0):
    graphs = jdataset(6, seed=seed, input_dim=INPUT_DIM, mean_nodes=12,
                      vul_rate=0.5)
    rng = np.random.default_rng(seed)
    for g in graphs:
        for key in ("_DF_IN", "_DF_OUT"):
            g.node_feats[key] = rng.integers(0, 2, g.n_nodes).astype(np.int32)
        # some nodes define nothing: cut_nodef drops them
        g.node_feats["_ABS_DATAFLOW"][rng.random(g.n_nodes) < 0.3] = 0
    return jbatch_np(graphs, 8, 256, 640)


# ------------------------------------------------------------------ labels


@pytest.mark.parametrize("label_style", STYLES)
def test_extract_labels_and_loss_equal_jax(label_style):
    batch = _batch()
    labels, weights = loop.extract_labels(to_device(batch, "cpu"),
                                          label_style)
    jl, jw = jloop.extract_labels(jax.tree.map(jnp.asarray, batch),
                                  label_style)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(weights.numpy(), np.asarray(jw))
    if label_style == "dataflow_solution_in":
        nodef = batch.node_feats["_ABS_DATAFLOW"] == 0
        assert not weights.numpy()[nodef].any()
        assert weights.sum() < batch.node_mask.sum()
    logits = np.random.default_rng(1).standard_normal(labels.shape).astype(
        np.float32)
    got = loop.bce_with_logits(torch.from_numpy(logits), labels, weights, 2.5)
    want = jloop.bce_with_logits(jnp.asarray(logits), jl, jw, 2.5)
    assert float(got) == pytest.approx(float(want), abs=1e-6)


def test_an_unknown_label_style_raises():
    with pytest.raises(NotImplementedError, match="edge"):
        loop.extract_labels(to_device(_batch(), "cpu"), "edge")


@pytest.mark.parametrize("factor", [0.5, 1.0, 3.0])
def test_node_undersampling_keeps_its_rate(factor):
    rng = np.random.default_rng(2)
    n = 200_000
    labels = torch.from_numpy((rng.random(n) < 0.05).astype(np.float32))
    weights = torch.from_numpy((rng.random(n) < 0.9).astype(np.float32))
    kept = loop.node_undersample_weights(torch.Generator().manual_seed(0),
                                         labels, weights, factor)
    pos = (labels > 0) & (weights > 0)
    neg = (labels == 0) & (weights > 0)
    assert bool((kept[pos] == 1).all())
    assert not kept[weights == 0].any()
    p = min(1.0, factor * float(pos.sum()) / float(neg.sum()))
    rate = float(kept[neg].mean())
    # five binomial standard deviations
    assert abs(rate - p) <= 5 * np.sqrt(p * (1 - p) / float(neg.sum())) + 1e-9
    again = loop.node_undersample_weights(torch.Generator().manual_seed(0),
                                          labels, weights, factor)
    assert torch.equal(kept, again)


def test_the_train_step_undersamples_node_labels_only():
    """The Trainer passes the factor through; a graph-label step ignores
    it. Both steps advance the generator by one draw, as before."""
    cfg = load_config(overrides={**{k: v for k, v in OVERRIDES.items()
                                    if k.startswith("model.")},
                                 "model.layout": "segment",
                                 "optim.undersample_node_on_loss_factor": 1.0})
    batch = to_device(_batch(), "cpu")
    model = make_model(cfg.model, INPUT_DIM, device="cpu")
    trainer = loop.Trainer(model, cfg)
    state = trainer.init_state()
    before = state.rng.get_state()
    _, _, _, wsum = trainer.train_step(state, batch,
                                       metrics.ConfusionState.zeros("cpu"))
    n_real = float(batch.node_mask.sum())
    n_pos = float((batch.node_feats["_VULN"] * batch.node_mask).sum())
    assert n_pos <= float(wsum) < n_real
    ref = torch.Generator()
    ref.set_state(before)
    torch.randint(0, 2**62, (1,), generator=ref)
    assert torch.equal(ref.get_state(), state.rng.get_state())


def test_eval_statements_equal_jax():
    rng = np.random.default_rng(3)
    items = []
    for i in range(40):
        n = int(rng.integers(3, 30))
        probs = rng.random(n).astype(np.float32)
        labels = (rng.random(n) < (0.15 if i % 3 else 0.0)).astype(int)
        items.append((probs, labels))
        assert metrics.eval_statements(probs, labels) == \
            jmetrics.eval_statements(probs, labels)
    for kw in ({}, {"vulonly": True}, {"thresh": 0.9}):
        assert metrics.eval_statements_list(items, **kw) == \
            jmetrics.eval_statements_list(items, **kw)
    clean = [it for it in items if not it[1].any()]
    assert metrics.eval_statements_list(clean) == \
        jmetrics.eval_statements_list(clean)


@pytest.mark.parametrize("label_style", ["graph", "node"])
def test_taps_gradient_equals_jax(label_style):
    """``taps[t]`` is added after round t's GRU update: the gradient with
    respect to it is dL/dh_t, the per-step curve the dataflow experiment
    reads. Nonzero taps also move the forward."""
    batch = _batch(seed=1)
    jcfg = JCfg(**SMALL, label_style=label_style)
    jmodel = JGGNN(cfg=jcfg, input_dim=INPUT_DIM)
    jb = jax.tree.map(jnp.asarray, batch)
    params = jmodel.init(jax.random.key(0), jb)["params"]
    cfg = GGNNConfig(**SMALL, label_style=label_style)
    model = make_model(cfg, INPUT_DIM, device="cpu")
    model.load_state_dict(bridge.flax_to_torch(
        jax.tree.map(np.asarray, params), cfg, INPUT_DIM))
    mask = batch.graph_mask if label_style == "graph" else batch.node_mask
    w = (np.random.default_rng(4).standard_normal(mask.shape) * mask).astype(
        np.float32)
    n, hidden = batch.node_mask.shape[0], model.ggnn.out_feats
    taps = (np.random.default_rng(5).standard_normal(
        (cfg.n_steps, n, hidden)) * 0.1).astype(np.float32)

    def jloss(t):
        return jnp.sum(jmodel.apply({"params": params}, jb,
                                    taps=tuple(t)) * w)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(taps)))
    tt = torch.from_numpy(taps).requires_grad_(True)
    (model(to_device(batch, "cpu"), taps=list(tt.unbind(0)))
     * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tt.grad.numpy(), want, atol=ATOL, rtol=RTOL)
    assert np.abs(want).max() > 0
    with torch.no_grad():
        plain = model(to_device(batch, "cpu"))
        zero = model(to_device(batch, "cpu"),
                     taps=[torch.zeros(n, hidden)] * cfg.n_steps)
    assert torch.equal(plain, zero)


def test_the_fused_layout_refuses_taps_as_jax():
    model = make_model(GGNNConfig(**SMALL, layout="fused"), INPUT_DIM,
                       device="cpu")
    with pytest.raises(ValueError, match="segment-layout diagnostic"):
        model(to_device(_batch(), "cpu"), taps=[None] * 3)


# ------------------------------------------------- both command lines


@pytest.fixture(scope="module")
def storage(tmp_path_factory):
    """Demo shards with solver labels (80 functions, vocabularies of 50),
    set as ``DEEPDFA_STORAGE`` for the module."""
    root = tmp_path_factory.mktemp("storage")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DEEPDFA_STORAGE", str(root))
        out = preprocess.main(["--dataset", "demo", "--n", "80", "--workers",
                               "1", "--limit-all", "50", "--limit-subkeys",
                               "50", "--dataflow-labels"])
        assert out["graphs"] == 80
        yield root


@pytest.fixture(scope="module")
def node_run(storage, tmp_path_factory):
    run = tmp_path_factory.mktemp("node_fit")
    final = cli.main(["fit", "--run-dir", str(run), *_sets(OVERRIDES),
                      "--device", "cpu"])
    return run, final


def _jax_checkpoint(run, overrides, tmp_path) -> Path:
    """The run's best weights as a JAX checkpoint."""
    cfg = load_config(overrides=overrides)
    mgr = CheckpointManager(run / "checkpoints")
    tree = bridge.torch_to_flax(mgr.restore(mgr.best_step()), cfg.model,
                                cfg.input_dim)
    jdir = tmp_path / "jax_ckpt"
    jckpt.CheckpointManager(jdir).save(1, {"params": tree},
                                       metrics={"val_loss": 0.0}, epoch=0)
    return jdir


def _assert_test_equal(got, want):
    assert got.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, int) or key.startswith(("report_support",
                                                     "statement_hit")):
            assert got[key] == value, key
        else:
            assert got[key] == pytest.approx(value, abs=1e-5), key


def test_node_fit_test_equals_jax(node_run, tmp_path):
    run, final = node_run
    assert np.isfinite(final["val_loss"])
    got = cli.main(["test", "--run-dir", str(tmp_path / "port"),
                    "--ckpt-dir", str(run / "checkpoints"),
                    *_sets(OVERRIDES), "--device", "cpu"])
    jout = tmp_path / "jax"
    jout.mkdir()
    jcfg = jload_config(overrides=OVERRIDES | {"model.layout": "segment"})
    want = jcli.test(jcfg, jout, _jax_checkpoint(run, OVERRIDES, tmp_path))
    assert [f"statement_hit@{k}" for k in range(1, 11)] == [
        k for k in got if k.startswith("statement_hit")]
    _assert_test_equal(got, want)


def test_node_predict_equals_jax(node_run, tmp_path):
    run, _ = node_run
    got = cli.main(["predict", "--run-dir", str(tmp_path / "port"),
                    "--ckpt-dir", str(run / "checkpoints"), "--source",
                    str(REALWORLD), *_sets(OVERRIDES), "--device", "cpu"])
    jcfg = jload_config(overrides=OVERRIDES)
    (tmp_path / "jax").mkdir()
    want = jcli.predict(jcfg, tmp_path / "jax", [str(REALWORLD)],
                        _jax_checkpoint(run, OVERRIDES, tmp_path))
    assert got["n_scored"] == want["n_scored"] > 0
    for a, b in zip(got["results"], want["results"]):
        assert a.keys() == b.keys()
        if "error" in b:
            assert a == b
            continue
        assert a["saliency"] == b["saliency"] == "node_probability"
        assert a["vulnerable_probability"] == pytest.approx(
            b["vulnerable_probability"], abs=1e-5)
        wa = [s["weight"] for s in a["top_statements"]]
        wb = [s["weight"] for s in b["top_statements"]]
        np.testing.assert_allclose(wa, wb, atol=1e-5, rtol=0)


def test_node_export_and_scan_through_the_cli(storage, node_run, tmp_path):
    """``export`` then ``scan --artifact`` and ``scan --ckpt-dir`` through
    the trainer CLI (the ``serve|scan`` dispatch): one score per function,
    equal between the artifact and the checkpoint engines."""
    run, _ = node_run
    out = cli.main(["export", "--run-dir", str(run), "--device", "cpu"])
    artifact = Path(out["export_dir"])
    assert json.loads((artifact / "manifest.json").read_text())[
        "label_style"] == "node"
    target = str(REALWORLD)
    by_ckpt = cli.main(["scan", target, "--run-dir", str(tmp_path / "c"),
                        "--ckpt-dir", str(run / "checkpoints"), "--workers",
                        "1", *_sets(OVERRIDES), "--device", "cpu"])
    by_art = cli.main(["scan", target, "--run-dir", str(tmp_path / "a"),
                       "--artifact", str(artifact), "--workers", "1",
                       *_sets(OVERRIDES), "--device", "cpu"])
    assert by_ckpt["n_scored"] == by_art["n_scored"] > 0
    for a, b in zip(by_ckpt["results"], by_art["results"]):
        if "vulnerable_probability" in a:
            assert a["vulnerable_probability"] == pytest.approx(
                b["vulnerable_probability"], abs=1e-5)


def test_dataflow_union_relu_fit_and_test_equal_jax(storage, tmp_path):
    run = tmp_path / "df"
    final = cli.main(["fit", "--run-dir", str(run), *_sets(DATAFLOW),
                      "--device", "cpu"])
    assert np.isfinite(final["val_loss"])
    got = cli.main(["test", "--run-dir", str(tmp_path / "port"),
                    "--ckpt-dir", str(run / "checkpoints"),
                    *_sets(DATAFLOW), "--device", "cpu"])
    jout = tmp_path / "jax"
    jout.mkdir()
    want = jcli.test(jload_config(overrides=DATAFLOW), jout,
                     _jax_checkpoint(run, DATAFLOW, tmp_path))
    assert not any(k.startswith("statement_hit") for k in got)
    _assert_test_equal(got, want)


def test_a_node_fit_with_undersampling_resumes_bitwise(storage, node_run,
                                                       tmp_path):
    """The loss's keep masks come from generators seeded by the step's
    draw, whose state the checkpoint keeps: a fit of 1 epoch resumed to 2
    trains the same weights as a straight 2-epoch run, and the factor
    changes what is trained."""
    over = OVERRIDES | {"optim.undersample_node_on_loss_factor": 1.0}
    straight = cli.main(["fit", "--run-dir", str(tmp_path / "a"),
                         *_sets(over), "--device", "cpu"])
    cli.main(["fit", "--run-dir", str(tmp_path / "b"),
              *_sets(over | {"optim.max_epochs": 1}), "--device", "cpu"])
    resumed = cli.main(["fit", "--run-dir", str(tmp_path / "b"),
                        *_sets(over), "--device", "cpu", "--resume"])
    assert resumed == straight
    a = CheckpointManager(tmp_path / "a" / "checkpoints")
    b = CheckpointManager(tmp_path / "b" / "checkpoints")
    pa, pb = a.restore(a.latest_step()), b.restore(b.latest_step())
    assert a.latest_step() == b.latest_step()
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    run, _ = node_run
    plain = CheckpointManager(run / "checkpoints")
    pn = plain.restore(plain.latest_step())
    assert not all(torch.equal(pa[k], pn[k]) for k in pa)
