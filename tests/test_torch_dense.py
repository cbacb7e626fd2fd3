"""The port's dense graph layout (``deepdfa_tpu_torch/data/dense.py``,
``models/ggnn_dense.py`` and its trainer path) against the JAX package's
on the CPU.

- ``batch_dense``, ``derive_dense_size``, ``derive_dense_sizes`` (the
  optimal split and the legacy quantiles), ``DenseBatcher`` (several
  sizes, the oversize routes, ``limit_per_size``) and ``occupancy`` on the
  same seeded graphs: arrays byte for byte, sizes and counters equal;
- ``GGNNDense`` against the JAX ``GGNNDense`` on the parameters
  ``bridge.flax_to_torch`` carries, for the three aggregations and the
  node labels: the forward and every parameter's gradient of ``Σ w ·
  logits`` against ``jax.grad``; encoder mode's pooled rows;
- the dense forward against the port's segment forward of the same
  parameters (through ``train.loop.segment_twin``), duplicate edges
  included; ``union_simple``'s exact zero at saturation;
- ``fit`` through ``cli.main`` with ``layout=dense``: the segment twin
  scores the overflow, ``final_metrics.json``'s keys are the JAX
  ``fit``'s on the same shards and config, a 1+1-epoch resume is bitwise
  the 2-epoch run, and ``test`` of the checkpoint equals the JAX ``test``
  in the dense layout.

Tolerances: batches and sizes exact; forward and gradients atol = rtol =
1e-5 (float32 sums in other orders); dense against segment 1e-4
(the JAX package's own bar, ``tests/test_ggnn_dense.py``); ``test``'s
counts exact, its losses and curves within 1e-5; resumes bitwise.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepdfa_tpu.config import GGNNConfig as JCfg  # noqa: E402
from deepdfa_tpu.config import load_config as jload_config  # noqa: E402
from deepdfa_tpu.data import dense as jdense  # noqa: E402
from deepdfa_tpu.data.synthetic import random_dataset as jdataset  # noqa: E402
from deepdfa_tpu.models.ggnn_dense import GGNNDense as JDense  # noqa: E402
from deepdfa_tpu.train import checkpoint as jckpt  # noqa: E402
from deepdfa_tpu.train import cli as jcli  # noqa: E402

from deepdfa_tpu_torch import bridge, preprocess  # noqa: E402
from deepdfa_tpu_torch.config import GGNNConfig, load_config  # noqa: E402
from deepdfa_tpu_torch.data import dense as tdense  # noqa: E402
from deepdfa_tpu_torch.data.graphs import Graph, batch_np, to_device  # noqa: E402
from deepdfa_tpu_torch.models import make_model  # noqa: E402
from deepdfa_tpu_torch.models.ggnn_dense import GatedGraphConvDense  # noqa: E402
from deepdfa_tpu_torch.ops.union import segment_union_simple  # noqa: E402
from deepdfa_tpu_torch.train import cli  # noqa: E402
from deepdfa_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from deepdfa_tpu_torch.train.loop import segment_twin  # noqa: E402

ATOL, RTOL = 1e-5, 1e-5
DENSE_VS_SEGMENT = 1e-4
INPUT_DIM = 52
SMALL = dict(hidden_dim=8, n_steps=3, num_output_layers=2)
AGGREGATIONS = ("sum", "union_relu", "union_simple")


def _graphs(n=6, seed=0, **kw):
    """Seeded graphs of the JAX generator, and the same graphs as the
    port's ``Graph``."""
    jg = jdataset(n, seed=seed, input_dim=INPUT_DIM, mean_nodes=12, **kw)
    return jg, [Graph(g.senders, g.receivers, dict(g.node_feats), g.gid)
                for g in jg]


def _assert_batches_equal(a, b):
    assert type(a).__name__ == type(b).__name__ == "DenseBatch"
    assert a.node_feats.keys() == b.node_feats.keys()
    for k in a.node_feats:
        assert a.node_feats[k].dtype == b.node_feats[k].dtype, k
        np.testing.assert_array_equal(a.node_feats[k], b.node_feats[k])
    for name in ("adj", "node_mask", "graph_mask"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert x.tobytes() == y.tobytes(), name


# ------------------------------------------------------------------ data


@pytest.mark.parametrize("families", [False, True])
def test_batch_dense_is_the_jax_batch(families):
    kw = dict(dataflow_families=True, interproc_families=True) \
        if families else {}
    jg, tg = _graphs(7, seed=3, **kw)
    # a duplicate edge accumulates in the count matrix
    for gs in (jg, tg):
        gs[0].senders = np.concatenate([gs[0].senders, gs[0].senders[:2]])
        gs[0].receivers = np.concatenate([gs[0].receivers,
                                          gs[0].receivers[:2]])
    n = max(g.n_nodes for g in tg) + 3
    _assert_batches_equal(tdense.batch_dense(tg, 9, n),
                          jdense.batch_dense(jg, 9, n))
    with pytest.raises(ValueError, match="nodes_per_graph"):
        tdense.batch_dense(tg, 9, 2)


def test_dense_sizes_are_the_jax_sizes():
    jg = jdataset(300, seed=5, input_dim=INPUT_DIM, mean_nodes=30)
    tg = [Graph(g.senders, g.receivers, g.node_feats, g.gid) for g in jg]
    for q in (0.5, 0.9, 0.99, 1.0):
        assert tdense.derive_dense_size(tg, q) == \
            jdense.derive_dense_size(jg, q)
    for k in (1, 2, 3, 6, 9):
        assert tdense.derive_dense_sizes(tg, k=k) == \
            jdense.derive_dense_sizes(jg, k=k), k
    assert tdense.derive_dense_sizes(tg, quantiles=(0.5, 0.99)) == \
        jdense.derive_dense_sizes(jg, quantiles=(0.5, 0.99))
    assert tdense.derive_dense_sizes(tg[:1]) == jdense.derive_dense_sizes(jg[:1])
    with pytest.raises(ValueError, match="empty corpus"):
        tdense.derive_dense_sizes([])


@pytest.mark.parametrize("route", ["collect", "drop", "raise", "limit"])
def test_dense_batcher_is_the_jax_batcher(route):
    jg = jdataset(60, seed=9, input_dim=INPUT_DIM, mean_nodes=14)
    tg = [Graph(g.senders, g.receivers, g.node_feats, g.gid) for g in jg]
    sizes = jdense.derive_dense_sizes(jg, k=3, oversize_quantile=0.9)
    kw = {"collect": dict(drop_oversize=False, collect_oversize=True),
          "drop": dict(drop_oversize=True),
          "raise": dict(drop_oversize=False),
          "limit": dict(drop_oversize=True)}[route]
    tb = tdense.DenseBatcher(8, sizes, **kw)
    jb = jdense.DenseBatcher(8, sizes, **kw)
    limit = 1 if route == "limit" else None
    if route == "raise":
        with pytest.raises(ValueError, match="exceeds the largest"):
            list(tb.batches(tg))
        return
    got, want = list(tb.batches(tg, limit)), list(jb.batches(jg, limit))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        _assert_batches_equal(a, b)
    assert tb.n_dropped == jb.n_dropped
    assert [g.gid for g in tb.oversize_graphs] == \
        [g.gid for g in jb.oversize_graphs]
    assert tb.occupancy(got) == jb.occupancy(want)


# ----------------------------------------------------------------- model


def _parity(kw, seed=0, encoder=False):
    """(port, JAX) outputs and parameter gradients of ``Σ w · out`` of
    the dense model on the JAX initial parameters, and the batch."""
    jg, tg = _graphs(6, seed=seed)
    n = max(g.n_nodes for g in tg)
    tb = tdense.batch_dense(tg, 7, n)
    jb = jax.tree.map(jnp.asarray, jdense.batch_dense(jg, 7, n))
    jcfg = JCfg(**SMALL, **kw, encoder_mode=encoder)
    jmodel = JDense(cfg=jcfg, input_dim=INPUT_DIM)
    params = jmodel.init(jax.random.key(seed), jb)["params"]
    cfg = GGNNConfig(**SMALL, **kw, encoder_mode=encoder, layout="dense")
    model = make_model(cfg, INPUT_DIM, device="cpu")
    model.load_state_dict(bridge.flax_to_torch(
        jax.tree.map(np.asarray, params), cfg, INPUT_DIM))
    mask = tb.graph_mask if cfg.label_style == "graph" else tb.node_mask
    shape = mask.shape + ((cfg.out_dim,) if encoder else ())
    w = np.random.default_rng(seed + 7).standard_normal(shape)
    w = (w * mask.reshape(mask.shape + (1,) * (len(shape) - mask.ndim))
         ).astype(np.float32)

    def jloss(p):
        out = jmodel.apply({"params": p}, jb)
        return jnp.sum(out * w), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(params)
    out = model(to_device(tb, "cpu"))
    (out * torch.from_numpy(w)).sum().backward()
    tgrad = bridge.torch_to_flax({k: p.grad for k, p in
                                  model.named_parameters()}, cfg, INPUT_DIM)
    return (out.detach().numpy(), np.asarray(jout), tgrad,
            jax.tree.map(np.asarray, jgrad), mask, model, tg)


def _assert_trees_close(a, b):
    flat_a = jax.tree_util.tree_flatten_with_path(a)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(b)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, x), (_, y) in zip(flat_a, flat_b):
        np.testing.assert_allclose(x, y, atol=ATOL, rtol=RTOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("aggregation", AGGREGATIONS)
@pytest.mark.parametrize("label_style", ["graph", "node"])
def test_ggnn_dense_forward_and_gradients_equal_jax(aggregation,
                                                    label_style):
    got, want, tgrad, jgrad, mask, _, _ = _parity(
        dict(aggregation=aggregation, label_style=label_style))
    np.testing.assert_allclose(got[mask], want[mask], atol=ATOL, rtol=RTOL)
    _assert_trees_close(tgrad, jgrad)


def test_encoder_mode_equals_jax():
    got, want, tgrad, jgrad, mask, _, _ = _parity({}, seed=2, encoder=True)
    assert got.shape == want.shape == (7, GGNNConfig(**SMALL).out_dim)
    np.testing.assert_allclose(got[mask], want[mask], atol=ATOL, rtol=RTOL)
    _assert_trees_close(tgrad, jgrad)


@pytest.mark.parametrize("aggregation", AGGREGATIONS)
def test_dense_equals_the_segment_twin(aggregation):
    """The dense forward against the segment forward of the SAME parameter
    tensors (``segment_twin`` shares them), on a multigraph."""
    _, tg = _graphs(5, seed=4)
    g = tg[0]
    g.senders = np.concatenate([g.senders, g.senders[:3]])
    g.receivers = np.concatenate([g.receivers, g.receivers[:3]])
    order = np.argsort(g.receivers, kind="stable")
    g.senders, g.receivers = g.senders[order], g.receivers[order]
    cfg = GGNNConfig(**SMALL, aggregation=aggregation, layout="dense")
    model = make_model(cfg, INPUT_DIM, device="cpu", seed=3)
    twin = segment_twin(model)
    assert all(a is b for a, b in zip(twin.parameters(), model.parameters()))
    n = max(x.n_nodes for x in tg)
    dense = model(to_device(tdense.batch_dense(tg, 5, n), "cpu"))
    seg = twin(to_device(batch_np(tg, 6, 512, 1024), "cpu"))
    np.testing.assert_allclose(dense.detach().numpy(),
                               seg.detach().numpy()[:5],
                               atol=DENSE_VS_SEGMENT, rtol=DENSE_VS_SEGMENT)
    with pytest.raises(TypeError, match="DenseBatch"):
        model(to_device(batch_np(tg, 6, 512, 1024), "cpu"))


def test_union_simple_saturation_is_an_exact_zero():
    """A saturated message (σ(m) == 1) zeroes the union's product exactly:
    the flushed log-space product equals the segment fold bit for bit."""
    conv = GatedGraphConvDense(4, 1, aggregation="union_simple")
    with torch.no_grad():
        conv.edge_linear.weight.copy_(torch.eye(4))
        conv.edge_linear.bias.zero_()
    h = torch.full((1, 2, 4), 40.0)
    assert float(torch.sigmoid(h)[0, 0, 0]) == 1.0
    adj = torch.zeros(1, 2, 2)
    adj[0, 0, 1] = 1.0
    seen = {}

    def keep_agg(mod, args):
        seen["agg"] = args[0].detach().clone()

    conv.gru.register_forward_pre_hook(keep_agg)
    out = conv(h, adj)
    assert torch.isfinite(out).all()
    seg = segment_union_simple(torch.sigmoid(h[0]), torch.sigmoid(h[0]),
                               torch.tensor([0]), torch.tensor([1]))
    assert torch.equal(seen["agg"][0, 1], seg[1])
    assert torch.equal(seen["agg"][0, 1], torch.ones(4))


# ------------------------------------------------------------ trainer


OVERRIDES = {
    "model.hidden_dim": 8, "model.n_steps": 2, "model.num_output_layers": 2,
    "model.layout": "dense", "data.dsname": "demo", "data.split": "random",
    "data.undersample": None, "data.feature.limit_all": 50,
    "data.feature.limit_subkeys": 50, "data.batch.batch_graphs": 16,
    # a per-graph cap of 256 / 16 = 16 nodes: the demo functions' larger
    # graphs go to the overflow bucket and the segment twin
    "data.batch.max_nodes": 256, "data.batch.auto_buckets": False,
    "optim.max_epochs": 2}
SETS = [a for k, v in OVERRIDES.items()
        for a in ("--set", f"{k}={json.dumps(v)}")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def storage(tmp_path_factory):
    """Demo shards (60 functions, vocabularies of 50) as the module's
    ``DEEPDFA_STORAGE``."""
    root = tmp_path_factory.mktemp("storage")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DEEPDFA_STORAGE", str(root))
        out = preprocess.main(["--dataset", "demo", "--n", "60", "--workers",
                               "1", "--limit-all", "50", "--limit-subkeys",
                               "50"])
        assert out["graphs"] == 60
        yield root


@pytest.fixture(scope="module")
def straight(storage, tmp_path_factory):
    run = tmp_path_factory.mktemp("dense_straight")
    final = cli.main(["fit", "--run-dir", str(run), *SETS, "--device", "cpu"])
    return run, final


def _latest(run_dir) -> dict:
    mgr = CheckpointManager(Path(run_dir) / "checkpoints")
    return mgr.restore(mgr.latest_step())


def test_dense_fit_routes_the_overflow_to_the_segment_twin(straight):
    run, final = straight
    assert json.loads((run / "final_metrics.json").read_text()) == final
    assert final["n_oversize_fallback_train"] > 0
    assert final["n_oversize_fallback_val"] >= 0
    assert final["n_dropped_train"] == final["n_dropped_val"] == 0
    assert final["resharded"] == 0
    assert all(np.isfinite(v) for v in final.values())
    meta = json.loads(next((run / "checkpoints").glob("*/meta.json"))
                      .read_text())
    assert meta["mesh"] == {"devices": 1, "platform": "cpu", "axes": None}
    assert json.loads((run / "journal.json").read_text())["mesh"] == \
        meta["mesh"]


def test_dense_fit_metrics_keys_equal_jax(storage, straight, tmp_path):
    _, final = straight
    jcfg = jload_config(overrides=OVERRIDES | {"optim.max_epochs": 1})
    want = jcli.fit(jcfg, tmp_path / "jax")
    assert final.keys() == want.keys()
    assert final["n_oversize_fallback_train"] == \
        want["n_oversize_fallback_train"]


def test_dense_fit_resume_is_bitwise(straight, tmp_path):
    run, final = straight
    half = tmp_path / "half"
    cli.main(["fit", "--run-dir", str(half), *SETS, "--device", "cpu",
              "--set", "optim.max_epochs=1"])
    resumed = cli.main(["fit", "--run-dir", str(half), *SETS, "--device",
                        "cpu", "--resume"])
    a, b = _latest(run), _latest(half)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert resumed == final


def test_dense_test_command_equals_jax(straight, tmp_path):
    """``test`` of the dense checkpoint: the dense batches and the segment
    twin's overflow, against the JAX ``test`` in the dense layout."""
    run, _ = straight
    got = cli.main(["test", "--run-dir", str(tmp_path / "port"),
                    "--ckpt-dir", str(run / "checkpoints"), *SETS,
                    "--device", "cpu"])
    cfg = load_config(overrides=OVERRIDES)
    mgr = CheckpointManager(run / "checkpoints")
    tree = bridge.torch_to_flax(mgr.restore(mgr.best_step()), cfg.model,
                                cfg.input_dim)
    jdir = tmp_path / "jax_ckpt"
    jckpt.CheckpointManager(jdir).save(1, {"params": tree},
                                       metrics={"val_loss": 0.0}, epoch=0)
    jout = tmp_path / "jax"
    jout.mkdir()
    want = jcli.test(jload_config(overrides=OVERRIDES), jout, jdir)
    assert got.keys() == want.keys()
    assert got["n_graphs_scored"] == want["n_graphs_scored"] > 0
    assert got["n_oversize_fallback"] == want["n_oversize_fallback"] > 0
    for key, value in want.items():
        if isinstance(value, int) or key.startswith("report_support"):
            assert got[key] == value, key
        else:
            assert got[key] == pytest.approx(value, abs=1e-5), key


def test_a_dense_checkpoint_tests_like_a_segment_one(straight, tmp_path):
    """Checkpoints interchange between layouts: the dense run's checkpoint
    tested in the segment layout gives the dense layout's metrics."""
    run, _ = straight
    argv = ["test", "--ckpt-dir", str(run / "checkpoints"), *SETS,
            "--device", "cpu"]
    dense = cli.main(argv + ["--run-dir", str(tmp_path / "d")])
    seg = cli.main(argv + ["--run-dir", str(tmp_path / "s"), "--set",
                           "model.layout=\"segment\""])
    assert dense["n_graphs_scored"] == seg["n_graphs_scored"]
    for key, value in seg.items():
        if key.startswith("n_"):
            continue
        assert dense[key] == pytest.approx(value, abs=1e-5), key
    assert seg["n_oversize_fallback"] == 0 < dense["n_oversize_fallback"]


def test_dense_config_and_model_defaults():
    cfg = GGNNConfig(layout="dense")
    model = make_model(dataclasses.replace(cfg, hidden_dim=4), 20,
                       device="cpu")
    assert type(model).__name__ == "GGNNDense"
    with pytest.raises(ValueError, match="segment-layout diagnostic"):
        model(None, taps=[])


def test_a_dense_checkpoint_predicts_and_exports_in_the_fused_layout(
        storage, straight, tmp_path):
    """``predict`` and ``export`` of the dense run load its checkpoint into
    the fused layout (the serving layout); the exported program scores as
    the dense forward of the same parameters."""
    run, _ = straight
    realworld = Path(__file__).resolve().parent / "fixtures" / "realworld"
    report = cli.main(["predict", "--run-dir", str(tmp_path / "p"),
                       "--ckpt-dir", str(run / "checkpoints"), "--source",
                       str(realworld), *SETS, "--device", "cpu"])
    assert report["n_scored"] > 0 and not report["n_errors"]
    out = cli.main(["export", "--run-dir", str(tmp_path / "x"),
                    "--ckpt-dir", str(run / "checkpoints"), *SETS,
                    "--device", "cpu"])
    manifest = json.loads((Path(out["export_dir"]) / "manifest.json")
                          .read_text())
    assert manifest["layout"] == "fused"
    from deepdfa_tpu_torch.serving import load_exported

    servable = load_exported(out["export_dir"], device="cpu")
    cfg = load_config(overrides=OVERRIDES)
    graphs = [g for g in cli.load_corpus(cfg)["test"]
              if g.n_nodes <= 16][:4]
    leaves = manifest["input_leaves"]
    batch = batch_np(graphs, int(leaves[-1]["shape"][0]),
                     int(leaves[-3]["shape"][0]), int(leaves[-2]["shape"][0]))
    got = np.asarray(servable(batch))[:len(graphs)]
    model = make_model(cfg.model, cfg.input_dim, device="cpu")
    mgr = CheckpointManager(run / "checkpoints")
    model.load_state_dict(mgr.restore(mgr.best_step()))
    with torch.no_grad():
        want = torch.sigmoid(model(to_device(tdense.batch_dense(
            graphs, len(graphs), 16), "cpu"))).numpy()
    np.testing.assert_allclose(got, want, atol=DENSE_VS_SEGMENT, rtol=0)
