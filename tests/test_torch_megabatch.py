"""The port's megabatch layout (deepdfa_tpu_torch/ops/megabatch.py and
models/ggnn_megabatch.py) against the JAX package's, on the CPU.

The same numpy inputs go to both packages: the packer's bins, the whole
model forward and its gradients (the JAX side runs its Pallas kernel in
interpret mode, the port its plain version), one ``Trainer`` step, and the
construction errors. Also the packer's own invariants, ported from
``tests/test_megabatch.py``.

Tolerances:
- forward logits: atol = rtol = 1e-5 (the JAX test's own bar: the matmuls
  sum in another order than XLA's);
- gradients of ``sum(logits²)``: rtol 1e-4, atol 1e-5 (the JAX test's bar);
- one train step: loss atol 2e-5 / rtol 1e-4, parameters 1e-6 where the
  gradient is above 1e-6 and 2·lr everywhere (as
  ``tests/test_torch_train_loop.py``, which gives the reasons).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepdfa_tpu.config import DataConfig as JData  # noqa: E402
from deepdfa_tpu.config import ExperimentConfig as JExp  # noqa: E402
from deepdfa_tpu.config import FeatureConfig as JFeat  # noqa: E402
from deepdfa_tpu.config import GGNNConfig as JCfg  # noqa: E402
from deepdfa_tpu.data.synthetic import random_dataset as jdataset  # noqa: E402
from deepdfa_tpu.models.ggnn_megabatch import GGNNMegabatch as JMega  # noqa: E402
from deepdfa_tpu.ops import megabatch as jmb  # noqa: E402
from deepdfa_tpu.train import loop as jloop  # noqa: E402
from deepdfa_tpu.train import metrics as jmetrics  # noqa: E402

from deepdfa_tpu_torch import bridge  # noqa: E402
from deepdfa_tpu_torch.config import (ALL_SUBKEYS, DataConfig,  # noqa: E402
                                      ExperimentConfig, FeatureConfig,
                                      GGNNConfig)
from deepdfa_tpu_torch.data.graphs import (GraphBatcher,  # noqa: E402
                                           derive_buckets, to_device)
from deepdfa_tpu_torch.data.synthetic import random_dataset  # noqa: E402
from deepdfa_tpu_torch.models import make_model  # noqa: E402
from deepdfa_tpu_torch.models.ggnn_megabatch import GGNNMegabatch  # noqa: E402
from deepdfa_tpu_torch.ops import megabatch as mb  # noqa: E402
from deepdfa_tpu_torch.serve import ScoringEngine  # noqa: E402
from deepdfa_tpu_torch.train import loop  # noqa: E402
from deepdfa_tpu_torch.train.metrics import ConfusionState  # noqa: E402

INPUT_DIM = 52
SMALL = dict(hidden_dim=8, n_steps=3, num_output_layers=2)
N_SUB = len(ALL_SUBKEYS)
DIMS = dict(width=SMALL["hidden_dim"] * N_SUB, n_steps=SMALL["n_steps"],
            table_rows=INPUT_DIM * N_SUB, embed_width=SMALL["hidden_dim"],
            n_head_layers=SMALL["num_output_layers"])
POS_WEIGHT = 3.0
GRAD_FLOOR = 1e-6
FIELDS = ("senders", "receivers", "node_gidx", "node_mask", "edge_mask",
          "graph_mask")


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _mixed(seed=0, n_small=10, n_mid=4, port=True):
    """Graphs from two size classes, so a packed batch spans buckets."""
    make = random_dataset if port else jdataset
    return (make(n_small, seed=seed, input_dim=INPUT_DIM, mean_nodes=6)
            + make(n_mid, seed=seed + 1, input_dim=INPUT_DIM, mean_nodes=25))


def _pack(graphs, **kw):
    return mb.pack_megabatches(graphs, **{**DIMS, **kw})


def _lift_caps(monkeypatch, cap):
    monkeypatch.setattr(jmb, "VMEM_CAP_BYTES", cap)
    monkeypatch.setattr(mb, "MEGABATCH_CAP_BYTES", cap)


# ----------------------------------------------------------------- packer


@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("seed,max_batch", [(3, 12), (7, 16), (5, 256)])
def test_packer_bins_equal_jax_gid_for_gid(monkeypatch, uniform, seed,
                                           max_batch):
    """With both byte caps lifted only ``max_batch_graphs`` binds, and the
    two packers must make the same bins in the same order."""
    _lift_caps(monkeypatch, 1 << 60)
    kw = dict(max_batch_graphs=max_batch, uniform=uniform)
    got = _pack(_mixed(seed, 40, 12), **kw)
    want = jmb.pack_megabatches(_mixed(seed, 40, 12, port=False),
                                **{**DIMS, **kw})
    assert len(got.batches) == len(want.batches) >= 1
    for a, b in zip(got.batches, want.batches):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
        for k in b.node_feats:
            np.testing.assert_array_equal(a.node_feats[k], b.node_feats[k])
    for p, q in zip(got.plans, want.plans):
        assert (p.max_graphs, p.max_nodes, p.max_edges) == (
            q.max_graphs, q.max_nodes, q.max_edges)
    assert got.efficiency == pytest.approx(want.efficiency)


def test_packer_with_no_room_returns_every_graph_oversize(monkeypatch):
    _lift_caps(monkeypatch, 0)
    got = _pack(random_dataset(12, seed=4, input_dim=INPUT_DIM, mean_nodes=10))
    want = jmb.pack_megabatches(
        jdataset(12, seed=4, input_dim=INPUT_DIM, mean_nodes=10), **DIMS)
    assert not got.batches and not got.plans
    assert [g.gid for g in got.oversize] == [g.gid for g in want.oversize]
    assert len(got.oversize) == 12
    assert got.efficiency == {"nodes": 0.0, "edges": 0.0, "graphs": 0.0}


@pytest.mark.parametrize("mean_nodes,seed", [(8, 0), (30, 1), (70, 2)])
def test_every_packer_emitted_shape_is_classified_exactly(mean_nodes, seed):
    graphs = random_dataset(120, seed=seed, input_dim=INPUT_DIM,
                            mean_nodes=mean_nodes)
    pack = _pack(graphs)
    assert pack.batches and not pack.oversize
    n_packed = 0
    for batch, plan in zip(pack.batches, pack.plans):
        assert plan.fits
        assert mb.megabatch_bytes(plan) <= mb.MEGABATCH_CAP_BYTES
        assert batch.node_mask.shape[0] == plan.max_nodes
        assert batch.senders.shape[0] == plan.max_edges
        assert batch.graph_mask.shape[0] == plan.max_graphs
        real_g = int(np.sum(batch.graph_mask))
        assert real_g == plan.max_graphs - 1
        assert int(np.sum(batch.node_mask)) <= plan.max_nodes - 1
        n_packed += real_g
    assert n_packed == len(graphs)


def test_packer_uniform_mode_one_shape_and_balanced_bins():
    graphs = _mixed(seed=7, n_small=40, n_mid=12)
    pack = _pack(graphs, max_batch_graphs=16, uniform=True)
    assert len(pack.batches) >= 3
    shapes = {(b.graph_mask.shape[0], b.node_mask.shape[0], b.senders.shape[0])
              for b in pack.batches}
    assert len(shapes) == 1
    counts = [int(np.sum(b.graph_mask)) for b in pack.batches]
    assert max(counts) - min(counts) <= 1 and sum(counts) == len(graphs)
    assert pack.plans[0].max_graphs == max(counts) + 1


def test_dispatches_strictly_lower_than_ladder():
    graphs = _mixed(seed=5, n_small=60, n_mid=20)
    ladder = len(list(GraphBatcher(derive_buckets(graphs, 32)).batches(graphs)))
    pack = _pack(graphs)
    assert len(pack.batches) + len(pack.oversize) < ladder


def test_plan_bytes_count_what_the_wrapper_allocates():
    """The admission counts the wrapper's buffers: monotone in every
    dimension, and at the golden serving shape every node-sized buffer."""
    kw = dict(n_steps=5, table_rows=4008, embed_width=32, n_head_layers=3)
    base = mb.MegabatchPlan(33, 5120, 20480, 128, **kw)
    for grown in (dataclasses.replace(base, max_nodes=5121),
                  dataclasses.replace(base, max_edges=20481),
                  dataclasses.replace(base, max_graphs=34),
                  dataclasses.replace(base, width=132)):
        assert mb.megabatch_bytes(grown) > mb.megabatch_bytes(base)
    n, e, d, g = 5120, 20480, 128, 33
    head = 2 * (256 * 256 + 256) + 256 + 1
    weights = d * d + d + 2 * (3 * d * d + 3 * d) + 2 * d + 1 + head
    # the tensor-core variant's change bitmask and repeated-edge flags
    heads, flags = -(-e // 1024), n
    want = (4 * (4 * n * d + n + g + (n + 1) + (g + 1) + heads + flags + 4 * n
                 + 2 * e + n + weights) + n)
    assert mb.megabatch_bytes(base) == want
    assert base.fits
    # the largest training bucket of the synthetic corpus also fits the L2
    assert dataclasses.replace(base, max_nodes=16768, max_edges=35072,
                               max_graphs=257).fits


# ------------------------------------------------------------------ model


def _packed_batch(seed, n_small=10, n_mid=4):
    pack = jmb.pack_megabatches(_mixed(seed, n_small, n_mid, port=False),
                                **DIMS)
    assert len(pack.batches) == 1 and not pack.oversize
    return pack.batches[0]


def _params(batch, seed=0):
    cfg = JCfg(**SMALL, layout="megabatch")
    jmodel = JMega(cfg=cfg, input_dim=INPUT_DIM)
    params = jmodel.init(jax.random.key(seed),
                         jax.tree.map(jnp.asarray, batch))["params"]
    return jmodel, params


def _port(layout, params):
    cfg = GGNNConfig(**SMALL, layout=layout)
    model = make_model(cfg, INPUT_DIM, device="cpu")
    model.load_state_dict(bridge.flax_to_torch(
        jax.tree.map(np.asarray, params), cfg, INPUT_DIM))
    return model


def test_forward_matches_jax_and_the_segment_layout():
    batch = _packed_batch(6)
    jmodel, params = _params(batch)
    want = np.asarray(jmodel.apply({"params": params},
                                   jax.tree.map(jnp.asarray, batch)))
    tb = to_device(batch, "cpu")
    with torch.inference_mode():
        got = _port("megabatch", params)(tb).numpy()
        seg = _port("segment", params)(tb).numpy()
    assert got.shape == (batch.max_graphs,)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, seg, atol=1e-5, rtol=1e-5)


def test_gradients_match_jax_and_the_segment_layout():
    batch = _packed_batch(8, n_small=6, n_mid=2)
    jmodel, params = _params(batch)
    jb = jax.tree.map(jnp.asarray, batch)
    jgrads = bridge.flax_to_torch(jax.tree.map(np.asarray, jax.grad(
        lambda p: jnp.sum(jmodel.apply({"params": p}, jb) ** 2))(params)),
        GGNNConfig(**SMALL), INPUT_DIM)
    tb = to_device(batch, "cpu")
    grads = {}
    for layout in ("megabatch", "segment"):
        model = _port(layout, params)
        torch.sum(model(tb) ** 2).backward()
        grads[layout] = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert grads["megabatch"].keys() == jgrads.keys()
    for k, want in jgrads.items():
        for layout in ("megabatch", "segment"):
            np.testing.assert_allclose(grads[layout][k], want.numpy(),
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=f"{layout} {k}")


def test_one_train_step_matches_jax_trainer():
    jcfg = JExp(model=JCfg(**SMALL, layout="megabatch"),
                data=JData(feature=JFeat(limit_all=INPUT_DIM - 2)))
    cfg = ExperimentConfig(model=GGNNConfig(**SMALL, layout="megabatch"),
                           data=DataConfig(feature=FeatureConfig(
                               limit_all=INPUT_DIM - 2)))
    graphs = jdataset(8, seed=2, input_dim=INPUT_DIM, mean_nodes=12,
                      vul_rate=0.4)
    batch = jmb.pack_megabatches(graphs, **DIMS).batches[0]
    jmodel, params = _params(batch)
    jtrainer = jloop.Trainer(jmodel, jcfg, pos_weight=POS_WEIGHT)
    jb = jax.tree.map(jnp.asarray, batch)
    assert jtrainer.steps_for(jb)[0] is jtrainer.train_step
    jstate = jloop.TrainState(params, jtrainer.optimizer.init(params),
                              jax.random.key(0), jnp.zeros((), jnp.int32))
    jnew, jm, jl, _ = jtrainer.train_step(jstate, jb,
                                          jmetrics.ConfusionState.zeros())

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jb)
        labels, weights = jloop.extract_labels(jb, "graph")
        return jloop.bce_with_logits(logits, labels, weights, POS_WEIGHT)

    to_t = lambda tree: bridge.flax_to_torch(jax.tree.map(np.asarray, tree),
                                             cfg.model, INPUT_DIM)
    jgrads = to_t(jax.grad(loss_fn)(params))
    model = _port("megabatch", params)
    trainer = loop.Trainer(model, cfg, pos_weight=POS_WEIGHT)
    state = trainer.init_state()
    state, m, loss, w = trainer.train_step(state, to_device(batch, "cpu"),
                                           ConfusionState.zeros())
    assert state.step == 1 and float(w) == 8
    np.testing.assert_allclose(float(loss), float(jl), atol=2e-5, rtol=1e-4)
    assert [float(x) for x in m] == [float(x) for x in jm]
    new, lr = to_t(jnew.params), cfg.optim.lr
    for name, p in model.named_parameters():
        jg = jgrads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), jg, atol=2e-5, rtol=1e-4,
                                   err_msg=name)
        diff = np.abs(p.detach().numpy() - new[name].numpy())
        assert diff.max() <= 2 * lr, name
        assert diff[np.abs(jg) > GRAD_FLOOR].max(initial=0.0) <= 1e-6, name


# ----------------------------------------------------------------- errors


def test_make_model_dispatches_megabatch_and_refuses_variants():
    cfg = GGNNConfig(**SMALL, layout="megabatch")
    model = make_model(cfg, INPUT_DIM, device="cpu")
    assert isinstance(model, GGNNMegabatch)
    # one state dict serves every layout
    seg = make_model(dataclasses.replace(cfg, layout="segment"), INPUT_DIM,
                     device="cpu")
    assert model.state_dict().keys() == seg.state_dict().keys()
    plan = model.plan_for(256, 640, 8)
    assert (plan.width, plan.table_rows, plan.embed_width,
            plan.n_head_layers) == (32, 4 * INPUT_DIM, 8, 2)
    for bad, match in [
        (dict(aggregation="union_relu"), "sum"),
        (dict(label_style="node"), "graph-level"),
        (dict(encoder_mode=True), "graph-level"),
        (dict(dataflow_families=True), "concat-subkey"),
        (dict(interproc_families=True), "concat-subkey"),
        (dict(concat_all_absdf=False), "concat-subkey"),
    ]:
        with pytest.raises(ValueError, match=match):
            GGNNMegabatch(dataclasses.replace(cfg, **bad), INPUT_DIM)


def test_gate_weights_and_serving_raise_clearly():
    cfg = GGNNConfig(**SMALL, layout="megabatch")
    model = make_model(cfg, INPUT_DIM, device="cpu")
    batch = to_device(_packed_batch(9, n_small=4, n_mid=0), "cpu")
    with pytest.raises(ValueError, match="gate weights"):
        model(batch, return_gate=True)
    with pytest.raises(ValueError, match="layout='fused'"):
        ScoringEngine.from_model(model, None, "graph", device="cpu")
    # the same state dict serves through the fused layout
    fused = make_model(dataclasses.replace(cfg, layout="fused"), INPUT_DIM,
                       device="cpu")
    fused.load_state_dict(model.state_dict())
    with torch.inference_mode():
        np.testing.assert_allclose(fused(batch).numpy(), model(batch).numpy(),
                                   atol=1e-5, rtol=1e-5)


def test_model_op_refuses_mismatched_embed_width():
    d = 12
    z = lambda *s: torch.zeros(s)
    args = (z(20, 5), torch.zeros(4, 2, dtype=torch.int64),
            torch.zeros(3, dtype=torch.int32), torch.zeros(3, dtype=torch.int32),
            torch.zeros(4, dtype=torch.int32), torch.ones(4, dtype=torch.bool),
            z(d, d), z(d), z(d, 3 * d), z(3 * d), z(d, 3 * d), z(3 * d),
            z(2 * d, 1), z(1), ((z(2 * d, 1), z(1)),))
    with pytest.raises(ValueError, match="concat-subkey"):
        mb.fused_ggnn_model(*args, n_steps=1, n_graphs=2)
