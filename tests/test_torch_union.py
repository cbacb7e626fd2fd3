"""The union aggregators and ``segment_mean`` of the port
(``deepdfa_tpu_torch/ops/union.py``, ``ops/segment.py``) and the GGNN that
aggregates with them, against the JAX package on the CPU.

- ``simple_union``, ``relu_union``, ``segment_union_simple`` and
  ``segment_union_relu`` against ``deepdfa_tpu.ops.union`` on seeded
  inputs in [0, 1], exact zeros and empty segments included; the closed
  forms against the sequential fold of the pairwise union;
- ``segment_mean`` (masked and not) against ``deepdfa_tpu.ops.segment``;
- ``GGNN`` with ``aggregation="union_simple"`` / ``"union_relu"`` (segment
  layout) across the label styles: the forward and every parameter's
  gradient of a masked loss, against ``GGNN.apply`` and ``jax.grad`` on the
  parameters ``bridge.flax_to_torch`` carries;
- the fused and int8 layouts refuse the unions with the JAX messages.

Tolerances: the elementwise unions and ``segment_mean`` within 1e-6 (one
float32 sum in another order at most); the closed forms against the fold
within 1e-5 (the product goes through ``exp(Σ log)``); the model's forward
and gradients at atol=2e-5, rtol=1e-4, as ``tests/test_ggnn_parity.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepdfa_tpu.config import GGNNConfig as JCfg  # noqa: E402
from deepdfa_tpu.data.graphs import batch_np as jbatch_np  # noqa: E402
from deepdfa_tpu.data.synthetic import random_dataset as jdataset  # noqa: E402
from deepdfa_tpu.models.ggnn import GGNN as JGGNN  # noqa: E402
from deepdfa_tpu.ops import segment as jseg  # noqa: E402
from deepdfa_tpu.ops import union as junion  # noqa: E402

from deepdfa_tpu_torch import bridge  # noqa: E402
from deepdfa_tpu_torch.config import GGNNConfig  # noqa: E402
from deepdfa_tpu_torch.data.graphs import to_device  # noqa: E402
from deepdfa_tpu_torch.models import make_model  # noqa: E402
from deepdfa_tpu_torch.ops import segment as tseg  # noqa: E402
from deepdfa_tpu_torch.ops import union as tunion  # noqa: E402

ATOL, RTOL = 2e-5, 1e-4
OP_TOL = 1e-6
INPUT_DIM = 52
SMALL = dict(hidden_dim=8, n_steps=3, num_output_layers=2)
UNIONS = ("union_simple", "union_relu")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _edges(rng, n, e):
    """Receiver-sorted edges among the first ``n - 2`` nodes, so the last
    two nodes have no incoming edge (empty segments)."""
    rcv = np.sort(rng.integers(0, n - 2, e)).astype(np.int32)
    snd = rng.integers(0, n, e).astype(np.int32)
    return snd, rcv


def _unit(rng, *shape):
    x = rng.random(shape).astype(np.float32)
    x[rng.random(shape) < 0.05] = 0.0  # exact zeros
    x[rng.random(shape) < 0.05] = 1.0  # saturated bits
    return x


@pytest.mark.parametrize("fn", ["simple_union", "relu_union"])
def test_pairwise_unions_equal_jax(fn):
    rng = np.random.default_rng(0)
    a, b = _unit(rng, 64, 8), _unit(rng, 64, 8)
    got = getattr(tunion, fn)(_t(a), _t(b)).numpy()
    want = np.asarray(getattr(junion, fn)(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, atol=OP_TOL, rtol=0)


@pytest.mark.parametrize("fn", ["segment_union_simple", "segment_union_relu"])
@pytest.mark.parametrize("seed", [0, 1])
def test_segment_unions_equal_jax(fn, seed):
    rng = np.random.default_rng(seed)
    n, e, d = 40, 150, 6
    h, msg = _unit(rng, n, d), _unit(rng, n, d)
    snd, rcv = _edges(rng, n, e)
    got = getattr(tunion, fn)(_t(h), _t(msg), _t(snd), _t(rcv)).numpy()
    want = np.asarray(getattr(junion, fn)(
        jnp.asarray(h), jnp.asarray(msg), jnp.asarray(snd), jnp.asarray(rcv),
        indices_are_sorted=True))
    np.testing.assert_allclose(got, want, atol=OP_TOL, rtol=0)
    # a node with no incoming edge keeps its own state
    np.testing.assert_allclose(got[-2:], h[-2:], atol=OP_TOL, rtol=0)


@pytest.mark.parametrize("kind", ["simple", "relu"])
def test_closed_forms_equal_the_sequential_fold(kind):
    """The reference folds the pairwise union over a node's mailbox, starting
    from the node's own state; the closed forms must give the same bits."""
    rng = np.random.default_rng(2)
    n, e, d = 30, 90, 5
    h = _unit(rng, n, d)
    msg = _unit(rng, n, d) * (0.4 if kind == "relu" else 1.0)
    snd, rcv = _edges(rng, n, e)
    pair = getattr(tunion, f"{kind}_union")
    closed = getattr(tunion, f"segment_union_{kind}")(
        _t(h), _t(msg), _t(snd), _t(rcv)).numpy()
    fold = torch.from_numpy(h.copy())
    for s, r in zip(snd, rcv):
        fold[r] = pair(fold[r], _t(msg[s]))
    np.testing.assert_allclose(closed, fold.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_segment_mean_equals_jax(masked):
    rng = np.random.default_rng(3)
    data = rng.standard_normal((50, 4)).astype(np.float32)
    ids = np.sort(rng.integers(0, 9, 50)).astype(np.int32)  # 9, 10: empty
    mask = rng.random(50) < 0.7 if masked else None
    got = tseg.segment_mean(_t(data), _t(ids), 11,
                            mask=None if mask is None else _t(mask)).numpy()
    want = np.asarray(jseg.segment_mean(
        jnp.asarray(data), jnp.asarray(ids), 11,
        mask=None if mask is None else jnp.asarray(mask),
        indices_are_sorted=True))
    np.testing.assert_allclose(got, want, atol=OP_TOL, rtol=0)
    assert not got[9:].any()


def _batch(seed=0):
    graphs = jdataset(6, seed=seed, input_dim=INPUT_DIM, mean_nodes=12,
                      vul_rate=0.5)
    rng = np.random.default_rng(seed)
    for g in graphs:  # solver bits for the dataflow-solution styles
        for key in ("_DF_IN", "_DF_OUT"):
            g.node_feats[key] = rng.integers(0, 2, g.n_nodes).astype(np.int32)
    return jbatch_np(graphs, 8, 256, 640)


def _row_weights(batch, label_style, seed=5):
    """Seeded loss weights over the real rows (padding rows weigh 0: their
    logits differ between the two packages' padding arithmetic only in
    rows nobody reads)."""
    mask = batch.graph_mask if label_style == "graph" else batch.node_mask
    w = np.random.default_rng(seed).standard_normal(mask.shape)
    return (w * mask).astype(np.float32)


def parity(kw, batch, taps_seed=None):
    """(port, JAX) forward and parameter gradients of ``Σ w · logits`` on
    the JAX package's initial parameters; with ``taps_seed``, also the
    gradient with respect to seeded (nonzero) taps."""
    jcfg = JCfg(**SMALL, **kw)
    jmodel = JGGNN(cfg=jcfg, input_dim=INPUT_DIM)
    jb = jax.tree.map(jnp.asarray, batch)
    params = jmodel.init(jax.random.key(0), jb)["params"]
    cfg = GGNNConfig(**SMALL, **kw)
    model = make_model(cfg, INPUT_DIM, device="cpu")
    model.load_state_dict(bridge.flax_to_torch(
        jax.tree.map(np.asarray, params), cfg, INPUT_DIM))
    w = _row_weights(batch, cfg.label_style)
    taps = None
    if taps_seed is not None:
        hidden = model.ggnn.out_feats
        taps = (np.random.default_rng(taps_seed).standard_normal(
            (cfg.n_steps, batch.node_mask.shape[0], hidden)) * 0.1
        ).astype(np.float32)

    def jloss(p, jt):
        out = jmodel.apply({"params": p}, jb,
                           taps=None if jt is None else tuple(jt))
        return jnp.sum(out * w), out

    (_, jout), (jgrad, jtap_grad) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        params, None if taps is None else jnp.asarray(taps))
    ttaps = None if taps is None else _t(taps).requires_grad_(True)
    out = model(to_device(batch, "cpu"),
                taps=None if ttaps is None else list(ttaps.unbind(0)))
    (out * _t(w)).sum().backward()
    tgrad = bridge.torch_to_flax({k: p.grad for k, p in
                                  model.named_parameters()}, cfg, INPUT_DIM)
    return {"out": (out.detach().numpy(), np.asarray(jout)),
            "grads": (tgrad, jax.tree.map(np.asarray, jgrad)),
            "taps": (None if ttaps is None else ttaps.grad.numpy(),
                     None if jtap_grad is None else np.asarray(jtap_grad)),
            "mask": np.asarray(batch.graph_mask if cfg.label_style == "graph"
                               else batch.node_mask)}


def assert_parity(res):
    got, want = res["out"]
    m = res["mask"]
    np.testing.assert_allclose(got[m], want[m], atol=ATOL, rtol=RTOL)
    tgrad, jgrad = res["grads"]
    flat_t = jax.tree_util.tree_flatten_with_path(tgrad)[0]
    flat_j = jax.tree_util.tree_flatten_with_path(jgrad)[0]
    assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
    for (path, a), (_, b) in zip(flat_t, flat_j):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("aggregation", UNIONS)
@pytest.mark.parametrize("label_style", ["graph", "node",
                                         "dataflow_solution_out"])
def test_union_ggnn_forward_and_gradients_equal_jax(aggregation, label_style):
    assert_parity(parity(dict(aggregation=aggregation,
                              label_style=label_style), _batch()))


@pytest.mark.parametrize("aggregation", UNIONS)
def test_union_ggnn_with_families_and_one_table_equals_jax(aggregation):
    graphs = jdataset(6, seed=4, input_dim=INPUT_DIM, mean_nodes=12,
                      dataflow_families=True, interproc_families=True)
    batch = jbatch_np(graphs, 8, 256, 640)
    assert_parity(parity(dict(aggregation=aggregation, label_style="node",
                              concat_all_absdf=False, dataflow_families=True,
                              interproc_families=True), batch))


def test_unknown_aggregation_raises():
    cfg = GGNNConfig(**SMALL, aggregation="union")
    with pytest.raises(ValueError, match="unknown aggregation"):
        make_model(cfg, INPUT_DIM, device="cpu")


@pytest.mark.parametrize("layout,match", [
    ("fused", "layout=fused supports aggregation='sum' only"),
    ("megabatch", "layout=megabatch supports aggregation='sum' only")])
def test_kernel_layouts_refuse_the_unions_as_jax(layout, match):
    for aggregation in UNIONS:
        cfg = GGNNConfig(**SMALL, aggregation=aggregation, layout=layout)
        with pytest.raises(ValueError, match=match.replace("(", r"\(")):
            make_model(cfg, INPUT_DIM, device="cpu")


def test_int8_conv_refuses_the_unions_and_taps():
    from deepdfa_tpu_torch.models.ggnn_int8 import GGNNInt8

    with pytest.raises(ValueError, match="precision=int8 supports"):
        GGNNInt8(GGNNConfig(**SMALL, aggregation="union_relu"), INPUT_DIM)
    model = GGNNInt8(GGNNConfig(**SMALL), INPUT_DIM)
    batch = to_device(_batch(), "cpu")
    with pytest.raises(ValueError, match="per-step taps"):
        model(batch, taps=[None] * 3)


def test_union_reruns_are_bitwise_equal():
    """The unions reduce through the ordered segment sum: a rerun of the
    forward and backward gives the same bits."""
    batch = _batch(seed=7)
    runs = [parity(dict(aggregation="union_simple", label_style="node"),
                   batch) for _ in range(2)]
    a, b = (r["out"][0] for r in runs)
    assert np.array_equal(a, b)
    for x, y in zip(jax.tree.leaves(runs[0]["grads"][0]),
                    jax.tree.leaves(runs[1]["grads"][0])):
        assert np.array_equal(x, y)

