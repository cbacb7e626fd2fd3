"""The port's GGNN and GGNNFused (deepdfa_tpu_torch/models) against the JAX
package's ``GGNN.apply`` and ``GGNNFused.apply`` (the Pallas kernel in
interpret mode) on padded ``batch_np`` batches, with the Flax parameters
carried across by ``deepdfa_tpu_torch.bridge``. Also: the bridge round trip
is bit for bit, the eager ``edges_sorted`` check raises, the port's host
batching equals the JAX package's, the options A3 ported build and run,
and unported layouts raise.

Tolerance: atol=2e-5, rtol=1e-4 (as tests/test_ggnn_parity.py): matmul
summation order differs between torch and XLA.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepdfa_tpu.config import GGNNConfig as JCfg  # noqa: E402
from deepdfa_tpu.data.graphs import batch_np as jbatch_np  # noqa: E402
from deepdfa_tpu.data.synthetic import random_dataset as jdataset  # noqa: E402
from deepdfa_tpu.models.ggnn import GGNN as JGGNN  # noqa: E402
from deepdfa_tpu.models.ggnn_fused import GGNNFused as JGGNNFused  # noqa: E402

from deepdfa_tpu_torch import bridge  # noqa: E402
from deepdfa_tpu_torch.config import GGNNConfig  # noqa: E402
from deepdfa_tpu_torch.data.graphs import batch_np, to_device  # noqa: E402
from deepdfa_tpu_torch.data.synthetic import random_dataset  # noqa: E402
from deepdfa_tpu_torch.models import make_model  # noqa: E402

ATOL, RTOL = 2e-5, 1e-4
INPUT_DIM = 52
SMALL = dict(hidden_dim=8, n_steps=3, num_output_layers=2)


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _batch(seed=0):
    graphs = jdataset(6, seed=seed, input_dim=INPUT_DIM, mean_nodes=12)
    return jbatch_np(graphs, 8, 256, 640)


def _jax_params(concat, seed=0):
    cfg = JCfg(**SMALL, concat_all_absdf=concat)
    model = JGGNN(cfg=cfg, input_dim=INPUT_DIM)
    params = model.init(jax.random.key(seed),
                        jax.tree.map(jnp.asarray, _batch()))["params"]
    return jax.tree.map(np.asarray, params)


def _port(concat, layout, params_np):
    cfg = GGNNConfig(**SMALL, concat_all_absdf=concat, layout=layout)
    model = make_model(cfg, INPUT_DIM, device="cpu")
    model.load_state_dict(bridge.flax_to_torch(params_np, cfg, INPUT_DIM))
    return model.eval()


def _run_port(model, batch):
    with torch.inference_mode():
        logits, gate = model(to_device(batch, "cpu"), return_gate=True)
    return logits.numpy(), gate.numpy()


@pytest.mark.parametrize("layout", ["segment", "fused"])
@pytest.mark.parametrize("concat", [True, False])
def test_port_matches_jax_apply_on_padded_batch(layout, concat):
    params = _jax_params(concat)
    batch = _batch()
    jcfg = JCfg(**SMALL, concat_all_absdf=concat, layout=layout)
    jmodel = (JGGNNFused if layout == "fused" else JGGNN)(
        cfg=jcfg, input_dim=INPUT_DIM)
    want, mods = jmodel.apply({"params": jax.tree.map(jnp.asarray, params)},
                              jax.tree.map(jnp.asarray, batch),
                              mutable=["intermediates"])
    want_gate = mods["intermediates"]["pooling"]["gate_weights"][0]
    got, gate = _run_port(_port(concat, layout, params), batch)
    assert got.shape == (batch.max_graphs,)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(gate, np.asarray(want_gate), atol=ATOL,
                               rtol=RTOL)


def test_segment_and_fused_layouts_agree():
    params = _jax_params(True, seed=3)
    batch = _batch(seed=3)
    seg, _ = _run_port(_port(True, "segment", params), batch)
    fus, _ = _run_port(_port(True, "fused", params), batch)
    np.testing.assert_allclose(fus, seg, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("concat", [True, False])
def test_bridge_round_trips_bit_for_bit(concat):
    params = _jax_params(concat, seed=1)
    cfg = GGNNConfig(**SMALL, concat_all_absdf=concat)
    state = bridge.flax_to_torch(params, cfg, INPUT_DIM)
    back = bridge.torch_to_flax(state, cfg, INPUT_DIM)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    model = make_model(cfg, INPUT_DIM, device="cpu", seed=5)
    sd = model.state_dict()
    again = bridge.flax_to_torch(bridge.torch_to_flax(sd, cfg, INPUT_DIM),
                                 cfg, INPUT_DIM)
    assert set(again) == set(sd)
    assert all(torch.equal(sd[k], again[k]) for k in sd)


@pytest.mark.parametrize("layout", ["segment", "fused"])
def test_eager_edges_sorted_check_raises(layout):
    params = _jax_params(True)
    model = _port(True, layout, params)
    batch = _batch()
    bad = batch._replace(receivers=batch.receivers[::-1].copy())
    with pytest.raises(ValueError, match="not sorted by receiver"):
        _run_port(model, bad)


def test_host_batching_equals_jax_package():
    tg = random_dataset(5, seed=7, input_dim=INPUT_DIM, mean_nodes=9)
    jg = jdataset(5, seed=7, input_dim=INPUT_DIM, mean_nodes=9)
    a, b = batch_np(tg, 6, 128, 256), jbatch_np(jg, 6, 128, 256)
    for field in ("senders", "receivers", "node_gidx", "node_mask",
                  "edge_mask", "graph_mask"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert a.node_feats.keys() == b.node_feats.keys()
    for k in a.node_feats:
        np.testing.assert_array_equal(a.node_feats[k], b.node_feats[k])


def test_unported_layouts_name_their_roadmap_item():
    """Every layout of the JAX package is ported (dense last); a layout
    name outside them is refused."""
    from deepdfa_tpu_torch.config import LAYOUTS

    assert LAYOUTS == ("segment", "fused", "megabatch", "dense")
    assert GGNNConfig(layout="dense").layout == "dense"
    with pytest.raises(ValueError, match="unknown layout"):
        GGNNConfig(layout="sparse")


def test_megabatch_layout_is_ported():
    from deepdfa_tpu_torch.config import LAYOUTS
    from deepdfa_tpu_torch.models.ggnn_megabatch import GGNNMegabatch

    cfg = GGNNConfig(**SMALL, layout="megabatch")
    assert "megabatch" in LAYOUTS
    assert isinstance(make_model(cfg, INPUT_DIM, device="cpu"), GGNNMegabatch)


@pytest.mark.parametrize("kw", [
    dict(interproc_families=True), dict(label_style="node"),
    dict(aggregation="union_simple"), dict(dataflow_families=True),
])
def test_unported_model_options_raise(kw):
    """These options were unported (ROADMAP A3) and now build and run on a
    padded batch that carries the family columns; an unknown value of the
    same field still raises."""
    cfg = dataclasses.replace(GGNNConfig(**SMALL), **kw)
    model = make_model(cfg, INPUT_DIM, device="cpu")
    graphs = jdataset(6, seed=0, input_dim=INPUT_DIM, mean_nodes=12,
                      dataflow_families=True, interproc_families=True)
    batch = jbatch_np(graphs, 8, 256, 640)
    with torch.inference_mode():
        out = model(to_device(batch, "cpu"))
    rows = 256 if cfg.label_style == "node" else 8
    assert out.shape == (rows,) and bool(torch.isfinite(out).all())
    field = next(iter(kw))
    if isinstance(kw[field], str):
        bad = dataclasses.replace(cfg, **{field: "nonsense"})
        with pytest.raises(ValueError, match="nonsense"):
            make_model(bad, INPUT_DIM, device="cpu")


def test_make_model_without_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_model(GGNNConfig(**SMALL), INPUT_DIM)
