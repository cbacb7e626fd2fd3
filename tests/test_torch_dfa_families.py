"""The static-analysis feature families and the node-level heads of the
port's GGNN against the JAX package, on the CPU.

- ``GGNN.apply`` across the four label styles × ``concat_all_absdf`` on and
  off × the families on and off (both flags: ``live_out``, ``uninit``,
  ``taint``, ``ireach``, ``itaint``), segment layout: the forward on the
  real rows and every parameter's gradient of a masked loss, with the
  parameters (``embed_dfa_{fam}`` tables included) carried by
  ``bridge.flax_to_torch``;
- the fused layout with node labels and the families against the JAX
  package's ``GGNNFused`` (its Pallas kernel in interpret mode, inside one
  ``jax.jit``);
- the bridge both ways, bit for bit, for a model without pooling and with
  the family tables; the widths (224 with ``dataflow_families`` at hidden
  32, 288 with both flags) and the B1/B2 variant they take (``ffma``);
  ``FeatureConfig``'s flags carried to the model.

Tolerance: atol=2e-5, rtol=1e-4 (as ``tests/test_ggnn_parity.py``): matmul
summation order differs between torch and XLA.
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
from deepdfa_tpu.models.ggnn_fused import GGNNFused as JGGNNFused  # noqa: E402

from deepdfa_tpu_torch import bridge  # noqa: E402
from deepdfa_tpu_torch.config import (ExperimentConfig,  # noqa: E402
                                      FeatureConfig, GGNNConfig, DataConfig)
from deepdfa_tpu_torch.data.graphs import to_device  # noqa: E402
from deepdfa_tpu_torch.models import make_model  # noqa: E402
from deepdfa_tpu_torch.ops import fused_ggnn as tfg  # noqa: E402

ATOL, RTOL = 2e-5, 1e-4
INPUT_DIM = 52
SMALL = dict(hidden_dim=8, n_steps=3, num_output_layers=2)
STYLES = ("graph", "node", "dataflow_solution_in", "dataflow_solution_out")
FAMILIES = dict(dataflow_families=True, interproc_families=True)


def _batch(seed=0):
    graphs = jdataset(6, seed=seed, input_dim=INPUT_DIM, mean_nodes=12,
                      vul_rate=0.5, **FAMILIES)
    rng = np.random.default_rng(seed)
    for g in graphs:
        for key in ("_DF_IN", "_DF_OUT"):
            g.node_feats[key] = rng.integers(0, 2, g.n_nodes).astype(np.int32)
    return jbatch_np(graphs, 8, 256, 640)


def _setup(kw, jcls=JGGNN, layout="segment"):
    jmodel = jcls(cfg=JCfg(**SMALL, **kw), input_dim=INPUT_DIM)
    batch = _batch()
    jb = jax.tree.map(jnp.asarray, batch)
    params = JGGNN(cfg=JCfg(**SMALL, **kw), input_dim=INPUT_DIM).init(
        jax.random.key(0), jb)["params"]
    cfg = GGNNConfig(**SMALL, **kw, layout=layout)
    model = make_model(cfg, INPUT_DIM, device="cpu")
    model.load_state_dict(bridge.flax_to_torch(
        jax.tree.map(np.asarray, params), cfg, INPUT_DIM))
    mask = np.asarray(batch.graph_mask if cfg.label_style == "graph"
                      else batch.node_mask)
    w = (np.random.default_rng(5).standard_normal(mask.shape)
         * mask).astype(np.float32)
    return jmodel, params, batch, jb, cfg, model, mask, w


@pytest.mark.parametrize("families", [False, True])
@pytest.mark.parametrize("concat", [True, False])
@pytest.mark.parametrize("label_style", STYLES)
def test_ggnn_forward_and_gradients_equal_jax(label_style, concat, families):
    kw = dict(label_style=label_style, concat_all_absdf=concat,
              **(FAMILIES if families else {}))
    jmodel, params, batch, jb, cfg, model, mask, w = _setup(kw)

    def jloss(p):
        out = jmodel.apply({"params": p}, jb)
        return jnp.sum(out * w), out

    (_, want), jgrad = jax.value_and_grad(jloss, has_aux=True)(params)
    got = model(to_device(batch, "cpu"))
    (got * torch.from_numpy(w)).sum().backward()
    rows = batch.max_graphs if label_style == "graph" else 256
    assert got.shape == (rows,)
    np.testing.assert_allclose(got.detach().numpy()[mask],
                               np.asarray(want)[mask], atol=ATOL, rtol=RTOL)
    tgrad = bridge.torch_to_flax({k: p.grad for k, p in
                                  model.named_parameters()}, cfg, INPUT_DIM)
    flat_t = jax.tree_util.tree_flatten_with_path(tgrad)[0]
    flat_j = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jgrad))[0]
    assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
    for (path, a), (_, b) in zip(flat_t, flat_j):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL,
                                   err_msg=jax.tree_util.keystr(path))
    if families:
        names = jax.tree_util.keystr
        assert any("embed_dfa_itaint" in names(p) for p, _ in flat_t)


@pytest.mark.parametrize("label_style", ["node", "dataflow_solution_out"])
def test_fused_layout_with_families_equals_jax_fused(label_style):
    """The port's fused model (its plain version on the CPU) against the
    JAX package's ``GGNNFused`` with the Pallas kernel in interpret mode,
    run inside one ``jax.jit``."""
    kw = dict(label_style=label_style, **FAMILIES)
    jmodel, params, batch, jb, cfg, model, mask, _ = _setup(
        kw, jcls=JGGNNFused, layout="fused")
    want = jax.jit(lambda p, b: jmodel.apply({"params": p}, b))(params, jb)
    with torch.inference_mode():
        got = model(to_device(batch, "cpu")).numpy()
    np.testing.assert_allclose(got[mask], np.asarray(want)[mask], atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("label_style", ["graph", "node"])
def test_bridge_round_trips_with_families_bit_for_bit(label_style):
    cfg = GGNNConfig(**SMALL, label_style=label_style, **FAMILIES)
    params = jax.tree.map(np.asarray, JGGNN(
        cfg=JCfg(**SMALL, label_style=label_style, **FAMILIES),
        input_dim=INPUT_DIM).init(jax.random.key(1), jax.tree.map(
            jnp.asarray, _batch()))["params"])
    assert ("pooling" in params) == (label_style == "graph")
    back = bridge.torch_to_flax(bridge.flax_to_torch(params, cfg, INPUT_DIM),
                                cfg, INPUT_DIM)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    model = make_model(cfg, INPUT_DIM, device="cpu", seed=3)
    sd = model.state_dict()
    assert any(k.startswith("pooling.") for k in sd) == (
        label_style == "graph")
    again = bridge.flax_to_torch(bridge.torch_to_flax(sd, cfg, INPUT_DIM),
                                 cfg, INPUT_DIM)
    assert set(again) == set(sd)
    assert all(torch.equal(sd[k], again[k]) for k in sd)


@pytest.mark.parametrize("flags,width", [
    (dict(dataflow_families=True), 224),
    (FAMILIES, 288),
    (dict(interproc_families=True), 192),
])
def test_family_widths_take_the_ffma_kernels(flags, width):
    # the name is the test's since the families ran on B1/B2's FFMA
    # kernels; the tensor-core variant has instances at their widths now
    cfg = GGNNConfig(hidden_dim=32, **flags)
    model = make_model(cfg, 1002, device="cpu")
    assert model.ggnn.out_feats == width
    assert cfg.out_dim == 2 * width
    assert tfg.variant(width) == "wgmma" and tfg.variant(128) == "wgmma"
    jcfg = JCfg(hidden_dim=32, **flags)
    assert jcfg.out_dim == cfg.out_dim


def test_feature_flags_carry_over_to_the_model():
    cfg = ExperimentConfig(data=DataConfig(feature=FeatureConfig(
        dataflow_families=True, interproc_families=True)))
    assert cfg.model.dataflow_families and cfg.model.interproc_families
    plain = ExperimentConfig()
    assert not (plain.model.dataflow_families
                or plain.model.interproc_families)
