"""The port's int8 serving path against the JAX package's, on the CPU: the
calibration (bit for bit), the int8 product (kernel B5's plain version
against the JAX Pallas kernel in interpret mode) and its gradient,
``GGNNInt8`` on a bridged and quantized state, and the engine's int8 gate
(the calibration graphs, the delta and the verdict, the refusals, and a
kernel failure that must not be taken for a refusal).

The same inputs go to both packages: numpy arrays made from a seed, and the
JAX parameters carried across by the bridge.

Tolerances:
- ``calibrate_int8``, ``quantize_conv_params`` and the calibration graphs:
  bit for bit (the same float32 division and round-half-to-even);
- the product: 1e-6 of the largest output (float32 sums in another order);
  with bf16 activations and output, one bf16 ulp of the largest output
  (each rounds its float32 sum to bf16 once);
- its gradient: 1e-6 of the largest entry (both round the same factors to
  bf16 and sum in float32);
- ``GGNNInt8`` logits: atol = rtol = 1e-5 (the megabatch tests' bar);
- the gate's delta: 1e-6 absolute (a difference of two probabilities, each
  within float32 rounding of the JAX package's).
"""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepdfa_tpu.config import GGNNConfig as JCfg  # noqa: E402
from deepdfa_tpu.data.graphs import batch_np as jbatch_np  # noqa: E402
from deepdfa_tpu.data.synthetic import random_dataset as jdataset  # noqa: E402
from deepdfa_tpu.models.ggnn import GGNN as JGGNN  # noqa: E402
from deepdfa_tpu.models.ggnn_int8 import GGNNInt8 as JGGNNInt8  # noqa: E402
from deepdfa_tpu.models.ggnn_int8 import (  # noqa: E402
    quantize_conv_params as jquantize)
from deepdfa_tpu.ops.int8_matmul import calibrate_int8 as jcalibrate  # noqa: E402
from deepdfa_tpu.ops.int8_matmul import int8_matmul as jint8_matmul  # noqa: E402
from deepdfa_tpu.serve import engine as jengine  # noqa: E402

from deepdfa_tpu_torch import bridge  # noqa: E402
from deepdfa_tpu_torch.config import ALL_SUBKEYS, GGNNConfig  # noqa: E402
from deepdfa_tpu_torch.data.graphs import to_device  # noqa: E402
from deepdfa_tpu_torch.data.synthetic import random_dataset  # noqa: E402
from deepdfa_tpu_torch.models import ggnn_int8, make_model  # noqa: E402
from deepdfa_tpu_torch.ops import int8_matmul as tmm  # noqa: E402
from deepdfa_tpu_torch.resilience.journal import RunJournal  # noqa: E402
from deepdfa_tpu_torch.serve import ScoringEngine, serve_buckets  # noqa: E402
from deepdfa_tpu_torch.serve.engine import _calibration_graphs  # noqa: E402

INPUT_DIM = 40
SMALL = dict(hidden_dim=8, n_steps=2, num_output_layers=2)
KEYS = tuple(f"_ABS_DATAFLOW_{sk}" for sk in ALL_SUBKEYS)
MAX_BATCH = 4


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def live():
    """The JAX package's tiny GGNN with seeded parameters, and the same
    parameters as a port state dict."""
    jcfg = JCfg(**SMALL)
    model = JGGNN(cfg=jcfg, input_dim=INPUT_DIM)
    graphs = jdataset(6, seed=0, input_dim=INPUT_DIM, mean_nodes=12)
    example = jax.tree.map(jnp.asarray, jbatch_np(graphs, 8, 256, 640))
    params = model.init(jax.random.key(0), example)["params"]
    cfg = GGNNConfig(**SMALL, layout="fused")
    state = bridge.flax_to_torch(jax.tree.map(np.asarray, params), cfg,
                                 INPUT_DIM)
    return model, params, cfg, state


# -------------------------------------------------------------- calibrate


def _weights():
    rng = np.random.default_rng(0)
    dead = np.zeros((16, 4), np.float32)
    dead[:, 1] = np.linspace(-1, 1, 16)
    # exact halves of a scale of 1 (absmax 127): round half to even
    ties = np.array([[127.0, -127.0], [0.5, -0.5], [1.5, -1.5], [2.5, -2.5],
                     [126.5, -3.5]], np.float32)
    return {
        "normal": rng.normal(size=(64, 48)).astype(np.float32),
        "conv_128x384": (rng.normal(size=(128, 384)) * 0.09).astype(np.float32),
        "zero_columns": dead,
        "all_negative": -np.abs(rng.normal(size=(32, 8))).astype(np.float32)
        - 0.01,
        "ties": ties,
        "tiny": (rng.normal(size=(8, 8)) * 1e-30).astype(np.float32),
    }


@pytest.mark.parametrize("name", sorted(_weights()))
def test_calibrate_int8_is_bitwise_the_jax_calibration(name):
    w = _weights()[name]
    q, scale = tmm.calibrate_int8(w)
    jq, jscale = jcalibrate(w)
    assert q.dtype == np.int8 and scale.dtype == np.float32
    np.testing.assert_array_equal(q, np.asarray(jq))
    np.testing.assert_array_equal(scale.view(np.uint32),
                                  np.asarray(jscale).view(np.uint32))
    if name == "zero_columns":
        assert list(scale[[0, 2, 3]]) == [1.0, 1.0, 1.0]
        assert not q[:, [0, 2, 3]].any()
    if name == "ties":
        assert list(q[:4, 0]) == [127, 0, 2, 2]
        assert list(q[:4, 1]) == [-127, 0, -2, -2]


@pytest.mark.parametrize("poison", [np.nan, np.inf, -np.inf])
def test_calibrate_int8_refuses_non_finite_and_non_2d(poison):
    w = np.ones((8, 8), np.float32)
    w[3, 5] = poison
    with pytest.raises(ValueError, match="non-finite"):
        tmm.calibrate_int8(w)
    with pytest.raises(ValueError, match=r"\[K, N\]"):
        tmm.calibrate_int8(np.ones((4, 4, 4), np.float32))


# ----------------------------------------------------------- B5 product


@pytest.mark.parametrize("m,k,n,bf16", [
    pytest.param(8, 128, 128, False, id="8-128-128"),      # one tile
    pytest.param(300, 128, 384, False, id="300-128-384"),  # the GRU's
    pytest.param(3, 100, 130, False, id="3-100-130"),      # nothing aligned
    pytest.param(1, 256, 127, False, id="1-256-127"),      # one row, odd N
    # bf16 activations and output at decode (the gemv variant's shapes):
    # one token a row, a batch of 4 and 8, ragged K and N tiles
    pytest.param(1, 384, 256, True, id="bf16-1-384-256"),
    pytest.param(4, 256, 400, True, id="bf16-4-256-400"),
    pytest.param(8, 520, 144, True, id="bf16-8-520-144"),
])
def test_int8_matmul_reference_matches_the_jax_kernel(m, k, n, bf16):
    rng = np.random.default_rng(m + k + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    q, scale = tmm.calibrate_int8(rng.normal(size=(k, n)).astype(np.float32))
    out = torch.bfloat16 if bf16 else torch.float32
    xt = torch.from_numpy(x).to(out)
    got = tmm.int8_matmul(xt, torch.from_numpy(q), torch.from_numpy(scale),
                          out_dtype=out)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    want = np.asarray(jint8_matmul(jnp.asarray(x).astype(jdt),
                                   jnp.asarray(q), jnp.asarray(scale),
                                   block_m=128, block_n=128, block_k=128,
                                   out_dtype=jdt, interpret=True)
                      ).astype(np.float32)
    assert got.dtype == out and got.shape == (m, n)
    top = float(np.abs(want).max())
    # float32: the sums in another order; bf16: both round the float32 sum
    # once, so they may differ by one bf16 ulp of the largest output
    limit = 2.0 ** (np.floor(np.log2(top)) - 7) if bf16 else 1e-6 * top
    assert float(np.abs(got.float().numpy() - want).max()) <= limit
    torch.testing.assert_close(
        got, tmm.int8_matmul_reference(xt, torch.from_numpy(q),
                                       torch.from_numpy(scale), out),
        atol=0, rtol=0)


def test_int8_matmul_gradient_is_the_jax_vjp():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    q, scale = tmm.calibrate_int8(
        (rng.normal(size=(64, 96)) * 0.05).astype(np.float32))
    g = rng.normal(size=(2, 5, 96)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tmm.int8_matmul(xt, torch.from_numpy(q), torch.from_numpy(scale))
    assert out.shape == (2, 5, 96)
    (got,) = torch.autograd.grad(out, [xt], torch.from_numpy(g))

    def f(a):
        return jint8_matmul(a, jnp.asarray(q), jnp.asarray(scale),
                            out_dtype=jnp.float32, interpret=True)

    _, vjp = jax.vjp(f, jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    want = np.asarray(want)
    assert float(np.abs(got.numpy() - want).max()) <= 1e-6 * float(
        np.abs(want).max())


def test_int8_matmul_checks_its_arguments():
    x = torch.ones(4, 8)
    q = torch.ones(8, 8, dtype=torch.int8)
    with pytest.raises(TypeError, match="int8"):
        tmm.int8_matmul(x, torch.ones(8, 8), torch.ones(8))
    with pytest.raises(TypeError, match="float32"):
        tmm.int8_matmul(x.to(torch.float16), q, torch.ones(8))
    with pytest.raises(TypeError, match="float32"):
        tmm.int8_matmul(x, q, torch.ones(8), out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="scale"):
        tmm.int8_matmul(x, q, torch.ones(4))
    with pytest.raises(ValueError, match="contraction"):
        tmm.int8_matmul(torch.ones(4, 6), q, torch.ones(8))
    before = tmm.n_launches
    assert tmm.int8_matmul(x, q, torch.ones(8)).shape == (4, 8)
    assert tmm.n_launches == before  # the CPU runs the plain version


# ------------------------------------------------------------- GGNNInt8


def test_quantize_conv_params_is_the_jax_tree(live):
    model, params, cfg, state = live
    qstate = ggnn_int8.quantize_conv_params(state)
    jq = jax.tree.map(np.asarray, jquantize({"params": params})["params"])
    for prefix, path in (("ggnn.edge_linear", ("edge_linear",)),
                         ("ggnn.gru.x_proj", ("gru", "x_proj")),
                         ("ggnn.gru.h_proj", ("gru", "h_proj"))):
        leaf = jq["ggnn"]
        for key in path:
            leaf = leaf[key]
        assert f"{prefix}.weight" not in qstate
        assert qstate[f"{prefix}.q"].dtype == torch.int8
        np.testing.assert_array_equal(qstate[f"{prefix}.q"].numpy(),
                                      leaf["q"])
        np.testing.assert_array_equal(qstate[f"{prefix}.scale"].numpy(),
                                      leaf["scale"])
        np.testing.assert_array_equal(qstate[f"{prefix}.bias"].numpy(),
                                      leaf["bias"])
    passed = {k for k in state if not k.startswith(("ggnn.edge_linear.",
                                                    "ggnn.gru."))}
    assert all(torch.equal(qstate[k], state[k]) for k in passed)
    model8 = ggnn_int8.GGNNInt8(cfg, INPUT_DIM)
    assert set(model8.state_dict()) == set(qstate)
    with pytest.raises(ValueError, match="edge_linear"):
        ggnn_int8.quantize_conv_params({"pooling.gate.weight": torch.ones(1)})


@pytest.mark.parametrize("seed", [1, 2])
def test_ggnn_int8_matches_jax_ggnn_int8(live, seed):
    model, params, cfg, state = live
    batch = jbatch_np(jdataset(6, seed=seed, input_dim=INPUT_DIM,
                               mean_nodes=14), 8, 256, 640)
    qparams = jquantize({"params": params})["params"]
    jmodel = JGGNNInt8(cfg=model.cfg, input_dim=INPUT_DIM)
    want = np.asarray(jmodel.apply({"params": qparams},
                                   jax.tree.map(jnp.asarray, batch)))
    model8 = ggnn_int8.GGNNInt8(cfg, INPUT_DIM).eval()
    model8.load_state_dict(ggnn_int8.quantize_conv_params(state))
    with torch.inference_mode():
        got = model8(to_device(batch, "cpu"))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    with torch.inference_mode():  # plain torch on the CPU: a repeat is equal
        assert torch.equal(got, model8(to_device(batch, "cpu")))


def test_ggnn_int8_refuses_unsorted_edges(live):
    model, params, cfg, state = live
    conv = ggnn_int8.GatedGraphConvInt8(32, 2)
    with pytest.raises(ValueError, match="sorted by receiver"):
        conv(torch.zeros(3, 32), torch.tensor([0, 1]), torch.tensor([2, 0]))
    with pytest.raises(ValueError, match="in_feats"):
        conv(torch.zeros(3, 33), torch.tensor([0]), torch.tensor([0]))


# ------------------------------------------------------------ the gate


def test_calibration_graphs_are_the_jax_graphs():
    buckets = serve_buckets(MAX_BATCH)
    got = _calibration_graphs(KEYS, buckets)
    want = jengine._calibration_graphs(KEYS, jengine.serve_buckets(MAX_BATCH))
    assert len(got) == len(want) == 4 * len(buckets)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.senders, b.senders)
        np.testing.assert_array_equal(a.receivers, b.receivers)
        assert set(a.node_feats) == set(b.node_feats) == set(KEYS)
        for k in KEYS:
            np.testing.assert_array_equal(a.node_feats[k], b.node_feats[k])


def _engines(live, **kw):
    model, params, cfg, state = live
    jeng = jengine.ScoringEngine.from_model(
        model, params, "graph", feat_keys=KEYS, max_batch=MAX_BATCH,
        precision="int8", **kw)
    teng = ScoringEngine.from_model(
        make_model(cfg, INPUT_DIM, device="cpu"), state, "graph",
        feat_keys=KEYS, max_batch=MAX_BATCH, device="cpu", precision="int8",
        **kw)
    return jeng, teng


def test_int8_gate_delta_and_verdict_match_jax(live):
    jeng, teng = _engines(live)
    assert teng.precision == jeng.precision == "int8"
    assert 0.0 < teng.int8_score_delta <= 0.01
    assert abs(teng.int8_score_delta - jeng.int8_score_delta) <= 1e-6
    # the int8 engine scores requests as the JAX int8 engine does
    reqs = random_dataset(MAX_BATCH, seed=8, input_dim=INPUT_DIM,
                          mean_nodes=20)
    b = teng.buckets[0]
    got = teng.score(reqs, b)
    want = jeng.score(reqs, jeng.buckets[0])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_int8_gate_refuses_over_its_limit_in_both(live, tmp_path):
    journal = RunJournal(tmp_path / "journal.json")
    with pytest.warns(UserWarning, match="int8 serving path refused"):
        jeng, teng = _engines(live, int8_max_score_delta=1e-9)
    assert teng.precision == jeng.precision == "f32"
    assert abs(teng.int8_score_delta - jeng.int8_score_delta) <= 1e-6
    with pytest.warns(UserWarning, match="exceeds"):
        _, teng = _engines(live, int8_max_score_delta=1e-9, journal=journal)
    rec = journal.read()
    assert rec["event"] == "int8_gate_refused"
    assert rec["int8_score_delta"] == teng.int8_score_delta
    assert rec["int8_max_score_delta"] == 1e-9


def test_nan_poisoned_state_warns_serves_f32_and_journals(live, tmp_path):
    model, params, cfg, state = live
    bad = dict(state)
    w = bad["ggnn.gru.h_proj.weight"].clone()
    w[3, 5] = float("nan")
    bad["ggnn.gru.h_proj.weight"] = w
    journal = RunJournal(tmp_path / "journal.json")
    with pytest.warns(UserWarning, match="calibration refused"):
        eng = ScoringEngine.from_model(
            make_model(cfg, INPUT_DIM, device="cpu"), bad, "graph",
            feat_keys=KEYS, max_batch=MAX_BATCH, device="cpu",
            precision="int8", journal=journal)
    assert eng.precision == "f32" and eng.int8_score_delta is None
    rec = journal.read()
    assert rec["event"] == "int8_gate_refused"
    assert "non-finite" in rec["reason"]


def test_a_failing_product_propagates_out_of_from_model(live, monkeypatch):
    """The gate refuses a poisoned checkpoint only: a kernel that fails to
    build or launch (RuntimeError) is not taken for a refusal."""
    model, params, cfg, state = live

    def broken(x, q, scale):
        raise RuntimeError("int8_matmul: launch failed: stub (700)")

    monkeypatch.setattr(ggnn_int8, "int8_matmul", broken)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(RuntimeError, match="launch failed"):
            ScoringEngine.from_model(
                make_model(cfg, INPUT_DIM, device="cpu"), state, "graph",
                feat_keys=KEYS, max_batch=MAX_BATCH, device="cpu",
                precision="int8")


def test_int8_engine_with_given_calibration_graphs(live):
    model, params, cfg, state = live
    cal = random_dataset(10, seed=21, input_dim=INPUT_DIM, mean_nodes=30)
    eng = ScoringEngine.from_model(
        make_model(dataclasses.replace(cfg, layout="segment"), INPUT_DIM,
                   device="cpu"), state, "graph", feat_keys=KEYS,
        max_batch=MAX_BATCH, device="cpu", precision="int8",
        calibration_graphs=cal)
    assert eng.precision == "int8" and eng.int8_score_delta <= 0.01
    probs = eng.score(cal[:4], eng.assign_bucket(cal[0]))
    assert probs.shape == (4,) and np.all((probs > 0) & (probs < 1))
