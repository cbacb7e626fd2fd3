"""The port's int8 training experiment (deepdfa_tpu_torch/train/int8_train.py)
against the JAX package's ``run_int8_train`` on the CPU: the same
megabatch-packed batches (each package's packer over the same synthetic
graphs) and the same float32 parameters (the JAX initialisation carried
across by ``bridge.flax_to_torch``). The JAX side runs its int8 product as
the Pallas kernel in interpret mode, the port's as B5's plain version.

Tolerances:
- the gate's per-bucket deltas: 1e-5 absolute (a difference of two
  probabilities, each within float32 rounding of the JAX package's);
- the verdict and the result keys: equal;
- the loss trace (first and last loss): 1e-4 absolute (Adam from
  gradients that agree to float32 rounding).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepdfa_tpu.config import load_config as jload_config  # noqa: E402
from deepdfa_tpu.data.synthetic import random_dataset as jdataset  # noqa: E402
from deepdfa_tpu.models import make_model as jmake_model  # noqa: E402
from deepdfa_tpu.ops import megabatch as jmb  # noqa: E402
from deepdfa_tpu.train import int8_train as jint8  # noqa: E402

from deepdfa_tpu_torch import bridge  # noqa: E402
from deepdfa_tpu_torch.config import ALL_SUBKEYS, load_config  # noqa: E402
from deepdfa_tpu_torch.data.synthetic import random_dataset  # noqa: E402
from deepdfa_tpu_torch.ops import int8_matmul as i8  # noqa: E402
from deepdfa_tpu_torch.ops import megabatch as mb  # noqa: E402
from deepdfa_tpu_torch.train import int8_train  # noqa: E402

OVERRIDES = {"model.hidden_dim": 8, "model.n_steps": 3,
             "model.num_output_layers": 2, "data.feature.limit_all": 50}
STEPS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small fits: they run as fast
    as on every core, and six test workers with a thread per core each
    oversubscribe the host ten times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pack(mod, graphs, cfg):
    m = cfg.model
    return mod.pack_megabatches(
        graphs, width=m.hidden_dim * len(ALL_SUBKEYS), n_steps=m.n_steps,
        table_rows=cfg.input_dim * len(ALL_SUBKEYS), embed_width=m.hidden_dim,
        n_head_layers=m.num_output_layers, max_batch_graphs=12,
        uniform=True).batches


@pytest.fixture(scope="module")
def both():
    """(port result, JAX result) of the same run, and the port's batches
    and state."""
    cfg, jcfg = load_config(overrides=OVERRIDES), jload_config(
        overrides=OVERRIDES)
    batches = _pack(mb, random_dataset(30, seed=4, input_dim=cfg.input_dim,
                                       vul_rate=0.4), cfg)
    jbatches = _pack(jmb, jdataset(30, seed=4, input_dim=cfg.input_dim,
                                   vul_rate=0.4), jcfg)
    assert len(batches) == len(jbatches) >= 2
    mcfg = dataclasses.replace(jcfg.model, layout="segment", dtype="float32")
    params = jmake_model(mcfg, input_dim=jcfg.input_dim).init(
        jax.random.key(0), jax.tree.map(jnp.asarray, jbatches[0]))["params"]
    state = bridge.flax_to_torch(jax.tree.map(np.asarray, params),
                                 cfg.model, cfg.input_dim)
    got = int8_train.run_int8_train(batches, cfg=cfg, steps=STEPS,
                                    state_dict=state, device="cpu")
    want = jint8.run_int8_train(jbatches, cfg=jcfg, steps=STEPS)
    return got, want, batches, state, cfg


def test_int8_train_equals_jax(both):
    got, want, *_ = both
    assert got.keys() == want.keys()
    assert got["accepted"] == want["accepted"] is True
    assert got["refused_reason"] is want["refused_reason"] is None
    assert got["per_bucket_delta"].keys() == want["per_bucket_delta"].keys()
    for key, delta in want["per_bucket_delta"].items():
        assert abs(got["per_bucket_delta"][key] - delta) <= 1e-5, key
    assert abs(got["int8_score_delta"] - want["int8_score_delta"]) <= 1e-5
    assert got["steps"] == want["steps"] == STEPS
    for key in ("loss_first", "loss_last"):
        assert abs(got[key] - want[key]) <= 1e-4, key
    assert got["loss_decreased"] == want["loss_decreased"]
    assert got["max_score_delta"] == int8_train.DEFAULT_MAX_SCORE_DELTA == \
        jint8.DEFAULT_MAX_SCORE_DELTA


def test_bucket_shape_key_equals_jax(both):
    *_, batches, _, _ = both
    for b in batches:
        assert int8_train.bucket_shape_key(b) == jint8.bucket_shape_key(b)


def test_a_refusal_trains_nothing(both):
    got, _, batches, state, cfg = both
    refused = int8_train.run_int8_train(batches, cfg=cfg, steps=STEPS,
                                        state_dict=state, device="cpu",
                                        max_score_delta=0.0)
    assert refused["accepted"] is False and refused["steps"] == 0
    assert refused["refused_reason"].startswith("max per-bucket score delta")
    assert refused["per_bucket_delta"] == got["per_bucket_delta"]
    assert "loss_first" not in refused


def test_the_conv_stays_frozen_and_the_default_draws_from_the_seed(
        both, monkeypatch):
    """The int8 conv's buffers are not trained (out of the optimizer), the
    rest is; without ``state_dict`` the float32 weights are
    ``make_model(seed=cfg.seed)``'s. The CPU makes no B5 launch."""
    _, _, batches, _, cfg = both
    seen = {}
    real_adam = torch.optim.Adam

    def spy(params, **kw):
        params = list(params)
        seen["n"] = sum(p.numel() for p in params)
        return real_adam(params, **kw)

    monkeypatch.setattr(int8_train.torch.optim, "Adam", spy)
    launches = i8.n_launches
    a = int8_train.run_int8_train(batches, cfg=cfg, steps=2, device="cpu")
    b = int8_train.run_int8_train(batches, cfg=cfg, steps=2, device="cpu")
    assert a == b and a["accepted"]
    assert i8.n_launches == launches
    from deepdfa_tpu_torch.models.ggnn import build
    from deepdfa_tpu_torch.models.ggnn_int8 import GGNNInt8

    model8 = build(GGNNInt8, cfg.model, cfg.input_dim, device="cpu")
    assert seen["n"] == sum(p.numel() for p in model8.parameters())
    assert not any(n.startswith("ggnn.") for n, _ in model8.named_parameters())
