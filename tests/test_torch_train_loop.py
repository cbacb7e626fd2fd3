"""The port's trainer (deepdfa_tpu_torch/train/loop.py and metrics.py)
against the JAX package's ``make_train_step``, ``Trainer`` and loss and
metric functions, from the same Flax parameters carried across by
``deepdfa_tpu_torch.bridge`` and on the same ``batch_np`` batches, for the
segment and fused layouts (the JAX fused layout runs its Pallas kernels in
interpret mode). Also: the in-step non-finite guard.

Tolerances:
- loss and gradients: atol=2e-5, rtol=1e-4 (as tests/test_ggnn_parity.py):
  the matmuls sum in another order than XLA's;
- parameters after one AdamW step: 1e-6 where the gradient is above
  ``GRAD_FLOOR``. Adam's first step moves a parameter by lr·g/(|g| + eps),
  so where g is at rounding level (the pooling gate's bias, whose true
  gradient is 0) the two sides may move it by up to lr in opposite
  directions: there the limit is 2·lr. From identical gradients the two
  optimizers agree to 1e-6 everywhere (a thousandth of a step of lr: the
  decay and the update round in another order);
- a 2-epoch run: per-epoch losses rtol=1e-4, metric rates atol=1e-6 (the
  confusion counts are equal unless a probability sits at 0.5).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepdfa_tpu.config import DataConfig as JData  # noqa: E402
from deepdfa_tpu.config import ExperimentConfig as JExp  # noqa: E402
from deepdfa_tpu.config import FeatureConfig as JFeat  # noqa: E402
from deepdfa_tpu.config import GGNNConfig as JCfg  # noqa: E402
from deepdfa_tpu.config import OptimConfig as JOptim  # noqa: E402
from deepdfa_tpu.models import make_model as jmake_model  # noqa: E402
from deepdfa_tpu.train import loop as jloop  # noqa: E402
from deepdfa_tpu.train import metrics as jmetrics  # noqa: E402

from deepdfa_tpu_torch import bridge  # noqa: E402
from deepdfa_tpu_torch.config import (DataConfig, ExperimentConfig,  # noqa: E402
                                      FeatureConfig, GGNNConfig, OptimConfig)
from deepdfa_tpu_torch.data.graphs import batch_np, to_device  # noqa: E402
from deepdfa_tpu_torch.data.synthetic import random_dataset  # noqa: E402
from deepdfa_tpu_torch.models import make_model  # noqa: E402
from deepdfa_tpu_torch.train import loop  # noqa: E402
from deepdfa_tpu_torch.train.metrics import (ConfusionState,  # noqa: E402
                                             compute_metrics,
                                             update_confusion)

ATOL, RTOL = 2e-5, 1e-4
GRAD_FLOOR = 1e-6
INPUT_DIM = 52
SMALL = dict(hidden_dim=8, n_steps=3, num_output_layers=2)
POS_WEIGHT = 3.0


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _configs(layout, **optim):
    """The same small experiment for both packages (input_dim 52)."""
    jcfg = JExp(model=JCfg(**SMALL, layout=layout),
                data=JData(feature=JFeat(limit_all=INPUT_DIM - 2)),
                optim=JOptim(**optim))
    cfg = ExperimentConfig(model=GGNNConfig(**SMALL, layout=layout),
                           data=DataConfig(feature=FeatureConfig(
                               limit_all=INPUT_DIM - 2)),
                           optim=OptimConfig(**optim))
    assert cfg.input_dim == jcfg.input_dim == INPUT_DIM
    return jcfg, cfg


def _batches(n_batches=1, seed=0, per_batch=6):
    graphs = random_dataset(n_batches * per_batch, seed=seed,
                            input_dim=INPUT_DIM, mean_nodes=12, vul_rate=0.4)
    # one empty graph slot per batch beyond the padding sink's
    return [batch_np(graphs[i * per_batch:(i + 1) * per_batch], per_batch + 2,
                     256, 640) for i in range(n_batches)]


def _jax_side(jcfg, batch):
    model = jmake_model(jcfg.model, INPUT_DIM)
    params = model.init(jax.random.key(0),
                        jax.tree.map(jnp.asarray, batch))["params"]
    return model, params


def _port_model(cfg, params):
    model = make_model(cfg.model, INPUT_DIM, device="cpu")
    model.load_state_dict(bridge.flax_to_torch(
        jax.tree.map(np.asarray, params), cfg.model, INPUT_DIM))
    return model


def _to_torch(tree, cfg):
    return bridge.flax_to_torch(jax.tree.map(np.asarray, tree), cfg.model,
                                INPUT_DIM)


@pytest.mark.parametrize("layout", ["segment", "fused"])
def test_one_train_step_matches_jax(layout):
    jcfg, cfg = _configs(layout)
    batch = _batches()[0]
    jmodel, params = _jax_side(jcfg, batch)
    jb = jax.tree.map(jnp.asarray, batch)
    jtrainer = jloop.Trainer(jmodel, jcfg, pos_weight=POS_WEIGHT)
    jstate = jloop.TrainState(params, jtrainer.optimizer.init(params),
                              jax.random.key(0), jnp.zeros((), jnp.int32))
    jnew, jm, jl, jw = jtrainer.train_step(jstate, jb,
                                           jmetrics.ConfusionState.zeros())

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jb)
        labels, weights = jloop.extract_labels(jb, "graph")
        return jloop.bce_with_logits(logits, labels, weights, POS_WEIGHT)

    jgrads = _to_torch(jax.grad(loss_fn)(params), cfg)

    model = _port_model(cfg, params)
    trainer = loop.Trainer(model, cfg, pos_weight=POS_WEIGHT)
    state = trainer.init_state()
    state, m, loss, w = trainer.train_step(state, to_device(batch, "cpu"),
                                           ConfusionState.zeros())
    assert state.step == 1 and float(w) == float(jw) == 6
    np.testing.assert_allclose(float(loss), float(jl), atol=ATOL, rtol=RTOL)
    assert [float(x) for x in m] == [float(x) for x in jm]
    new = _to_torch(jnew.params, cfg)
    lr = cfg.optim.lr
    for name, p in model.named_parameters():
        g, jg = p.grad.numpy(), jgrads[name].numpy()
        np.testing.assert_allclose(g, jg, atol=ATOL, rtol=RTOL, err_msg=name)
        diff = np.abs(p.detach().numpy() - new[name].numpy())
        assert diff.max() <= 2 * lr, name
        above = np.abs(jg) > GRAD_FLOOR
        assert diff[above].max(initial=0.0) <= 1e-6, name


@pytest.mark.parametrize("grad_clip", [None, 0.01])
def test_adamw_from_identical_grads_matches_optax(grad_clip):
    """The port's optimizer (AdamW after clip_grad_norm_) equals the JAX
    package's optax chain when both are given the same gradients."""
    jcfg, cfg = _configs("segment", grad_clip=grad_clip)
    batch = _batches()[0]
    jmodel, params = _jax_side(jcfg, batch)
    jtrainer = jloop.Trainer(jmodel, jcfg)
    grads = jax.tree.map(
        lambda p: jnp.asarray(np.random.default_rng(p.size).standard_normal(
            p.shape).astype(np.float32) * 1e-2), params)
    opt_state = jtrainer.optimizer.init(params)
    for _ in range(2):
        updates, opt_state = jtrainer.optimizer.update(grads, opt_state,
                                                       params)
        params_j = params = jax.tree.map(lambda a, b: a + b, params, updates)
    want = _to_torch(params_j, cfg)

    _, start = _jax_side(jcfg, batch)
    model = _port_model(cfg, start)
    trainer = loop.Trainer(model, cfg)
    state = trainer.init_state()
    tgrads = _to_torch(grads, cfg)
    for _ in range(2):
        for name, p in model.named_parameters():
            p.grad = tgrads[name].clone()
        if grad_clip:
            torch.nn.utils.clip_grad_norm_(list(model.parameters()), grad_clip)
        state.optimizer.step()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-6, rtol=0, err_msg=name)


def test_sentinel_guard_keeps_state_on_a_nan_step():
    """A NaN loss scale poisons every gradient: the step keeps the
    parameters, the optimizer state and the metrics, and reports NaN."""
    _, cfg = _configs("fused")
    b1, b2 = (to_device(b, "cpu") for b in _batches(2))
    model = make_model(cfg.model, INPUT_DIM, device="cpu", seed=1)
    trainer = loop.Trainer(model, cfg, pos_weight=POS_WEIGHT)
    state = trainer.init_state()
    state, metrics, loss, _ = trainer.train_step(state, b1,
                                                 ConfusionState.zeros())
    assert math.isfinite(float(loss))
    params = {k: v.clone() for k, v in model.state_dict().items()}
    opt = [{k: v.clone() if torch.is_tensor(v) else v for k, v in s.items()}
           for s in state.optimizer.state.values()]
    rng = state.rng.get_state()
    state, after, loss, _ = trainer.train_step(state, b2, metrics,
                                               loss_scale=float("nan"))
    assert math.isnan(float(loss))
    assert all(torch.equal(a, b) for a, b in zip(after, metrics))
    assert all(torch.equal(v, params[k]) for k, v in model.state_dict().items())
    for kept, now in zip(opt, state.optimizer.state.values()):
        assert all(torch.equal(torch.as_tensor(kept[k]), torch.as_tensor(v))
                   for k, v in now.items())
    # the step still counts and the generator still advances, as in JAX
    assert state.step == 2 and not torch.equal(state.rng.get_state(), rng)


def test_loss_labels_and_metrics_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal(40).astype(np.float32) * 3
    labels = (rng.random(40) < 0.3).astype(np.float32)
    weights = (rng.random(40) < 0.8).astype(np.float32)
    for pw in (None, 4.5):
        got = loop.bce_sums(*map(torch.from_numpy, (logits, labels, weights)),
                            pos_weight=pw)
        want = jloop.bce_sums(logits, labels, weights, pos_weight=pw)
        for a, b in zip(got, want):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
        np.testing.assert_allclose(
            float(loop.bce_with_logits(*map(torch.from_numpy,
                                            (logits, labels, weights)), pw)),
            float(jloop.bce_with_logits(logits, labels, weights, pw)),
            rtol=1e-6)

    batch = _batches(seed=5)[0]
    got = loop.graph_labels(to_device(batch, "cpu")).numpy()
    want = np.asarray(jloop.graph_labels(jax.tree.map(jnp.asarray, batch)))
    np.testing.assert_array_equal(got, want)
    assert not got[~batch.graph_mask].any()  # padded slots get label 0

    losses = [0.5, float("nan"), 0.25, 1.0]
    wsums = [6.0, 6.0, 2.0, 0.0]
    assert loop._weighted_mean(losses, wsums) == jloop._weighted_mean(
        losses, wsums) == pytest.approx((0.5 * 6 + 0.25 * 2) / 8)
    assert loop._weighted_mean([float("nan")], [3.0]) == 0.0

    for counts in ([3, 1, 10, 2], [0, 0, 7, 0], [0, 4, 0, 0]):
        state = ConfusionState(*(torch.tensor(float(c)) for c in counts))
        jstate = jmetrics.ConfusionState(*(jnp.float32(c) for c in counts))
        assert compute_metrics(state, "val_") == jmetrics.compute_metrics(
            jstate, "val_")
    probs = rng.random(40).astype(np.float32)
    mask = weights > 0
    got = update_confusion(ConfusionState.zeros(), torch.from_numpy(probs),
                           torch.from_numpy(labels), torch.from_numpy(mask))
    want = jmetrics.update_confusion(jmetrics.ConfusionState.zeros(), probs,
                                     labels, mask)
    assert [float(x) for x in got] == [float(x) for x in want]


@pytest.mark.parametrize("layout", ["segment", "fused"])
def test_two_epochs_match_jax_trainer(layout):
    jcfg, cfg = _configs(layout)
    train, val = _batches(3, seed=11), _batches(1, seed=12)
    jmodel, params = _jax_side(jcfg, train[0])
    jtrainer = jloop.Trainer(jmodel, jcfg, pos_weight=POS_WEIGHT)
    jstate = jloop.TrainState(params, jtrainer.optimizer.init(params),
                              jax.random.key(0), jnp.zeros((), jnp.int32))
    trainer = loop.Trainer(_port_model(cfg, params), cfg, pos_weight=POS_WEIGHT)
    state = trainer.init_state()
    for epoch in range(2):
        order = train if epoch == 0 else train[::-1]
        jstate, jtm, jtl = jtrainer.train_epoch(jstate, order)
        jvm, jvl = jtrainer.evaluate(jstate.params, val)
        state, tm, tl = trainer.train_epoch(state, order)
        vm, vl = trainer.evaluate(state.model, val)
        np.testing.assert_allclose(tl, jtl, rtol=1e-4, err_msg=f"epoch {epoch}")
        np.testing.assert_allclose(vl, jvl, rtol=1e-4, err_msg=f"epoch {epoch}")
        for got, want in ((tm, jtm), (vm, jvm)):
            assert got.keys() == want.keys()
            for k in got:
                assert got[k] == pytest.approx(want[k], abs=1e-6), (epoch, k)
    assert state.step == 6 and len(trainer.step_ms) == 3
    assert trainer.n_eval_batches == 2


def test_steps_for_takes_every_segment_batch():
    """No segment twin and no shape plan on the card: every BatchedGraphs
    goes to the model's own steps; anything else is refused."""
    _, cfg = _configs("fused")
    trainer = loop.Trainer(make_model(cfg.model, INPUT_DIM, device="cpu"), cfg)
    for b in _batches(2):
        assert trainer.steps_for(b) == (trainer.train_step, trainer.eval_step)
    with pytest.raises(TypeError, match="A10"):
        trainer.steps_for({"dense": True})
    assert trainer.rescale_lr(0.5) == 0.5
    trainer.init_state()
    assert trainer.optimizer.param_groups[0]["lr"] == pytest.approx(
        cfg.optim.lr * 0.5)
    trainer.rescale_lr(0.5)
    assert trainer.optimizer.param_groups[0]["lr"] == pytest.approx(
        cfg.optim.lr * 0.25)
