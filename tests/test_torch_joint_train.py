"""The port's joint trainer (``deepdfa_tpu_torch.llm.joint``'s train half)
against the JAX package's ``JointTrainer``, on the CPU.

The same inputs go to both packages: C-like texts and graphs made from a
seed, the JAX-initialised LLM and fusion trees carried across by
``bridge.llama_flax_to_torch`` and ``bridge.fusion_flax_to_torch``. The LLM
runs ``attn_impl="full"``: in the MSIVD mode the frozen LLM reaches no
backward. The fusion head's dropout is 0 in the comparisons: the two
packages draw dropout masks from different generators.

Tolerances:
- train and eval losses: rtol 1e-5 (float32 sums in other orders through
  the LLM, the GGNN encoder and a few AdamW steps);
- eval reports: equal (thresholded predictions and counts), checked only
  where every probability is more than 1e-4 from the threshold;
- the trained parameters: each element within 2·lr per update of the JAX
  value (AdamW moves an element by about lr per update whatever its
  gradient's size, so an element whose gradient is at rounding level —
  the pooling gate's bias, whose true gradient is 0: softmax is
  shift-invariant — moves by the sign of rounding noise), and each
  tensor's mean error within 1e-3 of its mean change (measured ≤ 3e-5; a
  few elements with tiny gradients differ by up to 2e-3 of the largest
  change, for the same reason);
- ``from_run_dir`` scores against the trainer's own evaluation: 1e-5;
- masks, labels, eval points and the threshold sweep: equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from flax import linen as nn  # noqa: E402

from deepdfa_tpu.config import GGNNConfig as JCfg  # noqa: E402
from deepdfa_tpu.data.synthetic import random_dataset as jdataset  # noqa: E402
from deepdfa_tpu.llm import dataset as jds  # noqa: E402
from deepdfa_tpu.llm import fusion as jfusion  # noqa: E402
from deepdfa_tpu.llm import joint as jjoint  # noqa: E402
from deepdfa_tpu.llm import llama as jl  # noqa: E402

from deepdfa_tpu_torch import bridge  # noqa: E402
from deepdfa_tpu_torch.config import GGNNConfig  # noqa: E402
from deepdfa_tpu_torch.data.synthetic import random_dataset  # noqa: E402
from deepdfa_tpu_torch.llm import dataset as tds  # noqa: E402
from deepdfa_tpu_torch.llm import fusion as tfusion  # noqa: E402
from deepdfa_tpu_torch.llm import joint as tjoint  # noqa: E402
from deepdfa_tpu_torch.llm import llama as tl  # noqa: E402
from deepdfa_tpu_torch.llm.joint_engine import JointEngine  # noqa: E402
from deepdfa_tpu_torch.train.metrics import classification_report  # noqa: E402

INPUT_DIM = 1002
BLOCK = 128
VOCAB = 2048
N_TRAIN, N_EVAL = 12, 8
_WORDS = ["int", "char", "buf", "len", "memcpy", "strcpy", "if", "return",
          "while", "ptr", "malloc", "free", "count", "idx", "struct"]


def _texts(n, seed):
    rng = np.random.default_rng(seed)
    return ["void f_%d(int a) {\n  %s;\n}" % (i, " ".join(
        rng.choice(_WORDS, size=int(rng.integers(5, 200)))))
        for i in range(n)]


def _examples(ds, n, seed):
    rng = np.random.default_rng(seed + 100)
    labels = rng.integers(0, 2, n).tolist()
    return ds.encode_functions(_texts(n, seed), labels,
                               ds.HashTokenizer(VOCAB), BLOCK)


def _graph_joins():
    """Graphs of examples 0..N_TRAIN + N_EVAL - 1 in both packages, the
    eval examples keyed after the train ones; graph 5 is missing."""
    n = N_TRAIN + N_EVAL
    tg = random_dataset(n, seed=7, input_dim=INPUT_DIM, mean_nodes=30)
    jg = jdataset(n, seed=7, input_dim=INPUT_DIM, mean_nodes=30)
    keep = [i for i in range(n) if i != 5]
    return (tds.GraphJoin({i: tg[i] for i in keep}, max_nodes=512,
                          max_edges=2048),
            jds.GraphJoin({i: jg[i] for i in keep}, max_nodes=512,
                          max_edges=2048))


def _with_indices(ex, offset):
    return type(ex)(ex.input_ids, ex.labels, ex.indices + offset,
                    ex.pad_mask)


@pytest.fixture(scope="module")
def setup():
    llm_cfg = jl.tiny_llama(vocab_size=VOCAB)
    llm_params = jax.tree.map(np.asarray, nn.meta.unbox(
        jl.LlamaModel(llm_cfg).init(jax.random.key(0),
                                    np.zeros((2, BLOCK), np.int32))["params"]))
    data = {}
    for name, ds in (("port", tds), ("jax", jds)):
        data[name] = (_examples(ds, N_TRAIN, seed=1),
                      _with_indices(_examples(ds, N_EVAL, seed=2), N_TRAIN))
    return llm_cfg, llm_params, data


def _jax_trainer(setup, jcfg):
    llm_cfg, llm_params, data = setup
    jfus = jfusion.FusionModel(gnn_cfg=JCfg(), input_dim=INPUT_DIM,
                               llm_hidden_size=llm_cfg.hidden_size,
                               dropout_rate=0.0, pool="last")
    trainer = jjoint.JointTrainer(jl.LlamaModel(llm_cfg), llm_params, jfus,
                                  jcfg, _graph_joins()[1])
    train, _ = data["jax"]
    n_batches = -(-len(train) // jcfg.train_batch_size)
    first = trainer._joined(next(jds.text_batches(train,
                                                  jcfg.train_batch_size)))
    state = trainer._build(n_batches, first)
    return trainer, state


def _port_trainer(setup, jstate, tcfg, run_dir=None):
    llm_cfg, llm_params, _ = setup
    params = jax.tree.map(np.asarray, jstate.params)
    fus_params = params["fusion"] if tcfg.train_llm else params
    llm = tl.build_llama(tl.LlamaConfig(**dataclasses.asdict(llm_cfg)),
                         "cpu", seed=None)
    llm.load_state_dict(bridge.llama_flax_to_torch(llm_params))
    fus = tfusion.build_fusion(GGNNConfig(), INPUT_DIM, llm_cfg.hidden_size,
                               dropout_rate=0.0, device="cpu")
    fus.load_state_dict(bridge.fusion_flax_to_torch(fus_params, GGNNConfig(),
                                                    INPUT_DIM))
    return tjoint.JointTrainer(llm, fus, tcfg, _graph_joins()[0],
                               run_dir=run_dir)


def _configs(**kw):
    kw = dict(block_size=BLOCK, epochs=2, learning_rate=1e-3, seed=3, **kw)
    return jjoint.JointConfig(**kw), tjoint.JointConfig(**kw)


def _close_history(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key, value in w.items():
            if key.endswith("loss"):
                assert g[key] == pytest.approx(float(value), rel=1e-5), key
            else:
                assert g[key] == value, key


def _close_state(got: dict, want: dict, start: dict, lr: float,
                 updates: int):
    for name, w in want.items():
        g, s = got[name].detach(), torch.from_numpy(np.asarray(w))
        err = float((g - s).abs().max())
        assert err <= 2 * lr * updates, name
        moved = (s - start[name]).abs()
        if name != "flowgnn_encoder.pooling.gate.bias":
            mean_err = float((g - s).abs().mean())
            assert mean_err <= 1e-3 * float(moved.mean()) + 1e-9, name


@pytest.fixture(scope="module")
def trained(setup, tmp_path_factory):
    """One two-epoch run of each trainer from the same initial state."""
    jcfg, tcfg = _configs(weight_decay=0.01)
    jtrainer, jstate = _jax_trainer(setup, jcfg)
    start = bridge.fusion_flax_to_torch(jax.tree.map(np.asarray,
                                                     jstate.params),
                                        GGNNConfig(), INPUT_DIM)
    run_dir = tmp_path_factory.mktemp("joint_run")
    trainer = _port_trainer(setup, jstate, tcfg, run_dir=run_dir)
    data = setup[2]
    jstate = jtrainer.train(*data["jax"], state=jstate)
    state = trainer.train(*data["port"])
    want = bridge.fusion_flax_to_torch(jax.tree.map(np.asarray,
                                                    jstate.params),
                                       GGNNConfig(), INPUT_DIM)
    return jtrainer, jstate, trainer, state, want, start, run_dir


def test_joint_trainer_epochs_match_the_jax_trainer(setup, trained):
    jtrainer, jstate, trainer, state, want, start, _ = trained
    # three steps an epoch: both cadences (5 and 2 evaluations an epoch)
    # round to a stride of one step
    assert [h.get("step") for h in trainer.history] == [0, 1, 2, None] * 2
    _close_history(trainer.history, jtrainer.history)
    assert state.step == 6 and state.opt_state.count == 6
    _close_state(dict(state.params.named_parameters()), want, start,
                 lr=1e-3, updates=6)
    assert trainer.num_missing == jtrainer.num_missing > 0
    # the test report on the eval examples
    probs = trainer._run_eval(state.params, setup[2]["port"][1])[1][:, 1]
    if np.abs(probs - 0.5).min() > 1e-4:
        got = trainer.test(state.params, setup[2]["port"][1])
        _close_history([got], [jtrainer.test(jstate.params,
                                             setup[2]["jax"][1])])


def test_run_dir_restores_in_the_joint_engine(setup, trained):
    """``JointEngine.from_run_dir`` on the trainer's run directory scores
    the eval texts as the trainer's own ``evaluate`` does."""
    _, _, trainer, state, _, _, run_dir = trained
    assert sorted(p.name for p in run_dir.iterdir()) == ["epoch_0",
                                                        "epoch_1"]
    llm_cfg, llm_params, data = setup
    engine = JointEngine.from_run_dir(
        run_dir, jcfg=tjoint.JointConfig(block_size=BLOCK),
        llm_state=bridge.llama_flax_to_torch(llm_params), vocab_size=VOCAB,
        max_nodes=512, max_edges=2048, device="cpu")
    assert engine.model_rev  # the newest epoch, epoch_1
    texts = _texts(N_EVAL, seed=2)
    join = _graph_joins()[0]
    items = [(t, join.graphs.get(N_TRAIN + i)) for i, t in enumerate(texts)]
    items = [(t, g) for t, g in items if g is not None]
    got = engine.score(items)
    _, probs, _ = trainer._run_eval(state.params, data["port"][1])
    np.testing.assert_allclose(got, probs[:, 1], atol=1e-5, rtol=1e-5)
    loaded = trainer.load("epoch_1")
    assert all(torch.equal(loaded[k], v) for k, v in
               state.params.state_dict().items())


def test_train_llm_trains_the_encoder_as_the_jax_trainer():
    """``train_llm=True`` on ``tiny_llama``: the encoder joins the trained
    module and both packages move it alike (attn "full", one epoch)."""
    llm_cfg = jl.tiny_llama(vocab_size=VOCAB)
    llm_params = jax.tree.map(np.asarray, nn.meta.unbox(
        jl.LlamaModel(llm_cfg).init(jax.random.key(1),
                                    np.zeros((2, BLOCK), np.int32))["params"]))
    data = {name: (_examples(ds, 8, seed=4),
                   _with_indices(_examples(ds, 4, seed=5), N_TRAIN))
            for name, ds in (("port", tds), ("jax", jds))}
    setup = (llm_cfg, llm_params, data)
    jcfg, tcfg = _configs(train_llm=True, weight_decay=0.01, eval_steps=1,
                          first_eval_steps=1)
    jcfg = dataclasses.replace(jcfg, epochs=1)
    tcfg = dataclasses.replace(tcfg, epochs=1)
    jtrainer, jstate = _jax_trainer(setup, jcfg)
    start_llm = bridge.llama_flax_to_torch(llm_params)
    trainer = _port_trainer(setup, jstate, tcfg)
    jstate = jtrainer.train(*data["jax"], state=jstate)
    state = trainer.train(*data["port"])
    assert set(dict(state.params.named_children())) == {"fusion", "llm"}
    _close_history(trainer.history, jtrainer.history)
    params = jax.tree.map(np.asarray, jstate.params)
    want_llm = bridge.llama_flax_to_torch(params["llm"])
    got = dict(state.params["llm"].named_parameters())
    _close_state(got, want_llm, start_llm, lr=1e-3, updates=2)
    assert any(not torch.equal(got[k], start_llm[k]) for k in got)


def test_freeze_gnn_and_accumulation_in_the_trainer(setup):
    """``freeze_gnn`` leaves the encoder where it was; with 2 accumulation
    steps two epochs of three batches make three updates (the first at
    lr 0)."""
    jcfg, tcfg = _configs(freeze_gnn=True, gradient_accumulation_steps=2)
    _, jstate = _jax_trainer(setup, jcfg)
    trainer = _port_trainer(setup, jstate, tcfg)
    before = {k: v.clone() for k, v in trainer.fusion.state_dict().items()}
    state = trainer.train(*setup[2]["port"])
    assert state.opt_state.count == 3 and state.step == 6
    after = trainer.fusion.state_dict()
    for k, v in before.items():
        frozen = k.startswith("flowgnn_encoder.")
        assert torch.equal(after[k], v) == frozen, k


def test_masks_labels_points_and_sweep_are_the_jax_ones(setup):
    """``weight_decay_mask`` and ``gnn_freeze_labels`` by torch name against
    the JAX ones over the fusion tree; ``eval_points``,
    ``best_threshold_sweep`` and ``classification_report``."""
    _, jstate = _jax_trainer(setup, _configs()[0])
    params = jax.tree.map(np.asarray, jstate.params)
    as_torch = lambda tree: bridge.fusion_flax_to_torch(  # noqa: E731
        jax.tree.map(lambda m, p: np.full(p.shape, m, np.float32), tree,
                     params), GGNNConfig(), INPUT_DIM)
    want = {k: bool(v.reshape(-1)[0]) for k, v in
            as_torch(jjoint.weight_decay_mask(params)).items()}
    assert tjoint.weight_decay_mask(want) == want
    assert not all(want.values()) and any(want.values())
    labels = jjoint.gnn_freeze_labels(params)
    frozen = {k: bool(v.reshape(-1)[0]) for k, v in as_torch(
        jax.tree.map(lambda lab: lab == "freeze", labels)).items()}
    assert {k: v == "freeze" for k, v in
            tjoint.gnn_freeze_labels(frozen).items()} == frozen
    for n in (1, 3, 10, 17):
        for epoch in (0, 1):
            assert tjoint.eval_points(n, epoch, _configs()[1]) == \
                jjoint.eval_points(n, epoch, _configs()[0])
    rng = np.random.default_rng(0)
    for macro in (True, False):
        probs, labs = rng.random(40), rng.integers(0, 2, 40)
        assert tjoint.best_threshold_sweep(probs, labs, macro=macro) == \
            jjoint.best_threshold_sweep(probs, labs, macro=macro)
        from deepdfa_tpu.train.metrics import classification_report as jrep
        for t in (0.3, 0.5, 0.99):
            assert classification_report(probs, labs, macro, t) == \
                jrep(probs, labs, macro, t)
