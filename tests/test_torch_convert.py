"""``convert_jax_checkpoint.py`` (orbax checkpoints of the JAX package into
the port's formats) on the CPU.

- GGNN: the JAX ``fit`` writes a one-epoch run of the tiny fused config on
  the synthetic corpus; its step is converted. The converted ``aux.pt``
  carries the optax AdamW moments (through the bridge's transposes) and
  count exactly, and the step. The first step of epoch 1 taken from the
  converted checkpoint by the port's trainer holds against the JAX
  trainer's next step from the orbax one, on the same first batch: every
  parameter within ``STEP_TOL`` = 1e-6 (absolute; one AdamW update moves
  an element by about lr = 1e-3, and both sides start from the same
  moments; measured ≤ 1.2e-7), but the pooling gate's bias, whose true gradient is 0
  (softmax is shift-invariant) and whose rounding-level gradients move it
  differently: within 2·lr there, as in ``tests/test_torch_train_loop.py``. The port's ``fit --resume`` continues the converted run
  through epoch 1.
- LoRA: a JAX ``LoraFinetuner.save_adapters`` directory, converted, loads
  through the port's ``LoraFinetuner.load_adapters`` and gives the JAX
  adapters' logits within 1e-5 (float32, of the largest logit).
- Fusion: a JAX ``JointTrainer.save`` checkpoint, converted, restores in
  the port's ``JointEngine.from_run_dir`` and scores as the JAX eval step:
  within 1e-5.
"""

import dataclasses
import json
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as nn  # noqa: E402

from deepdfa_tpu.config import GGNNConfig as JCfg  # noqa: E402
from deepdfa_tpu.config import load_config as jload_config  # noqa: E402
from deepdfa_tpu.config import to_json as jto_json  # noqa: E402
from deepdfa_tpu.data.graphs import batch_np as jbatch_np  # noqa: E402
from deepdfa_tpu.data.sampler import positive_weight as jpositive_weight  # noqa: E402
from deepdfa_tpu.data.synthetic import random_dataset as jdataset  # noqa: E402
from deepdfa_tpu.llm import dataset as jds  # noqa: E402
from deepdfa_tpu.llm import finetune as jft  # noqa: E402
from deepdfa_tpu.llm import fusion as jfusion  # noqa: E402
from deepdfa_tpu.llm import joint as jjoint  # noqa: E402
from deepdfa_tpu.llm import llama as jl  # noqa: E402
from deepdfa_tpu.models import make_model as jmake_model  # noqa: E402
from deepdfa_tpu.train import cli as jcli  # noqa: E402
from deepdfa_tpu.train import loop as jloop  # noqa: E402
from deepdfa_tpu.train.checkpoint import CheckpointManager as JManager  # noqa: E402

import convert_jax_checkpoint as conv  # noqa: E402
from deepdfa_tpu_torch import bridge  # noqa: E402
from deepdfa_tpu_torch.config import GGNNConfig, load_config  # noqa: E402
from deepdfa_tpu_torch.data.sampler import positive_weight  # noqa: E402
from deepdfa_tpu_torch.data.synthetic import random_dataset  # noqa: E402
from deepdfa_tpu_torch.llm import finetune as tft  # noqa: E402
from deepdfa_tpu_torch.llm import llama as tl  # noqa: E402
from deepdfa_tpu_torch.llm.joint import JointConfig  # noqa: E402
from deepdfa_tpu_torch.llm.joint_engine import JointEngine  # noqa: E402
from deepdfa_tpu_torch.models import make_model  # noqa: E402
from deepdfa_tpu_torch.train import fit as fit_mod  # noqa: E402
from deepdfa_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from deepdfa_tpu_torch.train.loop import Trainer  # noqa: E402

TINY = {
    "model.hidden_dim": 8, "model.n_steps": 3, "model.num_output_layers": 2,
    "model.layout": "fused", "data.sample": True, "data.undersample": None,
    "data.feature.limit_all": 50, "data.batch.batch_graphs": 32,
    "data.batch.max_nodes": 160, "data.batch.max_edges": 320,
    "optim.max_epochs": 1}
STEP_TOL = 1e-6
LOGIT_TOL = 1e-5
PROB_TOL = 1e-5
LORA = 4
INPUT_DIM = 1002
BLOCK = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A one-epoch JAX run (with the ``config.json`` the CLI writes) and
    its conversion: (JAX config, port config, JAX run dir, port run dir,
    the steps converted)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DEEPDFA_STORAGE", str(tmp_path_factory.mktemp("storage")))
        jcfg = jload_config(overrides=TINY)
        src = tmp_path_factory.mktemp("jax_run")
        jcli.fit(jcfg, src)
        (src / "config.json").write_text(jto_json(jcfg))
        dst = tmp_path_factory.mktemp("port_run")
        [step] = JManager(src / "checkpoints").steps
        out = conv.main(["ggnn", str(src), str(dst), "--step", str(step)])
    return jcfg, load_config(overrides=TINY), src, dst, out["steps"]


def test_converted_step_carries_the_moments_and_count(runs):
    jcfg, cfg, src, dst, steps = runs
    [step] = steps
    jm, m = JManager(src / "checkpoints"), CheckpointManager(dst /
                                                            "checkpoints")
    assert m.steps == jm.steps == [step]
    assert {k: m.meta(step)[k] for k in ("epoch", "metrics", "mesh")} == {
        k: jm.meta(step)[k] for k in ("epoch", "metrics", "mesh")}
    params = jax.tree.map(np.asarray, jm.restore(step)["params"])
    state = m.restore(step)
    want = bridge.flax_to_torch(params, cfg.model, cfg.input_dim)
    assert state.keys() == want.keys()
    assert all(torch.equal(state[k], want[k]) for k in want)
    aux, jaux = m.restore_aux(step), jm.restore_aux(step)
    adam = conv._adam_state(jax.tree.map(np.asarray, jaux["opt_state"]))
    mu = bridge.flax_to_torch(adam["mu"], cfg.model, cfg.input_dim)
    nu = bridge.flax_to_torch(adam["nu"], cfg.model, cfg.input_dim)
    names = [n for n, _ in make_model(cfg.model, cfg.input_dim,
                                      device="cpu").named_parameters()]
    opt = aux["optimizer"]["state"]
    assert len(opt) == len(names)
    for i, name in enumerate(names):
        assert torch.equal(opt[i]["exp_avg"], mu[name]), name
        assert torch.equal(opt[i]["exp_avg_sq"], nu[name]), name
        assert float(opt[i]["step"]) == float(adam["count"]) == step
    assert aux["step"] == int(np.asarray(jaux["step"])) == step
    # the generator is the one the port's fit seeds
    assert torch.equal(aux["rng"],
                       torch.Generator().manual_seed(cfg.seed).get_state())
    assert (dst / "journal.json").read_text() == \
        (src / "journal.json").read_text()


def _first_batch(mod, cfg, corpus, epoch: int):
    train, val = corpus["train"], corpus["val"]
    labels = np.array([int(g.node_feats["_VULN"].max()) for g in train])
    batcher = mod._batcher(cfg, train + val)
    graphs = mod._epoch_graphs(train, labels, cfg, epoch)
    return next(iter(mod._batch_stream(batcher, graphs,
                                       shuffle_seed=cfg.seed + epoch))), labels


def test_the_first_resumed_step_matches_the_jax_runs_next(runs, monkeypatch,
                                                          tmp_path):
    jcfg, cfg, src, dst, [step] = runs
    monkeypatch.setenv("DEEPDFA_STORAGE", str(tmp_path))
    # the JAX trainer from its own checkpoint, one step on epoch 1's first
    # batch
    jcorpus = jcli.load_corpus(jcfg)
    jbatch, labels = _first_batch(jcli, jcfg, jcorpus, 1)
    jtrainer = jloop.Trainer(jmake_model(jcfg.model, jcfg.input_dim), jcfg,
                             pos_weight=jpositive_weight(labels))
    template = jtrainer.init_state(jax.tree.map(jnp.asarray, jbatch))
    _, _, payload, aux = JManager(src / "checkpoints").restore_resume(
        template={"params": template.params},
        aux_template={"opt_state": template.opt_state,
                      "rng": jax.random.key_data(template.rng),
                      "step": template.step})
    jstate = jloop.TrainState(payload["params"], aux["opt_state"],
                              jax.random.wrap_key_data(aux["rng"]),
                              aux["step"])
    jstate, jm, jloss = jtrainer.train_epoch(jstate, [jbatch])
    want = bridge.flax_to_torch(jax.tree.map(np.asarray, jstate.params),
                                cfg.model, cfg.input_dim)
    # the port's trainer from the converted checkpoint, the same batch
    corpus = fit_mod.load_corpus(cfg)
    batch, labels = _first_batch(fit_mod, cfg, corpus, 1)
    model = make_model(cfg.model, cfg.input_dim, device="cpu", seed=cfg.seed)
    trainer = Trainer(model, cfg, pos_weight=positive_weight(labels))
    state = trainer.init_state()
    ckpts = CheckpointManager(dst / "checkpoints")
    model.load_state_dict(ckpts.restore(step))
    saved = ckpts.restore_aux(step)
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = saved["step"]
    state, m, loss = trainer.train_epoch(state, [batch])
    assert state.step == int(jstate.step) == step + 1
    assert loss == pytest.approx(float(jloss), rel=1e-5)
    for name, p in model.named_parameters():
        err = float((p.detach() - want[name]).abs().max())
        limit = 2 * cfg.optim.lr if name == "pooling.gate.bias" else STEP_TOL
        assert err <= limit, (name, err)


def test_fit_resumes_the_converted_run(runs, monkeypatch, tmp_path):
    """``fit(resume=True)`` on the converted run trains epoch 1 alone."""
    _, cfg, _, dst, [step] = runs
    monkeypatch.setenv("DEEPDFA_STORAGE", str(tmp_path))
    cfg = dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim,
                                                             max_epochs=2))
    out = fit_mod.fit(cfg, dst, resume=True, device="cpu")
    assert np.isfinite(out["val_loss"])
    journal = json.loads((dst / "journal.json").read_text())
    assert journal["completed"]
    assert journal["timing"]["train_steps"] == journal["global_step"] - step
    assert CheckpointManager(dst / "checkpoints").latest_step() == \
        journal["global_step"] > step


# ------------------------------------------------------------------ LoRA


def test_converted_adapters_give_the_jax_logits(tmp_path):
    cfg = jl.tiny_llama(lora_rank=LORA)
    model = jl.LlamaForCausalLM(cfg)
    p = jax.tree.map(np.asarray, nn.meta.unbox(model.init(
        jax.random.key(0), np.zeros((2, 16), np.int32))["params"]))
    rng = np.random.default_rng(3)
    tuned = jax.tree_util.tree_map_with_path(
        lambda path, v: (rng.normal(size=v.shape).astype(np.float32) * 0.1
                         if "lora" in jax.tree_util.keystr(path) else v), p)
    jft.LoraFinetuner(model, jft.FinetuneConfig(),
                      run_dir=tmp_path / "jax").save_adapters(tuned,
                                                              "adapters")
    out = conv.main(["lora", str(tmp_path / "jax" / "adapters"),
                     str(tmp_path / "port" / "adapters")])
    assert Path(out["path"]) == tmp_path / "port" / "adapters"
    port = tl.build_llama(tl.tiny_llama(lora_rank=LORA), "cpu", seed=None,
                          cls=tl.LlamaForCausalLM)
    port.load_state_dict(bridge.llama_flax_to_torch(p))  # adapters at init
    tft.LoraFinetuner(port, tft.FinetuneConfig(),
                      run_dir=tmp_path / "port").load_adapters(port,
                                                               "adapters")
    ids = np.random.default_rng(4).integers(0, 320, (2, 16))
    mask = np.ones((2, 16), bool)
    mask[1, :3] = False
    want = np.asarray(model.apply({"params": tuned}, ids, mask))
    with torch.no_grad():
        got = port(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert float(np.abs(got - want).max()) <= LOGIT_TOL * float(
        np.abs(want).max())


# ---------------------------------------------------------------- fusion


def test_converted_fusion_checkpoint_scores_in_the_joint_engine(tmp_path):
    llm_cfg = jl.tiny_llama(vocab_size=2048)
    jllm = jl.LlamaModel(llm_cfg)
    llm_params = jax.tree.map(np.asarray, nn.meta.unbox(jllm.init(
        jax.random.key(0), np.zeros((2, BLOCK), np.int32))["params"]))
    jfus = jfusion.FusionModel(gnn_cfg=JCfg(), input_dim=INPUT_DIM,
                               llm_hidden_size=llm_cfg.hidden_size,
                               dropout_rate=0.1, pool="last")
    graphs = jdataset(4, seed=22, input_dim=INPUT_DIM, mean_nodes=30)
    fus_params = jax.tree.map(np.asarray, jfus.init(
        {"params": jax.random.key(1), "dropout": jax.random.key(2)},
        np.zeros((2, BLOCK, llm_cfg.hidden_size), np.float32),
        jbatch_np(graphs[:2], 3, 512, 2048), deterministic=True,
        token_mask=np.ones((2, BLOCK), bool))["params"])
    # JointTrainer.save writes state.params alone under run_dir/name
    jjoint.JointTrainer.save(types.SimpleNamespace(run_dir=tmp_path / "jax"),
                             types.SimpleNamespace(params=fus_params),
                             "epoch_1")
    out = conv.main(["fusion", str(tmp_path / "jax"), str(tmp_path / "port")])
    assert [Path(p).name for p in out["paths"]] == ["epoch_1"]
    rng = np.random.default_rng(21)
    texts = ["void f_%d(int a) { %s; }" % (i, " ".join(rng.choice(
        ["int", "buf", "len", "memcpy", "if", "ptr", "free"],
        size=int(rng.integers(3, 60))))) for i in range(4)]
    _, eval_step = jjoint.make_joint_steps(jllm, jfus, None)
    ex = jds.encode_functions(texts, [0] * 4, jds.HashTokenizer(2048), BLOCK)
    join = jds.GraphJoin(graphs=dict(enumerate(graphs)), max_nodes=1024,
                         max_edges=4096)
    _, probs = eval_step(fus_params, llm_params,
                         join.join(next(jds.text_batches(ex, 4))))
    engine = JointEngine.from_run_dir(
        tmp_path / "port", jcfg=JointConfig(block_size=BLOCK),
        llm_state=bridge.llama_flax_to_torch(llm_params), max_nodes=1024,
        max_edges=4096, device="cpu")
    got = engine.score(list(zip(texts, random_dataset(
        4, seed=22, input_dim=INPUT_DIM, mean_nodes=30))))
    np.testing.assert_allclose(got, np.asarray(probs)[:, 1], atol=PROB_TOL,
                               rtol=PROB_TOL)
