"""The port's joint trainer over the RoBERTa encoder (the LineVul mode:
``train_llm``, CLS pooling) against the JAX package's ``JointTrainer``, on
the CPU.

The JAX ``RobertaEncoder`` and fusion trees of ``tiny_roberta`` are carried
across by ``bridge.roberta_flax_to_torch`` and
``bridge.fusion_flax_to_torch``; texts and graphs come from seeds. Every
dropout rate is 0 in the comparison (the two packages draw masks from
different generators); the port's dropout is held on only on training
steps.

Tolerances (those of ``tests/test_torch_joint_train.py``, for the same
reasons): losses rel 1e-5; each trained element within 2·lr per update of
the JAX value, and each tensor's mean error within 1e-3 of its mean change,
but the attention's key bias, whose true gradient is 0 (adding one vector to
every key shifts a query's scores by one constant, which the softmax
ignores), so AdamW moves it by the sign of rounding noise; eval reports
equal.
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
from deepdfa_tpu.llm import roberta as jr  # noqa: E402

from deepdfa_tpu_torch import bridge  # noqa: E402
from deepdfa_tpu_torch.config import GGNNConfig  # noqa: E402
from deepdfa_tpu_torch.data.synthetic import random_dataset  # noqa: E402
from deepdfa_tpu_torch.llm import dataset as tds  # noqa: E402
from deepdfa_tpu_torch.llm import fusion as tfusion  # noqa: E402
from deepdfa_tpu_torch.llm import joint as tjoint  # noqa: E402
from deepdfa_tpu_torch.llm import roberta as tr  # noqa: E402

INPUT_DIM = 1002
BLOCK = 64
VOCAB = 512
N_TRAIN, N_EVAL = 8, 4
LR = 1e-3
_WORDS = ["int", "char", "buf", "len", "memcpy", "if", "return", "ptr"]


def _examples(ds, n, seed, offset=0):
    rng = np.random.default_rng(seed)
    texts = ["void f_%d(int a) {\n  %s;\n}" % (i, " ".join(
        rng.choice(_WORDS, size=int(rng.integers(5, 90))))) for i in range(n)]
    labels = rng.integers(0, 2, n).tolist()
    return ds.encode_functions(texts, labels, ds.HashTokenizer(VOCAB), BLOCK,
                               indices=range(offset, offset + n))


def _joins():
    n = N_TRAIN + N_EVAL
    tg = random_dataset(n, seed=3, input_dim=INPUT_DIM, mean_nodes=20)
    jg = jdataset(n, seed=3, input_dim=INPUT_DIM, mean_nodes=20)
    return (tds.GraphJoin(dict(enumerate(tg)), max_nodes=256, max_edges=1024),
            jds.GraphJoin(dict(enumerate(jg)), max_nodes=256, max_edges=1024))


@pytest.mark.parametrize("use_gnn", [True, False])
def test_linevul_mode_trains_the_encoder_as_the_jax_trainer(use_gnn):
    cfg = jr.tiny_roberta(vocab_size=VOCAB, max_position_embeddings=BLOCK + 4,
                          hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0)
    kw = dict(block_size=BLOCK, epochs=1, learning_rate=LR, seed=3,
              train_llm=True, use_gnn=use_gnn, eval_steps=1,
              first_eval_steps=2, train_batch_size=4, eval_batch_size=4,
              weight_decay=0.01)
    jcfg, tcfg = jjoint.JointConfig(**kw), tjoint.JointConfig(**kw)
    jtrain, jeval = _examples(jds, N_TRAIN, 1), _examples(jds, N_EVAL, 2,
                                                          N_TRAIN)
    ttrain, teval = _examples(tds, N_TRAIN, 1), _examples(tds, N_EVAL, 2,
                                                          N_TRAIN)
    tjoin, jjoin = _joins() if use_gnn else (None, None)

    llm_params = jax.tree.map(np.asarray, nn.meta.unbox(
        jr.RobertaEncoder(cfg).init(jax.random.key(0), jtrain.input_ids[:2],
                                    jtrain.pad_mask[:2])["params"]))
    jfus = jfusion.FusionModel(gnn_cfg=JCfg(), input_dim=INPUT_DIM,
                               llm_hidden_size=cfg.hidden_size,
                               use_gnn=use_gnn, dropout_rate=0.0, pool="cls")
    jtrainer = jjoint.JointTrainer(jr.RobertaEncoder(cfg), llm_params, jfus,
                                   jcfg, jjoin)
    first = jtrainer._joined(next(jds.text_batches(jtrain, 4)))
    jstate = jtrainer._build(2, first)
    params = jax.tree.map(np.asarray, jstate.params)

    llm = tr.build_roberta(tr.RobertaConfig(**dataclasses.asdict(cfg)),
                           "cpu", seed=None)
    llm.load_state_dict(bridge.roberta_flax_to_torch(params["llm"]))
    fus = tfusion.build_fusion(GGNNConfig(), INPUT_DIM, cfg.hidden_size,
                               use_gnn=use_gnn, dropout_rate=0.0, pool="cls",
                               device="cpu")
    fus.load_state_dict(bridge.fusion_flax_to_torch(
        params["fusion"], GGNNConfig(), INPUT_DIM))
    start = {k: v.clone() for k, v in llm.state_dict().items()}
    trainer = tjoint.JointTrainer(llm, fus, tcfg, tjoin)
    modes = []
    llm.register_forward_pre_hook(lambda m, a: modes.append(m.training))

    jstate = jtrainer.train(jtrain, jeval, state=jstate)
    state = trainer.train(ttrain, teval)
    assert len(trainer.history) == len(jtrainer.history)
    for g, w in zip(trainer.history, jtrainer.history):
        assert set(g) == set(w)
        for key, value in w.items():
            if key.endswith("loss"):
                assert g[key] == pytest.approx(float(value), rel=1e-5), key
            else:
                assert g[key] == value, key
    # the encoder's dropout is on for each train step and off for the
    # evaluation after it (one eval batch)
    assert modes == [True, False, True, False]
    want = bridge.roberta_flax_to_torch(jax.tree.map(
        np.asarray, jstate.params["llm"]))
    got = dict(state.params["llm"].named_parameters())
    for name, w in want.items():
        err = float((got[name].detach() - w).abs().max())
        assert err <= 2 * LR * 2, name
        if name.endswith("attention.self.key.bias"):
            continue  # true gradient 0: moved by the sign of rounding noise
        moved = float((w - start[name]).abs().mean())
        assert float((got[name].detach() - w).abs().mean()) <= \
            1e-3 * moved + 1e-9, name
    assert any(not torch.equal(got[k].detach(), start[k]) for k in got)
