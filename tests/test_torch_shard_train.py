"""Training over the port's sharded LLM (``parallel/comm.py``'s backward,
``llm/llama.py``'s sharded backward, ``llm/finetune.py``'s sharded step,
``llm/joint.py``'s norm over shards and ``JointTrainer`` over a sharded
LLM) against the JAX package, on the CPU.

Ranks are ``python -c`` children over gloo (a ``FileStore``, a 60 s join),
two and four of them, as in ``tests/test_torch_shard.py``; each runs every
job of its world once (a module fixture) and writes what it got. The JAX
side runs in this process, unsharded or (the ring) on conftest's host
devices; weights cross with ``bridge.llama_flax_to_torch``.

- a LoRA step over ``tiny_llama`` (float32, the adapters' B drawn nonzero)
  at ``tp``, ``fsdp``, ``dp``, ``sp`` and pairs of them, with ``remat`` on
  and off: the loss within 1e-5 (relative; measured ≤ 3.4e-7), every
  adapter's gradient (summed over ``dp``/``sp``, gathered whole) within
  ``GRAD_TOL`` = 1e-5 of its largest entry (measured ≤ 4.8e-6: float32
  sums in other orders over the shards and the ring's online softmax),
  against ``jax.value_and_grad`` of the JAX loss
  (``sp`` with ``attn_impl="ring"`` against the JAX model built with the
  ring on a mesh of host devices; ``sp`` with ``"full"`` against the
  unsharded one); then two AdamW steps (the first at lr 0, optax's
  schedule) with a clip that engages, the adapters within ``STEP_TOL`` =
  1e-5 of their largest entry of the JAX ``make_lm_steps`` train step's
  (measured ≤ 2.2e-6);
- the ring's backward against ``jax.vjp`` of the JAX ``full_attention``:
  causal or not, GQA, padding, a query row with no key (zero gradients):
  within 1e-5 of each gradient's largest entry (measured ≤ 3.8e-7);
- each collective's backward on 2 ranks against autograd of the same
  computation on whole tensors in one process: within 1e-6;
- ``JointTrainer`` (MSIVD: the sharded LLM under ``no_grad``) over
  ``tp=2`` and ``fsdp=2`` for two steps against the JAX trainer: losses
  rtol 1e-5, parameters within 2·lr per update (as
  ``tests/test_torch_joint_train.py``);
- a sharded ``save_adapters`` writes the unsharded save's names and shapes
  and its values exactly, and ``load_adapters`` onto a sharded model takes
  the shards back; every rank reads the same.
"""

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as nn  # noqa: E402

from deepdfa_tpu.config import GGNNConfig as JCfg  # noqa: E402
from deepdfa_tpu.data.synthetic import random_dataset as jdataset  # noqa: E402
from deepdfa_tpu.llm import dataset as jds  # noqa: E402
from deepdfa_tpu.llm import finetune as jft  # noqa: E402
from deepdfa_tpu.llm import fusion as jfusion  # noqa: E402
from deepdfa_tpu.llm import joint as jjoint  # noqa: E402
from deepdfa_tpu.llm import llama as jl  # noqa: E402
from deepdfa_tpu.ops.ring_attention import full_attention as jfull  # noqa: E402
from deepdfa_tpu.parallel.mesh import local_mesh as jlocal_mesh  # noqa: E402

from deepdfa_tpu_torch import bridge  # noqa: E402
from deepdfa_tpu_torch.config import GGNNConfig  # noqa: E402
from deepdfa_tpu_torch.data.synthetic import random_dataset  # noqa: E402
from deepdfa_tpu_torch.llm import dataset as tds  # noqa: E402
from deepdfa_tpu_torch.llm import finetune as tft  # noqa: E402
from deepdfa_tpu_torch.llm import llama as tl  # noqa: E402
from deepdfa_tpu_torch.llm.lora import split_lora  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
LORA = 4
LR, CLIP = 1e-2, 1e-3  # the clip engages: the gradients' norm is ~1
GRAD_TOL = 1e-5
STEP_TOL = 1e-5
LOSS_TOL = 1e-5
RING_TOL = 1e-5
COMM_TOL = 1e-6
JOINT_VOCAB, JOINT_BLOCK, JOINT_LR = 2048, 32, 1e-3
INPUT_DIM = 1002

RANK_MAIN = textwrap.dedent("""
    import pickle, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from deepdfa_tpu_torch.config import GGNNConfig, MeshConfig
    from deepdfa_tpu_torch.llm import finetune as tf
    from deepdfa_tpu_torch.llm import joint as tj
    from deepdfa_tpu_torch.llm import llama as tl
    from deepdfa_tpu_torch.llm.dataset import GraphJoin
    from deepdfa_tpu_torch.llm.fusion import build_fusion
    from deepdfa_tpu_torch.ops.ring_attention import ring_attention_sharded
    from deepdfa_tpu_torch.parallel import comm
    from deepdfa_tpu_torch.parallel.mesh import (build_mesh,
                                                 initialize_multihost)

    rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    store = dist.FileStore(work + "/store", world)
    initialize_multihost(num_processes=world, process_id=rank,
                         backend="gloo", store=store, timeout_s=50)
    t = torch.from_numpy
    np_ = lambda d: {k: v.detach().numpy() for k, v in d.items()}
    try:
        job = pickle.load(open(work + "/in.pkl", "rb"))
        out = {}
        for key, axes, impl, remat, save in job["lora"]:
            mesh = build_mesh(MeshConfig(**axes))
            cfg = tl.tiny_llama(lora_rank=job["lora_rank"], attn_impl=impl,
                                remat=remat)
            model = tl.build_llama(cfg, "cpu", seed=None, mesh=mesh,
                                   cls=tl.LlamaForCausalLM)
            model.load_state_dict(tl.shard_state(job["state"], mesh))
            fcfg = tf.FinetuneConfig(learning_rate=job["lr"],
                                     max_grad_norm=job["clip"])
            tx = tf.lora_optimizer(fcfg, model, total_steps=2)
            (ids1, mask1), (ids2, mask2) = job["batches"]
            loss = tf.sharded_lm_loss(model, t(ids1), t(mask1))
            loss.backward()
            grads = {n: p.grad.clone() for n, p in model.named_parameters()
                     if p.requires_grad}
            for g in grads.values():
                for group in (mesh.groups.get("dp"), mesh.groups.get("sp")):
                    comm.all_reduce_(g, group)
            tx.step()
            train_step, eval_step = tf.make_lm_steps(model, tx)
            _, loss2 = train_step(None, t(ids2), t(mask2))
            adapters = {n: p.detach() for n, p in model.named_parameters()
                        if p.requires_grad}
            row = {"loss": float(loss), "loss2": float(loss2),
                   "eval": float(eval_step(t(ids2), t(mask2))),
                   "grads": np_(tl.gather_state(grads, mesh)),
                   "adapters": np_(tl.gather_state(adapters, mesh))}
            if save:
                tuner = tf.LoraFinetuner(model, fcfg, run_dir=work + "/" + save)
                tuner.save_adapters(model, "adapters")
                fresh = tl.build_llama(cfg, "cpu", seed=None, mesh=mesh,
                                       cls=tl.LlamaForCausalLM)
                fresh.load_state_dict(tl.shard_state(job["state"], mesh))
                tuner.load_adapters(fresh, "adapters")
                row["reloaded"] = all(
                    torch.equal(p, adapters[n])
                    for n, p in fresh.named_parameters() if n in adapters)
            out[key] = row
        for key, axes, case in job["ring"]:
            mesh = build_mesh(MeshConfig(**axes))
            q, k, v, mask, causal, cot = case
            q, k, v = (t(a).requires_grad_() for a in (q, k, v))
            o = ring_attention_sharded(q, k, v, mesh, causal=causal,
                                       kv_mask=None if mask is None
                                       else t(mask))
            (o * t(cot)).sum().backward()
            grads = [a.grad for a in (q, k, v)]
            for g in grads:
                for group in (mesh.groups.get("dp"), mesh.groups.get("sp")):
                    comm.all_reduce_(g, group)
            out[key] = [g.numpy() for g in grads]
        if "comm" in job:
            group = dist.group.WORLD
            X, C, Cs = (t(a) for a in job["comm"])
            rows = slice(rank * (X.shape[0] // world),
                         (rank + 1) * (X.shape[0] // world))
            got = {}
            x = X[rows].clone().requires_grad_()
            (comm.all_gather(x, group, 0) * C).sum().backward()
            got["gather_slice"] = x.grad.numpy()
            x = X[rows].clone().requires_grad_()
            (comm.all_gather(x, group, 0, "sum") * Cs[rank]).sum().backward()
            got["gather_sum"] = x.grad.numpy()
            x = X[rows].clone().requires_grad_()
            (comm.all_reduce(x * 1.0, group) * C[:len(x)]).sum().backward()
            got["all_reduce"] = x.grad.numpy()
            x = X.clone().requires_grad_()
            (comm.copy(x, group) * Cs[rank]).sum().backward()
            got["copy"] = x.grad.numpy()
            x = X[rows].clone().requires_grad_()
            m = torch.full((2,), rank, dtype=torch.uint8)
            y, m_got = comm.ring_pass((x, m), group)
            (y * Cs[rank][rows]).sum().backward()
            got["ring_pass"] = x.grad.numpy()
            got["ring_mask"] = m_got.numpy()
            out["comm"] = got
        for key, axes in job["joint"]:
            mesh = build_mesh(MeshConfig(**axes))
            llm = tl.build_llama(tl.tiny_llama(vocab_size=job["vocab"]),
                                 "cpu", seed=None, mesh=mesh)
            llm.load_state_dict(tl.shard_state(job["joint_llm"], mesh))
            fus = build_fusion(GGNNConfig(), job["input_dim"],
                               llm.cfg.hidden_size, dropout_rate=0.0,
                               device="cpu")
            fus.load_state_dict(job["joint_fusion"])
            trainer = tj.JointTrainer(
                llm, fus, tj.JointConfig(**job["joint_cfg"]),
                GraphJoin(job["graphs"], max_nodes=512, max_edges=2048))
            state = trainer.train(*job["joint_data"])
            out[key] = {"history": trainer.history, "step": state.step,
                        "params": np_(dict(state.params.named_parameters()))}
        pickle.dump(out, open(f"{work}/rank{rank}.pkl", "wb"))
    finally:
        dist.destroy_process_group()
""")

# (axes, attn_impl, remat); the first of each world also saves its adapters
LORA_CASES = {
    2: [(dict(tp=2), "full", False), (dict(fsdp=2), "full", False),
        (dict(dp=2), "full", False), (dict(sp=2), "ring", False),
        (dict(sp=2), "full", False), (dict(tp=2), "full", True),
        (dict(sp=2), "ring", True)],
    4: [(dict(fsdp=2, tp=2), "full", False), (dict(dp=2, tp=2), "full", False),
        (dict(tp=2, sp=2), "ring", False), (dict(dp=2, sp=2), "ring", False),
        (dict(dp=2, fsdp=2), "full", False), (dict(fsdp=2, tp=2), "full", True)],
}
RING = {2: [dict(sp=2)], 4: [dict(sp=4), dict(dp=2, sp=2), dict(tp=2, sp=2)]}
RING_CASES = ["causal", "not_causal", "gqa", "padding", "row_without_key"]
JOINT = {2: [dict(tp=2), dict(fsdp=2)], 4: [dict(fsdp=2, tp=2)]}


def _key(*parts) -> str:
    return "/".join(str(p) for p in parts)


def _axes(axes: dict) -> dict:
    return {"dp": 1, **axes}


def _name(axes: dict) -> str:
    return "-".join(f"{k}{v}" for k, v in axes.items())


@pytest.fixture(scope="module")
def params():
    """JAX ``LlamaForCausalLM(tiny_llama(lora_rank=4))`` parameters, the
    adapters' B drawn nonzero, and the port's state of the same values."""
    model = jl.LlamaForCausalLM(jl.tiny_llama(lora_rank=LORA))
    p = nn.meta.unbox(model.init(jax.random.key(0),
                                 np.zeros((2, 16), np.int32))["params"])
    p = jax.tree.map(np.asarray, p)
    rng = np.random.default_rng(5)
    for layer in p["model"].values():
        if isinstance(layer, dict) and "self_attn" in layer:
            for name in ("lora_q", "lora_v"):
                b = layer["self_attn"][name]["lora_b"]
                layer["self_attn"][name]["lora_b"] = rng.normal(
                    size=b.shape).astype(np.float32) * 0.1
    return p, bridge.llama_flax_to_torch(p)


def _batches():
    """Two batches of ``[4, 16]`` ids with left padding."""
    out = []
    for seed in (9, 10):
        rng = np.random.default_rng(seed)
        ids = rng.integers(0, 320, (4, 16)).astype(np.int64)
        mask = np.ones((4, 16), bool)
        mask[1, :5] = False
        mask[3, :2 + seed % 2] = False
        out.append((ids, mask))
    return out


def _ring_case(name: str):
    rng = np.random.default_rng(len(name))
    b, s, h, d = 2, 16, 4, 16
    h_kv = 2 if name == "gqa" else h
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, h_kv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, h_kv, d)).astype(np.float32)
    cot = rng.normal(size=(b, s, h, d)).astype(np.float32)
    mask = None
    if name in ("padding", "row_without_key"):
        mask = np.ones((b, s), bool)
        mask[0, :5] = False  # left padding: rows 0-4 see no key (causal)
        if name == "padding":
            mask[1, 11:] = False  # right padding
    return q, k, v, mask, name != "not_causal", cot


def _comm_inputs(world: int):
    rng = np.random.default_rng(31)
    X = rng.normal(size=(4 * world, 3)).astype(np.float32)
    C = rng.normal(size=X.shape).astype(np.float32)
    Cs = rng.normal(size=(world, *X.shape)).astype(np.float32)
    return X, C, Cs


# ------------------------------------------------------------ JAX side


def _jax_lora(p, impl: str, axes: dict) -> dict:
    """Loss and adapter gradients of batch 1, then two JAX train steps
    (batches 1 and 2): the adapters after them, as the port's names."""
    (ids1, mask1), (ids2, mask2) = _batches()
    if impl == "ring":
        n = axes.get("dp", 1) * axes.get("sp", 1)
        mesh = jlocal_mesh(n, dp=axes.get("dp", 1), sp=axes.get("sp", 1))
        model = jl.LlamaForCausalLM(jl.tiny_llama(lora_rank=LORA,
                                                  attn_impl="ring"),
                                    mesh=mesh)
    else:
        model = jl.LlamaForCausalLM(jl.tiny_llama(lora_rank=LORA))
    cfg = jft.FinetuneConfig(learning_rate=LR, max_grad_norm=CLIP)
    tx = jft.lora_optimizer(cfg, p, total_steps=2)
    train_step, eval_step = jft.make_lm_steps(model, tx)

    @jax.jit
    def value_and_grad(params, ids, mask):
        return jax.value_and_grad(lambda q: jft.lm_loss(
            model.apply({"params": q}, ids, mask), ids, mask))(params)

    loss, grads = value_and_grad(p, jnp.asarray(ids1), jnp.asarray(mask1))
    state = jft.FinetuneState(p, tx.init(p), jax.random.key(0),
                              jnp.zeros((), jnp.int32))
    state, _ = train_step(state, jnp.asarray(ids1), jnp.asarray(mask1))
    state, loss2 = train_step(state, jnp.asarray(ids2), jnp.asarray(mask2))
    torch_of = lambda tree: split_lora(bridge.llama_flax_to_torch(  # noqa: E731
        jax.tree.map(np.asarray, tree)))[0]
    return {"loss": float(loss), "loss2": float(loss2),
            "eval": float(eval_step(state.params, jnp.asarray(ids2),
                                    jnp.asarray(mask2))),
            "grads": torch_of(grads), "adapters": torch_of(state.params)}


@pytest.fixture(scope="module")
def jax_lora(params):
    p, _ = params
    out = {("full", ()): _jax_lora(p, "full", {})}
    for rows in LORA_CASES.values():
        for axes, impl, _ in rows:
            mesh_key = (axes.get("dp", 1), axes.get("sp", 1))
            if impl == "ring" and ("ring", mesh_key) not in out:
                out[("ring", mesh_key)] = _jax_lora(p, "ring", axes)
    return out


def _jax_ref(jax_lora, axes, impl):
    if impl == "ring":
        return jax_lora[("ring", (axes.get("dp", 1), axes.get("sp", 1)))]
    return jax_lora[("full", ())]


@pytest.fixture(scope="module")
def joint_setup():
    """The JAX trainer's two steps (8 examples, batch 4, the first update
    at lr 0) and what a rank needs to run the port's."""
    llm_cfg = jl.tiny_llama(vocab_size=JOINT_VOCAB)
    llm_params = jax.tree.map(np.asarray, nn.meta.unbox(
        jl.LlamaModel(llm_cfg).init(jax.random.key(0), np.zeros(
            (2, JOINT_BLOCK), np.int32))["params"]))
    kw = dict(block_size=JOINT_BLOCK, epochs=1, learning_rate=JOINT_LR,
              seed=3, weight_decay=0.01, first_eval_steps=1, eval_steps=1)
    rng = np.random.default_rng(41)
    words = ["int", "buf", "len", "memcpy", "if", "ptr", "free", "while"]
    texts = ["void f_%d(int a) { %s; }" % (i, " ".join(rng.choice(
        words, size=int(rng.integers(3, 60))))) for i in range(12)]
    labels = [i % 2 for i in range(12)]

    def examples(ds, lo, hi):
        ex = ds.encode_functions(texts[lo:hi], labels[lo:hi],
                                 ds.HashTokenizer(JOINT_VOCAB), JOINT_BLOCK)
        return type(ex)(ex.input_ids, ex.labels, ex.indices + lo,
                        ex.pad_mask)

    jg = jdataset(12, seed=7, input_dim=INPUT_DIM, mean_nodes=30)
    tg = random_dataset(12, seed=7, input_dim=INPUT_DIM, mean_nodes=30)
    jfus = jfusion.FusionModel(gnn_cfg=JCfg(), input_dim=INPUT_DIM,
                               llm_hidden_size=llm_cfg.hidden_size,
                               dropout_rate=0.0, pool="last")
    jcfg = jjoint.JointConfig(**kw)
    trainer = jjoint.JointTrainer(
        jl.LlamaModel(llm_cfg), llm_params, jfus, jcfg,
        jds.GraphJoin(dict(enumerate(jg)), max_nodes=512, max_edges=2048))
    train, evals = examples(jds, 0, 8), examples(jds, 8, 12)
    first = trainer._joined(next(jds.text_batches(train, 4)))
    state = trainer._build(2, first)
    start = bridge.fusion_flax_to_torch(jax.tree.map(np.asarray,
                                                     state.params),
                                        GGNNConfig(), INPUT_DIM)
    state = trainer.train(train, evals, state=state)
    want = bridge.fusion_flax_to_torch(jax.tree.map(np.asarray,
                                                    state.params),
                                       GGNNConfig(), INPUT_DIM)
    job = {"vocab": JOINT_VOCAB, "input_dim": INPUT_DIM, "joint_cfg": kw,
           "joint_llm": bridge.llama_flax_to_torch(llm_params),
           "joint_fusion": start, "graphs": dict(enumerate(tg)),
           "joint_data": (examples(tds, 0, 8), examples(tds, 8, 12))}
    return job, trainer.history, want, start


# ------------------------------------------------------------ the ranks


def _run_world(world: int, work: Path, params, joint_job) -> list[dict]:
    _, state = params
    job = {
        "state": state, "lora_rank": LORA, "lr": LR, "clip": CLIP,
        "batches": _batches(),
        "lora": [(_key("lora", _name(a), impl, remat), _axes(a), impl, remat,
                  f"saved_{world}" if i == 0 else None)
                 for i, (a, impl, remat) in enumerate(LORA_CASES[world])],
        "ring": [(_key("ring", _name(a), c), _axes(a), _ring_case(c))
                 for a in RING[world] for c in RING_CASES],
        "joint": [(_key("joint", _name(a)), _axes(a)) for a in JOINT[world]],
        **joint_job,
    }
    if world == 2:
        job["comm"] = _comm_inputs(world)
    (work / "in.pkl").write_bytes(pickle.dumps(job))
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    env.pop("DEEPDFA_FAULTS", None)
    procs = [subprocess.Popen([sys.executable, "-c", RANK_MAIN, str(r),
                               str(world), str(work)], env=env, cwd=str(work),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(world)]
    for p in procs:
        try:
            _, err = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.wait()
            pytest.fail(f"a gloo rank of {world} did not finish within 120 s")
        assert p.returncode == 0, err.decode()[-3000:]
    return [pickle.loads((work / f"rank{r}.pkl").read_bytes())
            for r in range(world)]


@pytest.fixture(scope="module")
def ranks(params, joint_setup, tmp_path_factory):
    """Every job's output on every rank, for worlds of 2 and 4, and each
    world's directory."""
    out = {}
    for world in (2, 4):
        work = tmp_path_factory.mktemp(f"world{world}")
        out[world] = (_run_world(world, work, params, joint_setup[0]), work)
    return out


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _cases(table):
    return [(w, *row) for w, rows in table.items() for row in rows]


def _ids(table):
    return [f"{w}-{_name(a)}-{impl}" + ("-remat" if remat else "")
            for w, a, impl, remat in _cases(table)]


# ------------------------------------------------------------- LoRA step


@pytest.mark.parametrize("world,axes,impl,remat", _cases(LORA_CASES),
                         ids=_ids(LORA_CASES))
def test_sharded_lora_step_matches_the_jax_step(jax_lora, ranks, world, axes,
                                                impl, remat):
    outs, _ = ranks[world]
    want = _jax_ref(jax_lora, axes, impl)
    key = _key("lora", _name(axes), impl, remat)
    for out in outs:
        got = out[key]
        for name in ("loss", "loss2", "eval"):
            assert got[name] == pytest.approx(want[name], rel=LOSS_TOL), name
        assert got["grads"].keys() == want["grads"].keys()
        for name, g in want["grads"].items():
            assert got["grads"][name].shape == tuple(g.shape), name
            assert _rel(got["grads"][name], g.numpy()) <= GRAD_TOL, name
        for name, a in want["adapters"].items():
            assert _rel(got["adapters"][name], a.numpy()) <= STEP_TOL, name
        for name in ("grads", "adapters"):
            for n, v in got[name].items():
                assert np.array_equal(v, outs[0][key][name][n]), n


def test_the_clip_engages_and_the_adapters_move(params, jax_lora):
    """The cases above are worth something: the clip scales the step and
    the second update moves every adapter by about lr."""
    _, state = params
    want = jax_lora[("full", ())]
    norm = np.sqrt(sum(float((g.numpy() ** 2).sum())
                       for g in want["grads"].values()))
    assert norm > 10 * CLIP
    start, _ = split_lora(state)
    for name, a in want["adapters"].items():
        assert float((a - start[name]).abs().max()) > LR / 2, name


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_save_is_the_unsharded_save(params, ranks, world, tmp_path):
    """The adapters a sharded run saves: the names, shapes and values that
    the unsharded model's ``save_adapters`` writes for the same adapters;
    loaded onto a sharded model they are the shards again."""
    _, state = params
    outs, work = ranks[world]
    axes, impl, remat = LORA_CASES[world][0]
    row = outs[0][_key("lora", _name(axes), impl, remat)]
    assert all(o[_key("lora", _name(axes), impl, remat)]["reloaded"]
               for o in outs)
    model = tl.build_llama(tl.tiny_llama(lora_rank=LORA), "cpu", seed=None,
                           cls=tl.LlamaForCausalLM)
    model.load_state_dict({**state, **{k: torch.from_numpy(v) for k, v in
                                       row["adapters"].items()}})
    tuner = tft.LoraFinetuner(model, tft.FinetuneConfig(), run_dir=tmp_path)
    tuner.save_adapters(model, "adapters")
    want = torch.load(tmp_path / "adapters" / "state.pt", weights_only=True)
    got = torch.load(work / f"saved_{world}" / "adapters" / "state.pt",
                     weights_only=True)
    assert list(got) == list(want)
    for name, w in want.items():
        assert got[name].shape == w.shape and got[name].dtype == w.dtype
        assert torch.equal(got[name], w), name
    assert (work / f"saved_{world}" / "adapters" / "meta.json").read_text() \
        == (tmp_path / "adapters" / "meta.json").read_text()
    # the unsharded model loads it, and so does a fresh finetuner's model
    fresh = tl.build_llama(tl.tiny_llama(lora_rank=LORA), "cpu", seed=None,
                           cls=tl.LlamaForCausalLM)
    fresh.load_state_dict(state)
    tft.LoraFinetuner(fresh, tft.FinetuneConfig(),
                      run_dir=work / f"saved_{world}").load_adapters(
        fresh, "adapters")
    for name, w in want.items():
        assert torch.equal(fresh.state_dict()[name], w), name


# ------------------------------------------------------------------ ring

RING_ALL = [(w, a, c) for w, rows in RING.items() for a in rows
            for c in RING_CASES]


@pytest.mark.parametrize("world,axes,case", RING_ALL, ids=[
    f"{w}-{_name(a)}-{c}" for w, a, c in RING_ALL])
def test_ring_backward_matches_jax_grad_of_full_attention(ranks, world, axes,
                                                          case):
    outs, _ = ranks[world]
    q, k, v, mask, causal, cot = _ring_case(case)
    _, vjp = jax.vjp(lambda a, b, c: jfull(
        a, b, c, causal=causal,
        kv_mask=None if mask is None else jnp.asarray(mask)),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g) for g in vjp(jnp.asarray(cot))]
    for out in outs:
        got = out[_key("ring", _name(axes), case)]
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert _rel(g, w) <= RING_TOL
        if case == "row_without_key":
            assert not got[0][0, :5].any()  # dq of rows with no key: zeros
        for g, first in zip(got, outs[0][_key("ring", _name(axes), case)]):
            assert np.array_equal(g, first)


# ----------------------------------------------------------- collectives

COMM_CASES = ["gather_slice", "gather_sum", "all_reduce", "copy",
              "ring_pass"]


@pytest.mark.parametrize("case", COMM_CASES)
def test_collective_backward_matches_one_process(ranks, case):
    """Each collective's backward on 2 ranks against autograd of the same
    computation on the whole tensors in this process: what every rank
    computes, summed where the ranks' losses are parts (``comm``'s
    convention)."""
    outs, _ = ranks[2]
    world = 2
    X, C, Cs = (torch.from_numpy(a) for a in _comm_inputs(world))
    n = X.shape[0] // world
    blocks = [slice(r * n, (r + 1) * n) for r in range(world)]
    xs = [X[b].clone().requires_grad_() for b in blocks]
    whole = X.clone().requires_grad_()
    if case == "gather_slice":  # the same loss on every rank
        (torch.cat(xs) * C).sum().backward()
    elif case == "gather_sum":  # each rank's own part of the loss
        sum((torch.cat(xs) * Cs[r]).sum() for r in range(world)).backward()
    elif case == "all_reduce":  # the summed output used alike everywhere
        (sum(xs) * C[blocks[0]]).sum().backward()
    elif case == "copy":  # one replicated input, each rank its own use
        sum((whole * Cs[r]).sum() for r in range(world)).backward()
    else:  # rank r gets rank r-1's block
        sum((xs[(r - 1) % world] * Cs[r][blocks[r]]).sum()
            for r in range(world)).backward()
    for r, out in enumerate(outs):
        got = out["comm"][case]
        want = whole.grad if case == "copy" else xs[r].grad
        np.testing.assert_allclose(got, want.numpy(), atol=COMM_TOL, rtol=0)
    if case == "ring_pass":  # the mask travelled one rank forward
        for r, out in enumerate(outs):
            assert (out["comm"]["ring_mask"] == (r - 1) % world).all()


# ----------------------------------------------------------------- joint

JOINT_ALL = [(w, a) for w, rows in JOINT.items() for a in rows]


@pytest.mark.parametrize("world,axes", JOINT_ALL, ids=[
    f"{w}-{_name(a)}" for w, a in JOINT_ALL])
def test_joint_trainer_over_a_sharded_llm_matches_the_jax_trainer(
        joint_setup, ranks, world, axes):
    _, history, want, start = joint_setup
    outs, _ = ranks[world]
    for out in outs:
        got = out[_key("joint", _name(axes))]
        assert got["step"] == 2
        assert len(got["history"]) == len(history)
        for g, w in zip(got["history"], history):
            assert set(g) == set(w)
            for k, value in w.items():
                if k.endswith("loss"):
                    assert g[k] == pytest.approx(float(value), rel=1e-5), k
        for name, w in want.items():
            g = got["params"][name]
            assert float(np.abs(g - w.numpy()).max()) <= 2 * JOINT_LR * 2, \
                name
            assert np.array_equal(g, outs[0][_key("joint", _name(axes))][
                "params"][name]), name
        moved = max(float((w - start[n]).abs().max())
                    for n, w in want.items())
        assert moved > 0


# ------------------------------------------------------------- world of one


def test_a_world_of_one_trains_as_the_unsharded_model(params):
    """Over a mesh of one device (no collective) the sharded step is the
    unsharded step: loss and adapter gradients within 1e-6."""
    from deepdfa_tpu_torch.parallel.mesh import local_mesh

    _, state = params
    (ids, mask), _ = _batches()
    ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
    full = tl.build_llama(tl.tiny_llama(lora_rank=LORA), "cpu", seed=None,
                          cls=tl.LlamaForCausalLM)
    full.load_state_dict(state)
    mesh = local_mesh(1, device="cpu")
    sharded = tl.build_llama(tl.tiny_llama(lora_rank=LORA), "cpu", seed=None,
                             cls=tl.LlamaForCausalLM, mesh=mesh)
    sharded.load_state_dict(tl.shard_state(state, mesh))
    grads = []
    for model, loss_fn in ((full, lambda: tft.lm_loss(model(ids, mask), ids,
                                                      mask)),
                           (sharded, lambda: tft.sharded_lm_loss(
                               model, ids, mask))):
        tft.lora_optimizer(tft.FinetuneConfig(), model, 1)
        loss = loss_fn()
        loss.backward()
        grads.append((float(loss), {n: p.grad for n, p in
                                    model.named_parameters()
                                    if p.requires_grad}))
    assert grads[1][0] == pytest.approx(grads[0][0], rel=1e-6)
    for name, g in grads[0][1].items():
        assert _rel(grads[1][1][name], g) <= 1e-6, name
