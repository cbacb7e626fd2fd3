"""The port's sharded LLM (``fsdp``/``tp``/``sp`` in
``deepdfa_tpu_torch/parallel/mesh.py``, ``llm/llama.py``'s placement and
sharded forward, ``ops/ring_attention.py``'s ring, ``JointEngine(mesh=)``)
against the JAX package, on the CPU.

Ranks are ``python -c`` children over gloo (a ``FileStore``, a 60 s join),
two and four of them, as in ``tests/test_torch_dp.py``; each runs every
job of its world once (a module fixture) and writes what it got. The JAX
side runs in this process on conftest's host devices.

- each rank's shard of every ``tiny_llama`` parameter (LoRA adapters
  included) equals the shard that the JAX ``mesh_shardings`` places on the
  device at the same mesh position: shape and values exact (through the
  bridge's transposes);
- the sharded ``LlamaForCausalLM`` logits (``tp``, ``fsdp``, ``dp``,
  ``sp`` and their pairs) and the ``sp`` ring's hidden states against the
  JAX unsharded forward: within 1e-5 of the largest value, float32 (the
  row-parallel sums and the ring's online softmax add in other orders);
- ring attention against the JAX ``full_attention``: causal or not, GQA,
  padding, a query row with no key (zeros): within 1e-5 of the largest;
- ``JointEngine.from_run_dir(mesh=)`` against the JAX engine's eval step
  built unsharded on the same carried-across weights: within 1e-5 (the
  JAX sharded route cannot place its weights, ROADMAP queue C);
- every rank gets the same output; ``int8_runtime`` with a mesh and
  ``"ring"`` without one are refused as in the JAX package; the sharded
  path under grad builds a backward (held against JAX's gradients in
  ``tests/test_torch_shard_train.py``).
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
from deepdfa_tpu.llm import fusion as jfusion  # noqa: E402
from deepdfa_tpu.llm import joint as jjoint  # noqa: E402
from deepdfa_tpu.llm import llama as jl  # noqa: E402
from deepdfa_tpu.data.graphs import batch_np as jbatch_np  # noqa: E402
from deepdfa_tpu.ops.ring_attention import full_attention as jfull  # noqa: E402
from deepdfa_tpu.parallel.mesh import local_mesh as jlocal_mesh  # noqa: E402

from deepdfa_tpu_torch import bridge  # noqa: E402
from deepdfa_tpu_torch.config import GGNNConfig  # noqa: E402
from deepdfa_tpu_torch.data.synthetic import random_dataset  # noqa: E402
from deepdfa_tpu_torch.llm import joint as tjoint  # noqa: E402
from deepdfa_tpu_torch.llm import llama as tl  # noqa: E402
from deepdfa_tpu_torch.parallel.mesh import local_mesh  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-5
LORA = 4
BLOCK = 32
INPUT_DIM = 1002
RANK_MAIN = textwrap.dedent("""
    import pickle, sys
    import torch
    import torch.distributed as dist
    from deepdfa_tpu_torch.config import MeshConfig
    from deepdfa_tpu_torch.llm import llama as tl
    from deepdfa_tpu_torch.llm.joint import JointConfig
    from deepdfa_tpu_torch.llm.joint_engine import JointEngine
    from deepdfa_tpu_torch.ops.ring_attention import ring_attention_sharded
    from deepdfa_tpu_torch.parallel.mesh import (build_mesh,
                                                 initialize_multihost)

    rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    store = dist.FileStore(work + "/store", world)
    initialize_multihost(num_processes=world, process_id=rank,
                         backend="gloo", store=store, timeout_s=50)
    try:
        job = pickle.load(open(work + "/in.pkl", "rb"))
        state, out = job["state"], {}
        t = lambda a: torch.from_numpy(a)
        for key, axes in job["placement"]:
            mesh = build_mesh(MeshConfig(**axes))
            out[key] = ({k: v.numpy() for k, v in
                         tl.shard_state(state, mesh).items()}, mesh.coords)
        with torch.no_grad():
            for key, axes, impl, cls in job["forward"]:
                mesh = build_mesh(MeshConfig(**axes))
                cfg = tl.tiny_llama(lora_rank=job["lora"], attn_impl=impl)
                model = tl.build_llama(cfg, "cpu", seed=None, mesh=mesh,
                                       cls=getattr(tl, cls))
                full = state if cls == "LlamaForCausalLM" else {
                    k[len("model."):]: v for k, v in state.items()
                    if k.startswith("model.")}
                model.load_state_dict(tl.shard_state(full, mesh))
                out[key] = model(t(job["ids"]), t(job["mask"])).numpy()
            for key, axes, case in job["ring"]:
                mesh = build_mesh(MeshConfig(**axes))
                q, k, v, mask, causal = case
                out[key] = ring_attention_sharded(
                    t(q), t(k), t(v), mesh, causal=causal,
                    kv_mask=None if mask is None else t(mask)).numpy()
            for key, axes in job["engine"]:
                mesh = build_mesh(MeshConfig(**axes))
                engine = JointEngine.from_run_dir(
                    job["run_dir"], jcfg=JointConfig(block_size=job["block"]),
                    llm_state=job["engine_state"], max_nodes=1024,
                    max_edges=4096, mesh=mesh, device="cpu")
                out[key] = engine.score(job["items"])
        pickle.dump(out, open(f"{work}/rank{rank}.pkl", "wb"))
    finally:
        dist.destroy_process_group()
""")

PLACEMENT = {2: [dict(fsdp=2), dict(tp=2), dict(sp=2), dict(dp=2)],
             4: [dict(fsdp=2, tp=2), dict(tp=4), dict(dp=2, tp=2),
                 dict(fsdp=4), dict(tp=2, sp=2)]}
FORWARD = {2: [dict(tp=2), dict(fsdp=2), dict(dp=2), dict(sp=2)],
           4: [dict(fsdp=2, tp=2), dict(tp=2, sp=2), dict(dp=2, tp=2),
               dict(fsdp=2, sp=2)]}
RING = {2: [dict(sp=2), dict(tp=2, sp=1)],
        4: [dict(sp=4), dict(tp=2, sp=2), dict(dp=2, sp=2)]}
RING_CASES = ["causal", "not_causal", "gqa", "padding", "row_without_key"]
ENGINE = {2: [dict(tp=2)], 4: [dict(fsdp=2, tp=2)]}


def _key(*parts) -> str:
    return "/".join(str(p) for p in parts)


def _axes(axes: dict) -> dict:
    return {"dp": 1, **axes}


def _cfg(**kw):
    return jl.tiny_llama(lora_rank=LORA, **kw)


@pytest.fixture(scope="module")
def params():
    """JAX ``LlamaForCausalLM(tiny_llama(lora_rank=4))`` parameters, the
    adapters' B drawn nonzero, and the port's state of the same values."""
    model = jl.LlamaForCausalLM(_cfg())
    p = nn.meta.unbox(model.init(jax.random.key(0),
                                 np.zeros((2, 16), np.int32))["params"])
    p = jax.tree.map(np.asarray, p)
    rng = np.random.default_rng(5)
    for layer in p["model"].values():
        for name in ("lora_q", "lora_v"):
            if isinstance(layer, dict) and "self_attn" in layer:
                b = layer["self_attn"][name]["lora_b"]
                layer["self_attn"][name]["lora_b"] = rng.normal(
                    size=b.shape).astype(np.float32) * 0.1
    return p, bridge.llama_flax_to_torch(p)


def _inputs():
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 320, (4, 16)).astype(np.int64)
    mask = np.ones((4, 16), bool)
    mask[1, :5] = False
    mask[3, :2] = False
    return ids, mask


def _ring_case(name: str):
    rng = np.random.default_rng(len(name))
    b, s, h, d = 2, 16, 4, 16
    h_kv = 2 if name == "gqa" else h
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, h_kv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, h_kv, d)).astype(np.float32)
    mask = None
    if name in ("padding", "row_without_key"):
        mask = np.ones((b, s), bool)
        mask[0, :5] = False  # left padding: rows 0-4 see no key (causal)
        if name == "padding":
            mask[1, 11:] = False  # right padding
    return q, k, v, mask, name != "not_causal"


def _engine_setup(tmp: Path):
    """tiny_llama(vocab 2048) + the golden GGNN + the fusion head: JAX
    scores of six items, and the port's fusion epoch and LLM state."""
    llm_cfg = jl.tiny_llama(vocab_size=2048)
    jllm = jl.LlamaModel(llm_cfg)
    llm_params = jax.tree.map(np.asarray, nn.meta.unbox(jllm.init(
        jax.random.key(0), np.zeros((2, BLOCK), np.int32))["params"]))
    jfus = jfusion.FusionModel(gnn_cfg=JCfg(), input_dim=INPUT_DIM,
                               llm_hidden_size=llm_cfg.hidden_size,
                               dropout_rate=0.1, pool="last")
    graphs = jdataset(6, seed=22, input_dim=INPUT_DIM, mean_nodes=30)
    fus_params = jax.tree.map(np.asarray, jfus.init(
        {"params": jax.random.key(1), "dropout": jax.random.key(2)},
        np.zeros((2, BLOCK, llm_cfg.hidden_size), np.float32),
        jbatch_np(graphs[:2], 3, 512, 2048), deterministic=True,
        token_mask=np.ones((2, BLOCK), bool))["params"])
    tjoint.save_fusion_epoch(tmp, 1, bridge.fusion_flax_to_torch(
        fus_params, GGNNConfig(), INPUT_DIM))
    rng = np.random.default_rng(21)
    texts = ["void f_%d(int a) { %s; }" % (i, " ".join(rng.choice(
        ["int", "buf", "len", "memcpy", "if", "ptr", "free"],
        size=int(rng.integers(3, 60))))) for i in range(6)]
    _, eval_step = jjoint.make_joint_steps(jllm, jfus, None)
    tok = jds.HashTokenizer(2048)
    want = []
    for start in (0, 4):
        chunk = list(zip(texts, graphs))[start: start + 4]
        ex = jds.encode_functions([t for t, _ in chunk], [0] * len(chunk),
                                  tok, BLOCK)
        join = jds.GraphJoin(graphs={i: g for i, (_, g) in enumerate(chunk)},
                             max_nodes=1024, max_edges=4096)
        _, probs = eval_step(fus_params, llm_params,
                             join.join(next(jds.text_batches(ex, 4))))
        want.append(np.asarray(probs)[: len(chunk), 1])
    items = list(zip(texts, random_dataset(6, seed=22, input_dim=INPUT_DIM,
                                           mean_nodes=30)))
    return (np.concatenate(want), items,
            bridge.llama_flax_to_torch(llm_params))


def _run_world(world: int, work: Path, params) -> list[dict]:
    _, state = params
    ids, mask = _inputs()
    want, items, engine_state = _engine_setup(work / "fusion_run")
    job = {
        "state": state, "lora": LORA, "ids": ids, "mask": mask,
        "placement": [(_key("place", a), _axes(a)) for a in PLACEMENT[world]],
        "forward": [(_key("fwd", a, impl, cls), _axes(a), impl, cls)
                    for a in FORWARD[world]
                    for impl, cls in (("full", "LlamaForCausalLM"),
                                      ("ring", "LlamaModel"))],
        "ring": [(_key("ring", a, c), _axes(a), _ring_case(c))
                 for a in RING[world] for c in RING_CASES],
        "engine": [(_key("engine", a), _axes(a)) for a in ENGINE[world]],
        "run_dir": str(work / "fusion_run"), "block": BLOCK,
        "engine_state": engine_state, "items": items,
    }
    (work / "in.pkl").write_bytes(pickle.dumps(job))
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    env.pop("DEEPDFA_FAULTS", None)
    procs = [subprocess.Popen([sys.executable, "-c", RANK_MAIN, str(r),
                               str(world), str(work)], env=env, cwd=str(work),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(world)]
    for p in procs:
        try:
            _, err = p.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.wait()
            pytest.fail(f"a gloo rank of {world} did not finish within 60 s")
        assert p.returncode == 0, err.decode()[-3000:]
    outs = [pickle.loads((work / f"rank{r}.pkl").read_bytes())
            for r in range(world)]
    return outs, want


@pytest.fixture(scope="module")
def ranks(params, tmp_path_factory):
    """Every job's output on every rank, for worlds of 2 and 4."""
    out = {}
    for world in (2, 4):
        work = tmp_path_factory.mktemp(f"world{world}")
        out[world] = _run_world(world, work, params)
    return out


def _close(got, want, tol=TOL):
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= tol * scale, (err, scale)


def _cases(table):
    return [(w, a) for w, rows in table.items() for a in rows]


def _ids(table):
    return [f"{w}-{'-'.join(f'{k}{v}' for k, v in a.items())}"
            for w, a in _cases(table)]


# --------------------------------------------------------------- placement


@pytest.mark.parametrize("world,axes", _cases(PLACEMENT), ids=_ids(PLACEMENT))
def test_every_shard_equals_the_jax_placement(params, ranks, world, axes):
    p, _ = params
    outs, _ = ranks[world]
    jmesh = jlocal_mesh(world, **axes)
    model = jl.LlamaForCausalLM(_cfg())
    shardings, _ = jl.mesh_shardings(model, jmesh,
                                     (np.zeros((2, 16), np.int32),))
    placed = jax.device_put({"params": p}, shardings)["params"]
    devices = list(jmesh.devices.flat)
    for rank, out in enumerate(outs):
        shards, coords = out[_key("place", axes)]
        where = np.argwhere(jmesh.devices == devices[rank])[0]
        assert [coords[a] for a in ("dp", "fsdp", "tp", "sp")] == \
            [int(i) for i in where]
        mine = jax.tree.map(
            lambda x: next(np.asarray(s.data) for s in x.addressable_shards
                           if s.device == devices[rank]), placed)
        want = bridge.llama_flax_to_torch(mine)
        assert shards.keys() == want.keys()
        for name, arr in shards.items():
            assert arr.shape == tuple(want[name].shape), name
            assert np.array_equal(arr, want[name].numpy()), name


def _port_name(path) -> tuple[str, bool]:
    """A flax parameter path as the port's name, and whether the bridge
    transposes it (a projection's kernel)."""
    *mods, leaf = [k.key for k in path]
    mods = [f"layers.{m[len('layers_'):]}" if m.startswith("layers_") else m
            for m in mods]
    name = {"embedding": "weight", "kernel": "weight"}.get(leaf, leaf)
    return ".".join(mods + [name]), leaf == "kernel"


def test_mesh_shardings_are_the_jax_partition_specs(params):
    _, state = params
    jmesh = jlocal_mesh(8, dp=2, fsdp=2, tp=2)
    specs, _ = jl.mesh_shardings(jl.LlamaForCausalLM(_cfg()), jmesh,
                                 (np.zeros((2, 16), np.int32),))
    got = tl.mesh_shardings(state)
    assert set(got) == set(state)
    flat = jax.tree_util.tree_flatten_with_path(
        specs["params"], is_leaf=lambda x: hasattr(x, "spec"))[0]
    assert len(flat) == len(got)
    for path, sharding in flat:
        name, transposed = _port_name(path)
        spec = tuple(sharding.spec) + (None,) * (
            len(got[name]) - len(sharding.spec))
        assert got[name] == (spec[::-1] if transposed else spec), name


# ----------------------------------------------------------------- forward


def _jax_forward(params, cls: str):
    p, _ = params
    ids, mask = _inputs()
    if cls == "LlamaForCausalLM":
        return np.asarray(jl.LlamaForCausalLM(_cfg()).apply(
            {"params": p}, jnp.asarray(ids), jnp.asarray(mask)))
    return np.asarray(jl.LlamaModel(_cfg()).apply(
        {"params": p["model"]}, jnp.asarray(ids), jnp.asarray(mask)))


@pytest.mark.parametrize("world,axes", _cases(FORWARD), ids=_ids(FORWARD))
def test_sharded_logits_match_the_jax_forward(params, ranks, world, axes):
    outs, _ = ranks[world]
    want = _jax_forward(params, "LlamaForCausalLM")
    key = _key("fwd", axes, "full", "LlamaForCausalLM")
    for out in outs:
        assert out[key].shape == want.shape and out[key].dtype == np.float32
        _close(out[key], want)
        assert np.array_equal(out[key], outs[0][key])


@pytest.mark.parametrize("world,axes", _cases(FORWARD), ids=_ids(FORWARD))
def test_ring_hidden_states_match_the_jax_forward(params, ranks, world, axes):
    outs, _ = ranks[world]
    want = _jax_forward(params, "LlamaModel")
    key = _key("fwd", axes, "ring", "LlamaModel")
    for out in outs:
        assert out[key].shape == want.shape
        _close(out[key], want)
        assert np.array_equal(out[key], outs[0][key])


RING_ALL = [(w, a, c) for w, a in _cases(RING) for c in RING_CASES]


@pytest.mark.parametrize("world,axes,case", RING_ALL, ids=[
    f"{w}-{'-'.join(f'{k}{v}' for k, v in a.items())}-{c}"
    for w, a, c in RING_ALL])
def test_ring_attention_matches_full_attention(ranks, world, axes, case):
    outs, _ = ranks[world]
    q, k, v, mask, causal = _ring_case(case)
    want = np.asarray(jfull(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal,
                            kv_mask=None if mask is None else
                            jnp.asarray(mask)))
    for out in outs:
        got = out[_key("ring", axes, case)]
        _close(got, want)
        if case == "row_without_key":
            assert not got[0, :5].any()  # zeros, as full_attention


# ------------------------------------------------------------------ engine


@pytest.mark.parametrize("world,axes", _cases(ENGINE), ids=_ids(ENGINE))
def test_sharded_joint_engine_matches_the_jax_engine(ranks, world, axes):
    outs, want = ranks[world]
    for out in outs:
        got = out[_key("engine", axes)]
        assert got.shape == (6,) and got.dtype == np.float64
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
        assert np.array_equal(got, outs[0][_key("engine", axes)])


# ----------------------------------------------------------------- refusals


def test_int8_with_a_mesh_is_refused_as_jax():
    with pytest.raises(ValueError) as want:
        jl.LlamaModel(jl.tiny_llama(int8_runtime=True),
                      mesh=jlocal_mesh(1)).init(
            jax.random.key(0), np.zeros((1, 4), np.int32))
    with pytest.raises(ValueError) as got:
        tl.LlamaModel(tl.tiny_llama(int8_runtime=True),
                      mesh=local_mesh(1, device="cpu"))
    assert str(got.value) == str(want.value)


def test_ring_without_a_mesh_raises_as_jax():
    with pytest.raises(ValueError, match="requires a mesh") as want:
        jl.LlamaModel(jl.tiny_llama(attn_impl="ring")).init(
            jax.random.key(0), np.zeros((1, 4), np.int32))
    with pytest.raises(ValueError) as got:
        tl.LlamaModel(tl.tiny_llama(attn_impl="ring"))
    assert str(got.value) == str(want.value)


def test_flash_over_a_split_sequence_is_refused():
    """Kernel B6 attends within one block, so ``"flash"`` with ``sp`` > 1
    raises rather than attend through plain torch; ``tp`` alone is fine."""
    with pytest.raises(ValueError, match="attn_impl='ring'"):
        tl.LlamaModel(tl.tiny_llama(attn_impl="flash"),
                      mesh=local_mesh(2, device="cpu", sp=2))
    tl._check_config(tl.tiny_llama(attn_impl="flash"),
                     local_mesh(2, device="cpu", tp=2))


def test_a_group_less_mesh_that_shards_the_llm_is_refused():
    mesh = local_mesh(2, device="cpu", tp=2)
    assert mesh.shards_llm and mesh.replica_devices == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="one process per device"):
        tl.LlamaModel(tl.tiny_llama(), mesh=mesh)


def test_a_world_of_one_runs_the_sharded_path_bitwise(params):
    """A mesh of one device (every axis 1): the sharded modules' forward
    equals the unsharded model's (float32)."""
    _, state = params
    ids, mask = _inputs()
    full = tl.build_llama(tl.tiny_llama(lora_rank=LORA), "cpu", seed=None,
                          cls=tl.LlamaForCausalLM)
    full.load_state_dict(state)
    mesh = local_mesh(1, device="cpu")
    sharded = tl.build_llama(tl.tiny_llama(lora_rank=LORA), "cpu",
                             seed=None, cls=tl.LlamaForCausalLM, mesh=mesh)
    sharded.load_state_dict(tl.shard_state(state, mesh))
    with torch.no_grad():
        a = full(torch.from_numpy(ids), torch.from_numpy(mask))
        b = sharded(torch.from_numpy(ids), torch.from_numpy(mask))
        with pytest.raises(ValueError, match="decode"):
            sharded(torch.from_numpy(ids), decode=True)
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6, rtol=0)
    # with grad on, the sharded path builds its backward (training over
    # shards: tests/test_torch_shard_train.py) and gives the same logits
    c = sharded(torch.from_numpy(ids), torch.from_numpy(mask))
    assert c.grad_fn is not None
    np.testing.assert_allclose(c.detach().numpy(), b.numpy(), atol=0, rtol=0)
    # drawn from a seed, a sharded model holds the unsharded one's values
    seeded = tl.build_llama(tl.tiny_llama(lora_rank=LORA), "cpu", seed=4,
                            cls=tl.LlamaForCausalLM, mesh=mesh)
    plain = tl.build_llama(tl.tiny_llama(lora_rank=LORA), "cpu", seed=4,
                           cls=tl.LlamaForCausalLM)
    for k, v in plain.state_dict().items():
        assert torch.equal(seeded.state_dict()[k], v), k
