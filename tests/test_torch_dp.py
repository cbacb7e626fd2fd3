"""The port's data parallelism (``deepdfa_tpu_torch/parallel/``) and the
replicated engine against the JAX package on the CPU.

- ``MeshConfig.axis_sizes`` and ``build_mesh`` under ``mesh.device_lost``
  against the JAX mesh (the CPU named once per slot, as the JAX tests name
  their host devices); a mesh with ``fsdp``/``tp``/``sp`` builds (the
  sharded LLM, ``tests/test_torch_shard.py``) and the GGNN's dp steps
  refuse it;
- the dp train and eval steps, segment and dense batches, against
  ``make_dp_train_step`` / ``make_dp_eval_step`` on the JAX
  ``local_mesh(2)``, on the parameters ``bridge.flax_to_torch`` carries
  (plain SGD, so a gradient difference shows in the parameters): in this
  process without a group, and in a world-size-1 gloo group over a
  ``FileStore`` (two slots on the one rank);
- ``stack_batches`` and ``stack_elastic`` against the JAX ones; ``accum``
  equivalence (dp=2 against dp=1 with accum=2);
- two ranks over gloo in child processes against dp=1 with accum=2 in this
  one, and ``mesh.device_lost`` in that world (rank 1 is lost);
- ``elastic_restore`` of the port's own checkpoints across a changed mesh;
- ``score_groups`` of an engine replicated over *k* CPU slots against the
  JAX engine on ``local_mesh(k)``, and the batcher's chunks of replicas.

Tolerances: stacks and mesh sizes exact; the steps' parameters, losses and
confusion counts within 1e-5 (float32 sums in other orders; the JAX test's
own bar); dp=2 against accum=2 within 1e-6; the replicated engine within
1e-5 of JAX and bitwise its own single replica; the elastic restore
bitwise.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from deepdfa_tpu.config import GGNNConfig as JCfg  # noqa: E402
from deepdfa_tpu.config import MeshConfig as JMeshConfig  # noqa: E402
from deepdfa_tpu.data.dense import batch_dense as jbatch_dense  # noqa: E402
from deepdfa_tpu.data.graphs import BucketSpec as JBucket  # noqa: E402
from deepdfa_tpu.data.graphs import GraphBatcher as JBatcher  # noqa: E402
from deepdfa_tpu.data.synthetic import random_dataset as jdataset  # noqa: E402
from deepdfa_tpu.models.ggnn import GGNN as JGGNN  # noqa: E402
from deepdfa_tpu.models.ggnn_dense import GGNNDense as JDense  # noqa: E402
from deepdfa_tpu.parallel import dp as jdp  # noqa: E402
from deepdfa_tpu.parallel import elastic as jelastic  # noqa: E402
from deepdfa_tpu.parallel.mesh import build_mesh as jbuild_mesh  # noqa: E402
from deepdfa_tpu.parallel.mesh import local_mesh as jlocal_mesh  # noqa: E402
from deepdfa_tpu.resilience import faults as jfaults  # noqa: E402
from deepdfa_tpu.serve import ScoringEngine as JEngine  # noqa: E402
from deepdfa_tpu.train.metrics import ConfusionState as JConfusion  # noqa: E402

from deepdfa_tpu_torch import bridge  # noqa: E402
from deepdfa_tpu_torch.config import (ALL_SUBKEYS, CheckpointConfig,  # noqa: E402
                                      GGNNConfig, MeshConfig)
from deepdfa_tpu_torch.data.dense import DenseBatch  # noqa: E402
from deepdfa_tpu_torch.data.graphs import (BatchedGraphs, Graph,  # noqa: E402
                                           to_device)
from deepdfa_tpu_torch.models import make_model  # noqa: E402
from deepdfa_tpu_torch.parallel import dp, elastic  # noqa: E402
from deepdfa_tpu_torch.parallel.mesh import (DeviceLost, build_mesh,  # noqa: E402
                                             initialize_multihost, local_mesh)
from deepdfa_tpu_torch.resilience import faults  # noqa: E402
from deepdfa_tpu_torch.serve import MicroBatcher, ScoringEngine  # noqa: E402
from deepdfa_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from deepdfa_tpu_torch.train.metrics import ConfusionState  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-5
CFG = dict(hidden_dim=8, n_steps=2, num_output_layers=2)
INPUT_DIM = 40
LR = 0.1
KEYS = tuple(f"_ABS_DATAFLOW_{sk}" for sk in ALL_SUBKEYS)
# one rank of the two-rank leg, in a child that imports only the port
RANK_MAIN = textwrap.dedent("""
    import json, pickle, sys
    import torch
    import torch.distributed as dist
    from deepdfa_tpu_torch.config import GGNNConfig, MeshConfig
    from deepdfa_tpu_torch.models import make_model
    from deepdfa_tpu_torch.parallel.dp import (dp_init_state,
                                               make_dp_train_step,
                                               stack_batches)
    from deepdfa_tpu_torch.parallel.mesh import (DeviceLost, build_mesh,
                                                 initialize_multihost)
    from deepdfa_tpu_torch.resilience import faults
    from deepdfa_tpu_torch.train.metrics import ConfusionState

    rank, work = int(sys.argv[1]), sys.argv[2]
    torch.set_num_threads(1)
    store = dist.FileStore(work + "/store", 2)
    initialize_multihost(num_processes=2, process_id=rank, backend="gloo",
                         store=store, timeout_s=50)
    try:
        mesh = build_mesh(MeshConfig())
        batches, cfg_kw, state = pickle.load(open(work + "/in.pkl", "rb"))
        model = make_model(GGNNConfig(**cfg_kw), 40, device="cpu")
        model.load_state_dict(state)
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        st = dp_init_state(model, opt, mesh)
        step = make_dp_train_step(model, opt, mesh, pos_weight=3.0)
        st, m, loss, wsum = step(st, stack_batches(batches),
                                 ConfusionState.zeros())
        with faults.installed("mesh.device_lost@1"):
            try:
                lost = build_mesh(MeshConfig()).size
            except DeviceLost:
                lost = "lost"
        out = {"loss": float(loss), "wsum": float(wsum),
               "metrics": [float(x) for x in m], "lost": lost,
               "slots": list(mesh.local_slots)}
        torch.save({"out": out, "state": model.state_dict()},
                   f"{work}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()
""")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(n_batches, seed=0):
    """``n_batches`` same-bucket segment batches of the JAX generator's
    graphs (8 a batch)."""
    graphs = jdataset(8 * n_batches, seed=seed, input_dim=INPUT_DIM,
                      mean_nodes=10)
    flat = list(JBatcher([JBucket(9, 512, 1024)]).batches(graphs))
    assert len(flat) == n_batches
    return flat


def _dense_flat(n_batches, seed=200):
    corpora = [jdataset(4, seed=seed + i, input_dim=INPUT_DIM, mean_nodes=8)
               for i in range(n_batches)]
    npg = max(g.n_nodes for gs in corpora for g in gs)
    return [jbatch_dense(gs, 4, npg) for gs in corpora]


def _port(batch):
    """A JAX package batch as the port's type (the same numpy arrays)."""
    cls = DenseBatch if hasattr(batch, "adj") else BatchedGraphs
    return cls(*batch)


def _models(layout="segment", seed=0, example=None):
    """(JAX model, JAX params, port model with those params)."""
    jcls = JDense if layout == "dense" else JGGNN
    jmodel = jcls(cfg=JCfg(**CFG), input_dim=INPUT_DIM)
    params = jmodel.init(jax.random.key(seed),
                         jax.tree.map(jnp.asarray, example))["params"]
    cfg = GGNNConfig(**CFG, layout=layout)
    model = make_model(cfg, INPUT_DIM, device="cpu")
    model.load_state_dict(bridge.flax_to_torch(jax.tree.map(np.asarray,
                                                            params),
                                               cfg, INPUT_DIM))
    return jmodel, params, model


def _assert_params_close(model, jparams, layout="segment", tol=TOL):
    cfg = GGNNConfig(**CFG, layout=layout)
    got = bridge.torch_to_flax(model.state_dict(), cfg, INPUT_DIM)
    flat_t = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_j = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jparams))[0]
    assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
    for (path, a), (_, b) in zip(flat_t, flat_j):
        np.testing.assert_allclose(a, b, atol=tol, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


# ------------------------------------------------------------------ mesh


@pytest.mark.parametrize("sizes,n", [
    (dict(), 8), (dict(dp=2), 2), (dict(dp=-1, tp=2), 8),
    (dict(dp=2, fsdp=2, tp=2), 8), (dict(dp=3), 8), (dict(dp=-1, tp=-1), 4),
    (dict(dp=-1, fsdp=3), 8)])
def test_axis_sizes_equal_jax(sizes, n):
    def run(cls):
        try:
            return cls(**sizes).axis_sizes(n)
        except ValueError as exc:
            return f"ValueError: {exc}"

    assert run(MeshConfig) == run(JMeshConfig)


def test_build_mesh_under_device_lost_equals_jax():
    devices = ["cpu"] * 8
    full = build_mesh(MeshConfig(), devices, group=None)
    jfull = jbuild_mesh(JMeshConfig(), jax.devices()[:8])
    with faults.installed("mesh.device_lost@1"):
        shrunk = build_mesh(MeshConfig(), devices, group=None)
    with jfaults.installed("mesh.device_lost@1"):
        jshrunk = jbuild_mesh(JMeshConfig(), jax.devices()[:8])
    assert full.shape == dict(jfull.shape) == {"dp": 8, "fsdp": 1, "tp": 1,
                                               "sp": 1}
    assert shrunk.shape == dict(jshrunk.shape)
    assert shrunk.size == jshrunk.devices.size == 4
    assert elastic.mesh_changed(elastic.mesh_block(full),
                                elastic.mesh_block(shrunk))
    assert elastic.mesh_block(shrunk) == {
        "devices": 4, "platform": "cpu",
        "axes": {"dp": 4, "fsdp": 1, "tp": 1, "sp": 1}}
    assert build_mesh(MeshConfig(), devices, group=None).size == 8


def test_probed_devices_run_under_the_watchdog(monkeypatch):
    from deepdfa_tpu_torch.parallel.mesh import probed_devices
    from deepdfa_tpu_torch.resilience import watchdog

    if torch.cuda.is_available():
        pytest.skip("this host has a card: the probe would initialise it")
    assert probed_devices(5.0) == [torch.device("cpu")]
    seen = []
    monkeypatch.setattr(
        watchdog.HangWatchdog, "call",
        lambda self, point, fn, *a, **kw: seen.append(point) or fn())
    probed_devices(5.0)
    assert seen == ["device_init"]


def test_the_llm_axes_raise_naming_their_item():
    """The axes that shard the LLM build as the JAX mesh's (dp absorbing
    the rest, replicas one per dp slot); the GGNN's dp steps refuse them."""
    for axes in (dict(tp=2), dict(fsdp=2), dict(sp=2)):
        mesh = local_mesh(4, device="cpu", **axes)
        jmesh = jlocal_mesh(4, **axes)
        assert mesh.shape == dict(jmesh.shape) and mesh.shards_llm
        assert len(mesh.replica_devices) == jmesh.shape["dp"] == 2
        model = make_model(GGNNConfig(**CFG), INPUT_DIM, device="cpu")
        with pytest.raises(ValueError, match="shard the LLM"):
            dp.make_dp_eval_step(model, mesh)


# ----------------------------------------------------------------- stacks


def test_stack_batches_equals_jax_and_rejects_mixed_buckets():
    flat = _flat(2)
    got, want = dp.stack_batches([_port(b) for b in flat]), \
        jdp.stack_batches(flat)
    for a, b in zip(jax.tree.leaves(tuple(got)), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    other = next(JBatcher([JBucket(5, 256, 512)]).batches(
        jdataset(3, seed=5, input_dim=INPUT_DIM, mean_nodes=8)))
    with pytest.raises(ValueError, match="one bucket shape"):
        dp.stack_batches([_port(flat[0]), _port(other)])


@pytest.mark.parametrize("dp_size,accum", [(4, 1), (2, 2), (1, 4)])
def test_stack_elastic_equals_jax(dp_size, accum):
    flat = _flat(4, seed=1)
    got = elastic.stack_elastic([_port(b) for b in flat], dp_size, accum)
    want = jelastic.stack_elastic(flat, dp_size, accum)
    assert len(got) == len(want) == 1
    for a, b in zip(jax.tree.leaves(tuple(got[0])), jax.tree.leaves(want[0])):
        assert a.shape == b.shape and np.array_equal(a, b)
    with pytest.raises(ValueError, match="do not divide"):
        elastic.stack_elastic([_port(b) for b in flat[:3]], 2)


# ------------------------------------------------------------------ steps


def _jax_steps(layout, flat, n_dp):
    """Two JAX dp train steps over ``flat`` (n_dp batches a step) and one
    eval step: (params, metrics, loss, wsum, eval loss, eval metrics)."""
    jmodel, params, _ = _models(layout, example=flat[0])
    mesh = jlocal_mesh(n_dp)
    tx = optax.sgd(LR)
    state = jdp.dp_init_state(jmodel, tx, jax.tree.map(jnp.asarray, flat[0]))
    state = state._replace(params=params, opt_state=tx.init(params))
    step = jdp.make_dp_train_step(jmodel, tx, mesh, pos_weight=3.0,
                                  donate=False)
    metrics = JConfusion.zeros()
    for k in range(len(flat) // n_dp):
        stacked = jax.tree.map(jnp.asarray,
                               jdp.stack_batches(flat[k * n_dp:(k + 1) * n_dp]))
        state, metrics, loss, wsum = step(state, stacked, metrics)
    ev = jdp.make_dp_eval_step(jmodel, mesh, pos_weight=3.0)
    em, eloss, _ = ev(state.params,
                      jax.tree.map(jnp.asarray, jdp.stack_batches(
                          flat[:n_dp])), JConfusion.zeros())
    return state.params, metrics, loss, wsum, eloss, em


def _port_steps(layout, flat, mesh, accum=1):
    _, _, model = _models(layout, example=flat[0])
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    state = dp.dp_init_state(model, opt, mesh)
    step = dp.make_dp_train_step(model, opt, mesh, pos_weight=3.0,
                                 accum=accum)
    metrics = ConfusionState.zeros()
    for stacked in elastic.stack_elastic([_port(b) for b in flat], mesh.size,
                                         accum):
        state, metrics, loss, wsum = step(state, stacked, metrics)
    ev = dp.make_dp_eval_step(model, mesh, pos_weight=3.0)
    em, eloss, _ = ev(model, dp.stack_batches(
        [_port(b) for b in flat[:mesh.size]]), ConfusionState.zeros())
    return model, metrics, loss, wsum, eloss, em


@pytest.mark.parametrize("layout", ["segment", "dense"])
@pytest.mark.parametrize("group", ["none", "gloo"])
def test_dp_steps_equal_jax(layout, group, tmp_path):
    flat = _flat(4) if layout == "segment" else _dense_flat(4)
    want = _jax_steps(layout, flat, 2)
    if group == "gloo":
        import torch.distributed as dist

        store = dist.FileStore(str(tmp_path / "store"), 1)
        initialize_multihost(num_processes=1, process_id=0, backend="gloo",
                             store=store)
        try:
            mesh = build_mesh(MeshConfig(), ["cpu", "cpu"])
            assert mesh.world == 1 and mesh.group is not None
            got = _port_steps(layout, flat, mesh)
        finally:
            dist.destroy_process_group()
    else:
        got = _port_steps(layout, flat, local_mesh(2, device="cpu"))
    model, metrics, loss, wsum, eloss, em = got
    jparams, jmetrics, jloss, jwsum, jeloss, jem = want
    _assert_params_close(model, jparams, layout)
    assert float(wsum) == float(jwsum)
    assert float(loss) == pytest.approx(float(jloss), abs=TOL)
    assert [float(x) for x in metrics] == [float(x) for x in jmetrics]
    assert float(eloss) == pytest.approx(float(jeloss), abs=TOL)
    assert [float(x) for x in em] == [float(x) for x in jem]


def test_accum_equals_the_wider_mesh():
    """dp=2 and dp=1 with accum=2 consume the same global batch: the same
    update (the JAX elastic invariant)."""
    flat = _flat(4, seed=2)
    a = _port_steps("segment", flat, local_mesh(2, device="cpu"))
    b = _port_steps("segment", flat, local_mesh(1, device="cpu"), accum=2)
    for (k, x), (_, y) in zip(a[0].state_dict().items(),
                              b[0].state_dict().items()):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-6, rtol=0,
                                   err_msg=k)
    assert float(a[3]) == float(b[3])
    assert [float(x) for x in a[1]] == [float(x) for x in b[1]]


def test_two_gloo_ranks_equal_accum_two_and_lose_rank_one(tmp_path):
    """Two ranks (children) over gloo: one dp=2 step equals dp=1 with
    accum=2 over the same two batches in this process; armed
    ``mesh.device_lost`` halves the world's mesh, rank 1 is lost."""
    import pickle

    flat = [_port(b) for b in _flat(2, seed=3)]
    _, _, model = _models(example=flat[0])
    (tmp_path / "in.pkl").write_bytes(pickle.dumps(
        (flat, CFG, model.state_dict())))
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    env.pop("DEEPDFA_FAULTS", None)
    procs = [subprocess.Popen([sys.executable, "-c", RANK_MAIN, str(r),
                               str(tmp_path)], env=env, cwd=str(tmp_path),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(2)]
    outs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a gloo rank did not finish within 60 s")
        assert p.returncode == 0, err.decode()[-2000:]
    for r in range(2):
        outs.append(torch.load(tmp_path / f"rank{r}.pt"))
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    mesh = local_mesh(1, device="cpu")
    state = dp.dp_init_state(model, opt, mesh)
    step = dp.make_dp_train_step(model, opt, mesh, pos_weight=3.0, accum=2)
    state, metrics, loss, wsum = step(
        state, elastic.stack_elastic(flat, 1, 2)[0], ConfusionState.zeros())
    for r, o in enumerate(outs):
        assert o["out"]["slots"] == [r]
        assert o["out"]["wsum"] == float(wsum)
        assert o["out"]["loss"] == pytest.approx(float(loss), abs=1e-6)
        assert o["out"]["metrics"] == [float(x) for x in metrics]
        for k, v in model.state_dict().items():
            np.testing.assert_allclose(o["state"][k].numpy(), v.numpy(),
                                       atol=1e-6, rtol=0, err_msg=k)
    assert [o["out"]["lost"] for o in outs] == [1, "lost"]


# ---------------------------------------------------------------- elastic


def test_elastic_restore_of_the_ports_checkpoints(tmp_path):
    batch = _flat(1)[0]
    _, _, model = _models(example=batch)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    # one step, so the optimizer holds state
    model(to_device(_port(batch), "cpu")).sum().backward()
    opt.step()
    aux = {"optimizer": opt.state_dict(), "step": 1}
    ckpts = CheckpointManager(tmp_path / "ck", CheckpointConfig())
    here = elastic.mesh_block(device="cpu")
    assert here == {"devices": 1, "platform": "cpu", "axes": None}
    ckpts.save(1, model.state_dict(), epoch=0, aux=aux, mesh=here)
    step, meta, state, got_aux, resharded = elastic.elastic_restore(
        CheckpointManager(tmp_path / "ck"), device="cpu")
    assert (step, resharded, meta["mesh"]) == (1, False, here)
    other = elastic.mesh_block(local_mesh(2, device="cpu"))
    ckpts.save(2, model.state_dict(), epoch=1, aux=aux, mesh=other)
    step, meta, state, got_aux, resharded = elastic.elastic_restore(
        CheckpointManager(tmp_path / "ck"), device="cpu")
    assert (step, resharded, meta["mesh"]) == (2, True, other)
    for k, v in model.state_dict().items():
        assert torch.equal(state[k], v)
    exp = aux["optimizer"]["state"][0]["exp_avg"]
    assert torch.equal(got_aux["optimizer"]["state"][0]["exp_avg"], exp)
    tree = {"a": torch.arange(3.0), "b": [torch.ones(2)], "c": 5}
    moved = elastic.reshard_tree(tree, local_mesh(1, device="cpu"))
    assert torch.equal(moved["a"], tree["a"]) and moved["c"] == 5
    assert moved["a"] is not tree["a"]


# ----------------------------------------------------------------- engine


def _chain(n, seed):
    rng = np.random.default_rng(seed)
    feats = {k: rng.integers(0, INPUT_DIM, n).astype(np.int32) for k in KEYS}
    return Graph(senders=np.arange(n - 1, dtype=np.int32),
                 receivers=np.arange(1, n, dtype=np.int32),
                 node_feats=feats).with_self_loops()


@pytest.mark.parametrize("k", [1, 2, 3])
def test_score_groups_on_k_cpu_replicas_equals_jax(k):
    from deepdfa_tpu.data.graphs import Graph as JGraph

    jmodel = JGGNN(cfg=JCfg(**CFG), input_dim=INPUT_DIM)
    ex = jax.tree.map(jnp.asarray, JBatcher([JBucket(2, 16, 64)]).batches(
        [JGraph(_chain(6, 0).senders, _chain(6, 0).receivers,
                _chain(6, 0).node_feats)]).__next__())
    params = jmodel.init(jax.random.key(0), ex)["params"]
    jeng = JEngine.from_model(jmodel, params, "graph", feat_keys=KEYS,
                              max_batch=4, mesh=jlocal_mesh(k))
    cfg = GGNNConfig(**CFG, layout="fused")
    state = bridge.flax_to_torch(jax.tree.map(np.asarray, params), cfg,
                                 INPUT_DIM)
    model = make_model(cfg, INPUT_DIM, device="cpu")
    teng = ScoringEngine.from_model(model, state, "graph", feat_keys=KEYS,
                                    max_batch=4, mesh=local_mesh(k,
                                                                 device="cpu"))
    single = ScoringEngine.from_model(
        make_model(cfg, INPUT_DIM, device="cpu"), state, "graph",
        feat_keys=KEYS, max_batch=4, device="cpu")
    assert teng.n_replicas == jeng.n_replicas == k
    assert teng.model_rev == single.model_rev
    assert teng.warmup()["buckets"] == 3
    bucket = teng.buckets[0]
    groups = [[_chain(10 + i, i), _chain(7, 9 + i)] for i in range(k)]
    teng.n_dispatches = 0
    got = teng.score_groups(groups, bucket)
    assert teng.n_dispatches == 1
    want = jeng.score_groups(
        [[JGraph(g.senders, g.receivers, g.node_feats) for g in grp]
         for grp in groups], jeng.buckets[0])
    for a, b, grp in zip(got, want, groups):
        np.testing.assert_allclose(a, b, atol=TOL)
        np.testing.assert_array_equal(a, single.score(grp, bucket))
    np.testing.assert_array_equal(teng.score(groups[0], bucket), got[0])
    with pytest.raises(ValueError, match=f"groups > {k} replicas"):
        teng.score_groups([[]] * (k + 1), bucket)


def test_batcher_chunks_a_window_across_replicas():
    calls = []

    def stacked_fn(stacked):
        calls.append([int(x) for x in stacked.graph_mask.sum(axis=1)])
        return np.full(stacked.graph_mask.shape, 0.125, np.float32)

    from deepdfa_tpu_torch.serve import serve_buckets

    eng = ScoringEngine(None, serve_buckets(2), feat_keys=("_ABS_DATAFLOW",),
                        stacked_fn=stacked_fn, n_replicas=2)
    b = MicroBatcher(eng, max_batch=8, max_wait_ms=100.0)
    futs = [b.submit(_chain(5, i)) for i in range(5)]
    b.start()
    assert [f.result(timeout=10) for f in futs] == [0.125] * 5
    assert eng.n_dispatches == 2
    assert len(calls) == 2 and all(len(c) == 2 for c in calls)
    b.stop()
    with pytest.raises(ValueError, match="score_fn"):
        ScoringEngine(None, serve_buckets(2))


def test_a_card_named_twice_holds_one_replica():
    from deepdfa_tpu_torch.serve.engine import _check_replica_devices

    _check_replica_devices(["cpu", "cpu", "cpu"])
    with pytest.raises(ValueError, match="one replica per card"):
        _check_replica_devices(["cuda:0", "cuda:0"])


def test_serve_config_replicas_build_a_local_mesh(tmp_path, monkeypatch):
    """``serve.mesh_replicas`` through ``from_checkpoint``: k CPU replicas
    of the checkpoint's model, scoring as its single-replica engine."""
    import deepdfa_tpu_torch.pipeline as pipeline
    from deepdfa_tpu_torch.config import (DataConfig, ExperimentConfig,
                                          FeatureConfig, ServeConfig)

    cfg = GGNNConfig(**CFG)
    model = make_model(cfg, INPUT_DIM, device="cpu", seed=4)
    CheckpointManager(tmp_path / "ck", CheckpointConfig()).save(
        1, model.state_dict(), epoch=0)
    monkeypatch.setattr(pipeline, "vocab_content_hash", lambda v: "h")
    vocabs = dict.fromkeys(KEYS)
    data = DataConfig(feature=FeatureConfig(limit_all=INPUT_DIM - 2))
    engines = [ScoringEngine.from_checkpoint(
        ExperimentConfig(model=cfg, data=data,
                         serve=ServeConfig(mesh_replicas=n)),
        tmp_path / "ck", vocabs, device="cpu") for n in (0, 2)]
    assert [e.n_replicas for e in engines] == [1, 2]
    graphs = [_chain(9, 1), _chain(12, 2)]
    bucket = engines[0].assign_bucket(graphs[1])
    np.testing.assert_array_equal(engines[0].score(graphs, bucket),
                                  engines[1].score(graphs, bucket))
