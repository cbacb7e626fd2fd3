"""The port's checkpoints and resumable ``fit`` (deepdfa_tpu_torch/train/
checkpoint.py and fit.py) on the CPU: ``fit``'s corpus, epoch draws and
batches equal the JAX package's, the ``meta.json`` commit marker is
written last and half-written steps are collected, the best/last/periodic
retention keeps the steps the JAX package's ``CheckpointManager`` keeps,
``restore_resume`` walks past a corrupt newest payload, and a ``fit`` of 2
epochs resumed to 3 is bit-identical to a straight 3-epoch run (old
invariants 1-2)."""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deepdfa_tpu.config import CheckpointConfig as JCkptCfg  # noqa: E402
from deepdfa_tpu.config import load_config as jload_config  # noqa: E402
from deepdfa_tpu.data.sampler import positive_weight as jpositive_weight  # noqa: E402
from deepdfa_tpu.train import cli as jcli  # noqa: E402
from deepdfa_tpu.train.checkpoint import CheckpointManager as JManager  # noqa: E402

from deepdfa_tpu_torch.config import CheckpointConfig, load_config  # noqa: E402
from deepdfa_tpu_torch.data.sampler import positive_weight  # noqa: E402
from deepdfa_tpu_torch.train import checkpoint as ckpt_mod  # noqa: E402
from deepdfa_tpu_torch.train import fit as fit_mod  # noqa: E402
from deepdfa_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from deepdfa_tpu_torch.train.fit import fit  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small fits: they run as fast
    as on every core, and six test workers with a thread per core each
    oversubscribe the host ten times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _own_storage(tmp_path_factory, monkeypatch):
    """``load_corpus`` reads ``processed_dir()``: point the storage root at
    an empty directory, so ``fit`` takes the synthetic corpus whatever a
    checkout's ``storage/`` holds."""
    monkeypatch.setenv("DEEPDFA_STORAGE", str(tmp_path_factory.mktemp("storage")))


def _state(v: float) -> dict:
    return {"w": torch.full((3,), v), "b": torch.tensor([v])}


def test_meta_is_written_last_and_partial_steps_are_collected(tmp_path,
                                                              monkeypatch):
    mgr = CheckpointManager(tmp_path)
    order, at_rename = [], []
    real_save, real_write = torch.save, type(tmp_path).write_text
    real_replace = os.replace

    def save(obj, path, *a, **k):
        order.append(os.path.basename(path))
        return real_save(obj, path, *a, **k)

    def write_text(self, *a, **k):
        order.append(self.name)
        return real_write(self, *a, **k)

    def replace(src, dst):
        at_rename.append(sorted(os.listdir(src)))
        return real_replace(src, dst)

    monkeypatch.setattr(ckpt_mod.torch, "save", save)
    monkeypatch.setattr(type(tmp_path), "write_text", write_text)
    monkeypatch.setattr(ckpt_mod.os, "replace", replace)
    assert mgr.save(1, _state(1.0), metrics={"val_loss": 1.0}, epoch=0,
                    aux={"step": 1})
    assert order == ["state.pt", "aux.pt", "meta.json"]
    assert at_rename == [["aux.pt", "meta.json", "state.pt"]]
    monkeypatch.undo()

    # a crash between the payload and the marker leaves a .tmp directory
    def crash(obj, path, *a, **k):
        if os.path.basename(path) == "aux.pt":
            raise OSError("disk went away")
        return real_save(obj, path, *a, **k)

    monkeypatch.setattr(ckpt_mod.torch, "save", crash)
    with pytest.raises(OSError):
        mgr.save(2, _state(2.0), epoch=1, aux={"step": 2})
    monkeypatch.undo()
    assert (tmp_path / "00000002.tmp").is_dir()
    # and a step directory that lost its marker
    (tmp_path / "00000003").mkdir()
    real_save(_state(3.0), tmp_path / "00000003" / "state.pt")
    (tmp_path / "notes.txt").write_text("kept")
    again = CheckpointManager(tmp_path)
    assert again.steps == [1]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["00000001",
                                                          "notes.txt"]
    assert torch.equal(again.restore(1)["w"], _state(1.0)["w"])
    assert again.restore_aux(1) == {"step": 1}
    assert again.meta(1)["reasons"] == ["last", "periodic", "best"]


def test_retention_keeps_what_the_jax_manager_keeps(tmp_path):
    losses = [0.9, 0.4, 0.6, 0.7, 0.5, 0.8, 0.45]
    kw = dict(keep=2, periodic_every=3)
    mgr = CheckpointManager(tmp_path / "torch", CheckpointConfig(**kw))
    jmgr = JManager(tmp_path / "jax", JCkptCfg(**kw))
    for i, loss in enumerate(losses):
        step = i + 1
        mgr.save(step, _state(step), metrics={"val_loss": loss}, epoch=i)
        jmgr.save(step, {"w": np.full(3, float(step), np.float32)},
                  metrics={"val_loss": loss}, epoch=i)
    # newest two, the best (step 2) and every periodic epoch (0, 3, 6)
    assert mgr.steps == jmgr.steps == [1, 2, 4, 6, 7]
    assert mgr.best_step() == jmgr.best_step() == 2
    assert mgr.best_metric() == jmgr.best_metric() == 0.4
    assert torch.equal(mgr.restore_best()["w"], _state(2.0)["w"])
    assert mgr.latest_step() == 7
    reopened = CheckpointManager(tmp_path / "torch", CheckpointConfig(**kw))
    assert reopened.steps == mgr.steps and reopened.best_step() == 2


def test_restore_resume_walks_past_a_truncated_payload(tmp_path):
    mgr = CheckpointManager(tmp_path)
    for step in (1, 2, 3):
        mgr.save(step, _state(float(step)), epoch=step - 1,
                 aux={"step": step})
    newest = tmp_path / "00000003" / "state.pt"
    newest.write_bytes(newest.read_bytes()[:20])
    step, meta, state, aux = CheckpointManager(tmp_path).restore_resume()
    assert step == 2 and meta["epoch"] == 1 and aux == {"step": 2}
    assert torch.equal(state["w"], _state(2.0)["w"])
    (tmp_path / "00000002" / "aux.pt").unlink()  # resume needs the aux payload
    step, _, _, aux = CheckpointManager(tmp_path).restore_resume()
    assert step == 1 and aux == {"step": 1}
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore_resume()


_TINY = {
    "model.hidden_dim": 8, "model.n_steps": 3, "model.num_output_layers": 2,
    "model.layout": "fused", "data.sample": True, "data.undersample": None,
    "data.feature.limit_all": 50, "data.batch.batch_graphs": 32,
    "data.batch.max_nodes": 160, "data.batch.max_edges": 320}


def _tiny_config(epochs: int):
    """A small fused-layout run on the sample corpus, with node and edge
    ceilings low enough that the largest graphs take the overflow bucket."""
    return load_config(overrides=_TINY | {"optim.max_epochs": epochs})


@pytest.mark.parametrize("undersample", [None, "v1.0"])
def test_fit_batching_matches_the_jax_package(undersample):
    """The corpus, the epoch draws, the derived buckets, the overflow
    bucket and every batch of a training and an eval pass equal the JAX
    package's ``fit`` helpers."""
    over = _TINY | {"data.undersample": undersample}
    cfg, jcfg = load_config(overrides=over), jload_config(overrides=over)
    corpus, jcorpus = fit_mod.load_corpus(cfg), jcli._synthetic_corpus(jcfg)
    assert {k: [g.gid for g in v] for k, v in corpus.items()} == {
        k: [g.gid for g in v] for k, v in jcorpus.items()}
    train, val = corpus["train"], corpus["val"]
    jtrain, jval = jcorpus["train"], jcorpus["val"]
    labels = np.array([int(g.node_feats["_VULN"].max()) for g in train])
    assert positive_weight(labels) == jpositive_weight(labels)
    batcher = fit_mod._batcher(cfg, train + val)
    jbatcher = jcli._batcher(jcfg, jtrain + jval)
    spec = lambda b: (b.max_graphs, b.max_nodes, b.max_edges)
    assert [spec(b) for b in batcher.buckets] == [spec(b) for b in
                                                   jbatcher.buckets]
    assert spec(batcher.overflow_bucket) == spec(jbatcher.overflow_bucket)
    for epoch in (0, 1):
        graphs = fit_mod._epoch_graphs(train, labels, cfg, epoch)
        jgraphs = jcli._epoch_graphs(jtrain, labels, jcfg, epoch)
        assert [g.gid for g in graphs] == [g.gid for g in jgraphs]
        for seed in (epoch, None):
            got = list(fit_mod._batch_stream(batcher, graphs, seed))
            want = list(jcli._batch_stream(jbatcher, jgraphs, seed))
            assert len(got) == len(want) > 0
            for a, b in zip(got, want):
                for field in ("senders", "receivers", "node_gidx",
                              "node_mask", "edge_mask", "graph_mask"):
                    np.testing.assert_array_equal(getattr(a, field),
                                                  getattr(b, field))
                for k in a.node_feats:
                    np.testing.assert_array_equal(a.node_feats[k],
                                                  b.node_feats[k])
            assert fit_mod._oversize_stats(batcher) == jcli._oversize_stats(
                jbatcher)


def test_fit_resumed_is_bit_identical_to_a_straight_run(tmp_path):
    cfg = _tiny_config(3)
    straight = fit(cfg, tmp_path / "a", device="cpu")
    fit(dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim,
                                                           max_epochs=2)),
        tmp_path / "b", device="cpu")
    resumed = fit(cfg, tmp_path / "b", resume=True, device="cpu")
    assert resumed == straight
    assert straight["n_oversize_fallback_train"] > 0
    assert straight["n_dropped_train"] == straight["n_dropped_val"] == 0
    a = CheckpointManager(tmp_path / "a" / "checkpoints")
    b = CheckpointManager(tmp_path / "b" / "checkpoints")
    assert a.steps == b.steps
    for step in a.steps:
        pa, pb = a.restore(step), b.restore(step)
        assert all(torch.equal(pa[k], pb[k]) for k in pa)
    aux_a, aux_b = a.restore_aux(a.latest_step()), b.restore_aux(b.latest_step())
    assert torch.equal(aux_a["rng"], aux_b["rng"]) and aux_a["step"] == aux_b["step"]
    journal = json.loads((tmp_path / "b" / "journal.json").read_text())
    assert journal["completed"] and journal["global_step"] == a.latest_step()
    # the resumed process trained the third epoch only
    after_two = next(s for s in b.steps if b.meta(s)["epoch"] == 1)
    assert journal["timing"]["train_steps"] == aux_b["step"] - after_two
    tuning = [json.loads(line) for line in
              (tmp_path / "b" / "tuning.jsonl").read_text().splitlines()]
    assert [t.get("epoch") for t in tuning] == [0, 1, None, 2, None]
    final = json.loads((tmp_path / "b" / "final_metrics.json").read_text())
    assert final == resumed and all(np.isfinite(v) for v in final.values())


def test_resume_without_a_run_starts_fresh(tmp_path):
    cfg = _tiny_config(1)
    fresh = fit(cfg, tmp_path / "a", device="cpu")
    assert fit(cfg, tmp_path / "b", resume=True, device="cpu") == fresh


@pytest.mark.parametrize("overrides,match", [
    # the mesh block is ported (data parallelism): accepted, fit completes
    ({"mesh": {"dp": 1}}, None),
    # the resilience block is ported: accepted, and fit completes
    ({"resilience": {"sentinel_patience": 3}}, None),
    ({"resilience": {"emergency_ckpt": False}}, None),
    # node labels are ported: accepted, and fit completes
    ({"model": {"label_style": "node"}}, None),
])
def test_unported_fit_options_raise(tmp_path, overrides, match):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(overrides))
    if match is None:
        cfg = load_config(path, overrides=_TINY | {"optim.max_epochs": 1})
        for section, values in overrides.items():
            block = getattr(cfg, section)
            assert block == dataclasses.replace(block, **values)
        final = fit(cfg, tmp_path / "run", device="cpu")
        assert final["n_rollbacks"] == 0 and final["lr_scale"] == 1.0
        assert all(np.isfinite(v) for v in final.values())
        assert (tmp_path / "run" / "final_metrics.json").exists()
        return
    with pytest.raises(NotImplementedError, match=match):
        fit(load_config(path), tmp_path / "run", device="cpu")
