"""The port's trainer command line (deepdfa_tpu_torch/train/cli.py), its
resumable ``fit`` and the trainer-side metrics and checkpoint helpers, on
the CPU, against the JAX package on the same inputs.

A module fixture builds demo shards with the port's preprocess (80
functions, ``--limit-all 50``) and runs one straight 2-epoch ``fit``
through ``cli.main`` (hidden 8 × 4 subkeys, 3 rounds, the fused layout).
It is the oracle of the interrupted runs: a crash between a checkpoint's
payload and its ``meta.json`` (a subprocess, rc 137) and a preemption
(rc 75 from ``cli.main``), each followed by ``fit --resume``, must give its
final parameters bit for bit.

Tolerances:
- resumed runs, ``predict`` against in-process ``predict_paths``, the
  metrics functions (float64), ``coverage.json`` and the Chrome trace
  against the JAX package's: exact;
- ``test`` against the JAX package's ``test`` on the same weights (carried
  by ``bridge.torch_to_flax``, the JAX side in the segment layout):
  confusion counts exact, losses and PR-curve values within 1e-5 (float32
  sums in another order);
- frozen tensors after training steps: bitwise unchanged.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pd = pytest.importorskip("pandas")

from deepdfa_tpu.config import load_config as jload_config  # noqa: E402
from deepdfa_tpu.train import checkpoint as jckpt  # noqa: E402
from deepdfa_tpu.train import cli as jcli  # noqa: E402
from deepdfa_tpu.train import metrics as jmetrics  # noqa: E402

from deepdfa_tpu_torch import bridge, preprocess  # noqa: E402
from deepdfa_tpu_torch.config import load_config  # noqa: E402
from deepdfa_tpu_torch.models import make_model  # noqa: E402
from deepdfa_tpu_torch.predict import load_vocabs, predict_paths  # noqa: E402
from deepdfa_tpu_torch.resilience import faults  # noqa: E402
from deepdfa_tpu_torch.resilience.watchdog import WatchdogTimeout  # noqa: E402
from deepdfa_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from deepdfa_tpu_torch.train import cli  # noqa: E402
from deepdfa_tpu_torch.train import metrics  # noqa: E402
from deepdfa_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
REALWORLD = REPO / "tests" / "fixtures" / "realworld"
OVERRIDES = {
    "model.hidden_dim": 8, "model.n_steps": 3, "model.num_output_layers": 2,
    "model.layout": "fused", "data.dsname": "demo", "data.split": "random",
    "data.undersample": None, "data.feature.limit_all": 50,
    "data.feature.limit_subkeys": 50, "data.batch.batch_graphs": 16,
    "optim.max_epochs": 2}
SETS = [a for k, v in OVERRIDES.items()
        for a in ("--set", f"{k}={json.dumps(v)}")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small fits: they run as fast
    as on every core, and six test workers with a thread per core each
    oversubscribe the host ten times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fit_argv(run_dir, *extra, device="cpu"):
    return ["fit", "--run-dir", str(run_dir), *SETS, "--device", device,
            *extra]


@pytest.fixture(scope="module")
def storage(tmp_path_factory):
    """A storage root holding demo shards (80 functions, vocabularies of
    50 entries), set as ``DEEPDFA_STORAGE`` for the module."""
    root = tmp_path_factory.mktemp("storage")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DEEPDFA_STORAGE", str(root))
        out = preprocess.main(["--dataset", "demo", "--n", "80", "--workers",
                               "1", "--limit-all", "50", "--limit-subkeys",
                               "50"])
        assert out["graphs"] == 80
        yield root


@pytest.fixture(scope="module")
def straight(storage, tmp_path_factory):
    """The straight 2-epoch run through ``cli.main``."""
    run = tmp_path_factory.mktemp("straight")
    final = cli.main(_fit_argv(run))
    return run, final


def _latest(run_dir) -> dict:
    mgr = CheckpointManager(Path(run_dir) / "checkpoints")
    return mgr.restore(mgr.latest_step())


def _assert_same_params(a_dir, b_dir):
    a, b = _latest(a_dir), _latest(b_dir)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


# ----------------------------------------------------------- fit & resume


def test_fit_writes_the_run_record(straight):
    run, final = straight
    assert json.loads((run / "final_metrics.json").read_text()) == final
    for key in ("n_rollbacks", "lr_scale", "resharded", "sentinel_steps",
                "sentinel_bad_steps", "val_F1Score", "n_dropped_train"):
        assert key in final
    assert (final["n_rollbacks"], final["lr_scale"], final["resharded"]) == (
        0, 1.0, 0)
    journal = json.loads((run / "journal.json").read_text())
    assert journal["completed"] and journal["rollbacks"] == 0
    assert journal["sentinel_steps"] == journal["timing"]["train_steps"] > 0
    assert (run / "run.log").exists() and (run / "config.json").exists()
    assert list((run / "traces").glob("trace-*.json"))


def test_a_crash_between_payload_and_meta_resumes_bitwise(storage, straight,
                                                          tmp_path):
    """A subprocess killed between the second checkpoint's payload and its
    ``meta.json`` (rc 137, a ``*.tmp`` left behind), then ``fit --resume``:
    the straight run's parameters and final metrics."""
    run = tmp_path / "crashed"
    env = dict(os.environ, DEEPDFA_STORAGE=str(storage),
               DEEPDFA_FAULTS="ckpt.crash_between_state_and_meta@2",
               PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "deepdfa_tpu_torch.train.cli",
         *_fit_argv(run)], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 137, proc.stderr[-2000:]
    assert list((run / "checkpoints").glob("*.tmp"))
    resumed = cli.main(_fit_argv(run, "--resume"))
    assert not list((run / "checkpoints").glob("*.tmp"))
    _assert_same_params(straight[0], run)
    assert resumed == straight[1]


def test_a_preemption_exits_75_and_resumes_bitwise(straight, tmp_path):
    """``preempt.sigterm`` mid-epoch: an emergency checkpoint, rc 75 out of
    ``cli.main``, the journal's ``preempted*`` fields; the resume re-enters
    the epoch at the recorded offset and ends on the straight run."""
    run = tmp_path / "preempted"
    with faults.installed("preempt.sigterm@3"):
        with pytest.raises(SystemExit) as exit_:
            cli.main(_fit_argv(run))
    assert exit_.value.code == 75
    journal = json.loads((run / "journal.json").read_text())
    assert journal["preempted"] == "injected fault preempt.sigterm"
    assert journal["preempted_steps_done"] == 2
    assert 0 <= journal["emergency_commit_s"] <= journal[
        "emergency_deadline_s"]
    mgr = CheckpointManager(run / "checkpoints")
    meta = mgr.meta(mgr.latest_step())
    assert meta["reasons"][0] == "emergency"
    assert meta["preempted"]["steps_done"] == 2 and meta["epoch"] == 0
    assert (run / "run.log").exists()  # suspended, not crashed
    resumed = cli.main(_fit_argv(run, "--resume"))
    _assert_same_params(straight[0], run)
    assert resumed == straight[1]


def test_the_watchdog_journals_a_wedged_step(storage, tmp_path):
    run = tmp_path / "wedged"
    with faults.installed("step.hang@2"):
        with pytest.raises(WatchdogTimeout):
            cli.main(_fit_argv(run, "--set",
                               "resilience.step_deadline_s=0.5"))
    journal = json.loads((run / "journal.json").read_text())
    assert journal["watchdog_timeout"] == {"point": "train_step",
                                           "deadline_s": 0.5}
    assert list(run.glob("flight-*.json"))
    dump = json.loads(next(run.glob("flight-*.json")).read_text())
    assert dump["reason"] == "watchdog_timeout"
    assert (run / "run.log.error").exists() and not (run / "run.log").exists()


# ------------------------------------------------------ test/predict/analyze


def _jax_checkpoint(run, tmp_path) -> Path:
    """The straight run's best weights as a JAX checkpoint."""
    cfg = load_config(overrides=OVERRIDES)
    mgr = CheckpointManager(run / "checkpoints")
    tree = bridge.torch_to_flax(mgr.restore(mgr.best_step()), cfg.model,
                                cfg.input_dim)
    jdir = tmp_path / "jax_ckpt"
    jckpt.CheckpointManager(jdir).save(1, {"params": tree},
                                       metrics={"val_loss": 0.0}, epoch=0)
    return jdir


def test_test_command_equals_jax(straight, tmp_path):
    run, _ = straight
    out = tmp_path / "port_test"
    got = cli.main(["test", "--run-dir", str(out), "--ckpt-dir",
                    str(run / "checkpoints"), *SETS, "--device", "cpu"])
    jout = tmp_path / "jax_test"
    jout.mkdir()
    jcfg = jload_config(overrides=OVERRIDES | {"model.layout": "segment"})
    want = jcli.test(jcfg, jout, _jax_checkpoint(run, tmp_path))
    assert got.keys() == want.keys()
    assert got["n_graphs_scored"] == want["n_graphs_scored"] > 0
    for key, value in want.items():
        if isinstance(value, int) or key.startswith(("report_support",)):
            assert got[key] == value, key
        else:
            assert got[key] == pytest.approx(value, abs=1e-5), key
    for name in ("pr.csv", "pr_binned.csv"):
        a, b = pd.read_csv(out / name), pd.read_csv(jout / name)
        assert list(a.columns) == list(b.columns) == [
            "Unnamed: 0", "precision", "recall", "thresholds"]
        assert a.shape == b.shape
        np.testing.assert_array_equal(a["Unnamed: 0"], np.arange(len(a)))
        np.testing.assert_allclose(a.values, b.values, rtol=0, atol=1e-5)
    assert json.loads((out / "test_metrics.json").read_text()) == got


def test_predict_command_equals_predict_paths(storage, straight, tmp_path):
    run, _ = straight
    out = tmp_path / "predict"
    got = cli.main(["predict", "--run-dir", str(out), "--ckpt-dir",
                    str(run / "checkpoints"), "--source", str(REALWORLD),
                    *SETS, "--device", "cpu"])
    cfg = load_config(overrides=OVERRIDES)
    model = make_model(cfg.model, cfg.input_dim, device="cpu")
    model.load_state_dict(CheckpointManager(
        run / "checkpoints").restore_best())
    want = predict_paths([str(REALWORLD)], cfg=cfg, model=model,
                         vocabs=load_vocabs(storage / "processed" / "demo" /
                                            "shards"))
    assert got == want and want["n_scored"] > 0
    assert json.loads((out / "predictions.json").read_text()) == want
    with pytest.raises(FileNotFoundError, match="run fit first"):
        cli.main(["predict", "--run-dir", str(tmp_path / "none"), "--source",
                  str(REALWORLD), *SETS, "--device", "cpu"])


def test_analyze_equals_jax(storage, tmp_path):
    out, jout = tmp_path / "port", tmp_path / "jax"
    jout.mkdir()
    got = cli.main(["analyze", "--run-dir", str(out), *SETS])
    want = jcli.analyze(jload_config(overrides=OVERRIDES), jout)
    assert got == want and got["variants"]
    assert json.loads((out / "coverage.json").read_text()) == json.loads(
        (jout / "coverage.json").read_text())
    shards = storage / "processed" / "demo" / "shards"
    csv_gz = shards / "hashes.csv.gz"
    csv_gz.rename(shards / "hashes.parquet")
    try:
        with pytest.raises(ValueError, match="hashes.csv.gz"):
            cli.analyze(load_config(overrides=OVERRIDES), tmp_path / "pq")
    finally:
        (shards / "hashes.parquet").rename(csv_gz)


def test_trace_export_equals_jax(straight, tmp_path):
    run, _ = straight
    got = cli.main(["trace", "--run-dir", str(run), "--out",
                    str(tmp_path / "port.json")])
    want = jcli.trace_export(run, tmp_path / "jax.json")
    assert got["spans"] == want["spans"] > 0
    trace = json.loads((tmp_path / "port.json").read_text())
    assert trace == json.loads((tmp_path / "jax.json").read_text())
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"train.epoch", "data.wait", "step.dispatch",
            "device.sync"} <= names


def test_a_crash_renames_the_log_and_bench_waits_for_a13(storage, tmp_path,
                                                         monkeypatch):
    run = tmp_path / "crash"
    with faults.installed("prefetch.producer_raises@2"):
        with pytest.raises(faults.InjectedFault):
            cli.main(_fit_argv(run))
    assert (run / "run.log.error").exists() and not (run / "run.log").exists()
    # bench ledger over the repo's artifacts: the JAX CLI's summary and rc
    repo = Path(__file__).resolve().parent.parent
    bench = ["bench", "ledger", "--ledger-dir", str(repo), "--check"]
    assert cli.main(bench) == jcli.main(bench) == {
        "command": "bench", "subcommand": "ledger", "rc": 0}
    with pytest.raises(SystemExit):
        cli.main(["predict", "--run-dir", str(run)])  # needs --source
    # serve and scan dispatch as the JAX CLI does, with its arguments
    from deepdfa_tpu_torch import scan
    from deepdfa_tpu_torch.serve import server

    calls = []
    monkeypatch.setattr(server, "serve_command",
                        lambda cfg, **kw: calls.append(("serve", kw)) or {})
    monkeypatch.setattr(scan, "scan_command",
                        lambda cfg, run_dir, targets, **kw: calls.append(
                            ("scan", targets, kw)) or {})
    cli.main(["serve", "--run-dir", str(run), "--artifact", "a",
              "--device", "cpu"])
    cli.main(["scan", "t1", "--source", "t2", "--run-dir", str(run),
              "--workers", "2", "--cache-dir", "c", "--interproc",
              "--device", "cpu"])
    assert calls == [
        ("serve", dict(run_dir=run, ckpt_dir=None, artifact="a",
                       shard_dir=None, device="cpu")),
        ("scan", ["t1", "t2"], dict(ckpt_dir=None, artifact=None, workers=2,
                                    cache_dir=Path("c"), cascade=False,
                                    interproc=True, shard_dir=None,
                                    device="cpu"))]
    assert (run / "run.log.error").exists()  # readers never mark the run


# ------------------------------------------------------------------ metrics

_rng = np.random.default_rng(7)
CURVES = [
    (_rng.random(40).astype(np.float32), _rng.integers(0, 2, 40)),
    (np.round(_rng.random(60), 1).astype(np.float32), _rng.integers(0, 2, 60)),
    (np.full(9, 0.5, np.float32), _rng.integers(0, 2, 9)),
    (_rng.random(12).astype(np.float32), np.zeros(12, int)),
    (_rng.random(12).astype(np.float32), np.ones(12, int)),
    (np.array([0.3], np.float32), np.array([1])),
]


@pytest.mark.filterwarnings("ignore:No positive class")
@pytest.mark.parametrize("probs,labels", CURVES)
def test_curves_and_confusion_equal_jax(probs, labels):
    for mine, ref in ((metrics.pr_curve(probs, labels),
                       jmetrics.pr_curve(probs, labels)),
                      (metrics.binned_pr_curve(probs, labels, bins=100),
                       jmetrics.binned_pr_curve(probs, labels, bins=100))):
        for a, b in zip(mine, ref):
            assert a.dtype == b.dtype == np.float64
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(metrics.confusion_matrix(probs, labels),
                                  jmetrics.confusion_matrix(probs, labels))


@pytest.mark.parametrize("curve", [metrics.pr_curve,
                                   lambda p, l: metrics.binned_pr_curve(
                                       p, l, bins=100)])
def test_pr_csv_is_pandas_to_csv(tmp_path, curve):
    p, r, t = curve(*CURVES[1])
    data = cli.write_curve(tmp_path / "pr.csv", (p, r, t))
    pd.DataFrame({"precision": p, "recall": r, "thresholds": t}).to_csv(
        tmp_path / "want.csv")
    assert data == (tmp_path / "want.csv").read_bytes()
    assert (tmp_path / "pr.csv").read_bytes() == data


def test_by_class_counts_and_mean_equal_jax():
    import jax.numpy as jnp

    probs = _rng.random(30).astype(np.float32)
    labels = _rng.integers(0, 2, 30).astype(np.float32)
    mask = _rng.random(30) > 0.2
    pos, neg = metrics.update_confusion_by_class(
        metrics.ConfusionState.zeros(), metrics.ConfusionState.zeros(),
        torch.from_numpy(probs), torch.from_numpy(labels),
        torch.from_numpy(mask))
    jpos, jneg = jmetrics.update_confusion_by_class(
        jmetrics.ConfusionState.zeros(), jmetrics.ConfusionState.zeros(),
        jnp.asarray(probs), jnp.asarray(labels), jnp.asarray(mask))
    assert metrics.compute_metrics(pos, "p_") == jmetrics.compute_metrics(
        jpos, "p_")
    assert metrics.compute_metrics(neg, "n_") == jmetrics.compute_metrics(
        jneg, "n_")
    m, jm = metrics.MeanState.zeros(), jmetrics.MeanState.zeros()
    for v, w in ((0.5, 2.0), (1.25, 1.0), (3.0, 0.5)):
        m, jm = metrics.update_mean(m, v, w), jmetrics.update_mean(jm, v, w)
    assert m.compute() == jm.compute()
    assert metrics.MeanState.zeros().compute() == 0.0


# --------------------------------------------------------- encoder transfer


def _small(seed=0):
    cfg = load_config(overrides=OVERRIDES)
    return cfg, make_model(cfg.model, cfg.input_dim, device="cpu", seed=seed)


def _as_flax(cfg, state):
    return bridge.torch_to_flax(state, cfg.model, cfg.input_dim)


def test_freeze_mask_and_partial_load_equal_jax():
    import jax

    cfg, model = _small()
    state = model.state_dict()
    mask = ckpt.freeze_mask(state)
    marked = _as_flax(cfg, {k: torch.full_like(v, float(mask[k]))
                            for k, v in state.items()})
    jmask = jckpt.freeze_mask(_as_flax(cfg, state))
    got = jax.tree.map(lambda leaf: bool(np.all(leaf == 1.0)), marked)
    assert got == jmask
    assert sorted({k.split(".")[0] for k, v in mask.items() if v}) == [
        "head", "pooling"]
    _, other = _small(seed=1)
    loaded = ckpt.encoder_partial_load(state, other.state_dict())
    want = jckpt.encoder_partial_load(_as_flax(cfg, state),
                                      _as_flax(cfg, other.state_dict()))
    flat = jax.tree.leaves(_as_flax(cfg, loaded))
    assert all(np.array_equal(a, b) for a, b in
               zip(flat, jax.tree.leaves(want)))


def test_frozen_encoder_optimizer_moves_only_the_head():
    from deepdfa_tpu_torch.data.graphs import (BucketSpec, GraphBatcher,
                                               to_device)
    from deepdfa_tpu_torch.data.synthetic import random_dataset
    from deepdfa_tpu_torch.train.loop import TrainState, Trainer
    from deepdfa_tpu_torch.train.metrics import ConfusionState

    cfg, model = _small()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = ckpt.frozen_encoder_optimizer(
        model, lambda params: torch.optim.AdamW(
            params, lr=1e-2, weight_decay=cfg.optim.weight_decay))
    trainer = Trainer(model, cfg, pos_weight=3.0)
    state = TrainState(model, opt, torch.Generator().manual_seed(0), 0)
    graphs = random_dataset(32, seed=3, input_dim=cfg.input_dim,
                            vul_rate=0.4)
    batches = list(GraphBatcher([BucketSpec(17, 1024, 2048)]).batches(graphs))
    metrics_ = ConfusionState.zeros()
    for batch in batches * 2:
        state, metrics_, loss, _ = trainer.train_step(
            state, to_device(batch, "cpu"), metrics_)
        assert torch.isfinite(loss)
    after = model.state_dict()
    moved = {k for k in after if not torch.equal(after[k], before[k])}
    frozen = {k for k, v in ckpt.freeze_mask(after).items() if not v}
    assert moved and moved == set(after) - frozen
    assert all(torch.equal(after[k], before[k]) for k in frozen)
    n_opt = sum(p.numel() for g in opt.param_groups for p in g["params"])
    assert n_opt == sum(before[k].numel() for k in before
                        if ckpt.is_head_key(k))


# --------------------------------------------------------------- on the card


@pytest.mark.gpu
def test_crash_resume_and_preemption_on_the_card_are_bitwise(storage,
                                                             tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: B1 and B2 have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    cli.main(_fit_argv(tmp_path / "straight", device="cuda"))
    for name, spec, rc in (
            ("crashed", "ckpt.crash_between_state_and_meta@2", 137),
            ("preempted", "preempt.sigterm@3", 75)):
        run = tmp_path / name
        env = dict(os.environ, DEEPDFA_STORAGE=str(storage),
                   DEEPDFA_FAULTS=spec, PYTHONPATH=str(REPO))
        proc = subprocess.run(
            [sys.executable, "-m", "deepdfa_tpu_torch.train.cli",
             *_fit_argv(run, device="cuda")], cwd=REPO, env=env,
            capture_output=True, text=True, timeout=600)
        assert proc.returncode == rc, proc.stderr[-2000:]
        cli.main(_fit_argv(run, "--resume", device="cuda"))
        _assert_same_params(tmp_path / "straight", run)
