"""The port's resilience layer (deepdfa_tpu_torch/resilience: sentinel.py,
preemption.py, watchdog.py, the trainer's fault points) against the JAX
package's classes on the same call sequences, and the rollback inside the
port's ``fit`` on the CPU.

Tolerances: none — outcomes, ``stats()``, raised types and messages, fault
schedules and parameters after a rollback are compared exactly. No test
waits more than 2 s: watchdog deadlines are 0.2 s and every hang is the
cancel-aware one.
"""

import dataclasses
import os
import signal
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deepdfa_tpu.resilience import faults as jfaults  # noqa: E402
from deepdfa_tpu.resilience import preemption as jpre  # noqa: E402
from deepdfa_tpu.resilience import sentinel as jsen  # noqa: E402
from deepdfa_tpu.resilience import watchdog as jwd  # noqa: E402

from deepdfa_tpu_torch.config import load_config  # noqa: E402
from deepdfa_tpu_torch.resilience import faults  # noqa: E402
from deepdfa_tpu_torch.resilience import preemption as pre  # noqa: E402
from deepdfa_tpu_torch.resilience import sentinel as sen  # noqa: E402
from deepdfa_tpu_torch.resilience import watchdog as wd  # noqa: E402
from deepdfa_tpu_torch.train import fit as fit_mod  # noqa: E402
from deepdfa_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from deepdfa_tpu_torch.train.fit import fit  # noqa: E402

TRAINER_POINTS = ("ckpt.crash_between_state_and_meta", "step.nan_grads",
                  "prefetch.producer_raises", "preempt.sigterm", "step.hang")


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
    """``fit`` reads ``processed_dir()``: an empty storage root gives it the
    synthetic corpus."""
    monkeypatch.setenv("DEEPDFA_STORAGE",
                       str(tmp_path_factory.mktemp("storage")))


# ---------------------------------------------------------------- sentinel

NAN = float("nan")
SEQUENCES = [
    [1.0, NAN, 2.0, NAN, NAN, 3.0, NAN, NAN, NAN, 1.0],
    [NAN] * 6,
    [1.0, 2.0, 3.0, float("inf"), NAN, -float("inf"), 0.5],
    [NAN, 1.0] * 5,
]


def _drive(sentinel, losses, wrap=lambda x: x):
    """The outcome of observing ``losses`` then flushing: the index the
    sentinel raised at (and its run length), or None, with its stats."""
    events = []
    for i, loss in enumerate(losses):
        try:
            sentinel.observe(wrap(loss))
        except Exception as exc:  # noqa: BLE001 — the outcome is compared
            events.append((i, type(exc).__name__, str(exc), exc.consecutive))
            sentinel.reset()
    try:
        sentinel.flush()
    except Exception as exc:  # noqa: BLE001
        events.append(("flush", type(exc).__name__, str(exc), exc.consecutive))
    return events, sentinel.stats(), sentinel.consecutive


@pytest.mark.parametrize("losses", SEQUENCES)
@pytest.mark.parametrize("patience,lag", [(1, 0), (2, 1), (3, 2), (2, 4)])
def test_sentinel_equals_jax(losses, patience, lag):
    want = _drive(jsen.DivergenceSentinel(patience=patience, lag=lag), losses)
    assert _drive(sen.DivergenceSentinel(patience=patience, lag=lag),
                  losses) == want
    # a 0-d tensor is read as its float
    assert _drive(sen.DivergenceSentinel(patience=patience, lag=lag), losses,
                  lambda x: torch.tensor(x, dtype=torch.float32)) == want


def test_sentinel_arguments_and_errors_equal_jax():
    for kw in ({"patience": 0}, {"lag": -1}):
        with pytest.raises(ValueError) as mine:
            sen.DivergenceSentinel(**kw)
        with pytest.raises(ValueError) as ref:
            jsen.DivergenceSentinel(**kw)
        assert str(mine.value) == str(ref.value)
    assert issubclass(sen.DivergenceError, RuntimeError)
    assert str(sen.DivergenceError(4)) == str(jsen.DivergenceError(4))


# ------------------------------------------------------------- preemption


def test_preemption_handler_equals_jax_on_a_real_signal():
    assert pre.PREEMPTED_RC == jpre.PREEMPTED_RC == 75
    for sig in (signal.SIGTERM, signal.SIGUSR1):
        before = signal.getsignal(sig)
        mine = pre.PreemptionHandler().install()
        assert not mine.triggered
        os.kill(os.getpid(), sig)  # flag only: the process keeps running
        mine.uninstall()
        ref = jpre.PreemptionHandler().install()
        os.kill(os.getpid(), sig)
        ref.uninstall()
        assert signal.getsignal(sig) == before
        assert (mine.triggered, mine.reason) == (ref.triggered, ref.reason)
        assert mine.reason == f"signal {sig.name}"


def test_preemption_off_the_main_thread_degrades_as_jax_does(caplog):
    out = {}

    def body():
        for name, mod in (("mine", pre), ("ref", jpre)):
            h = mod.PreemptionHandler().install()
            h.trigger("manual")
            h.uninstall()
            out[name] = (h.triggered, h.reason, h._prev)

    with caplog.at_level("WARNING"):
        t = threading.Thread(target=body)
        t.start()
        t.join(2.0)
    assert out["mine"] == out["ref"] == (True, "manual", {})
    assert sum("not on the main thread" in r.getMessage()
               for r in caplog.records) == 2


def test_preempted_and_preempted_exit_equal_jax():
    mine, ref = pre.Preempted("s", 7, "why"), jpre.Preempted("s", 7, "why")
    assert (str(mine), mine.steps_done, mine.reason, mine.state) == (
        str(ref), ref.steps_done, ref.reason, ref.state)
    e = pre.PreemptedExit("why")
    assert isinstance(e, SystemExit) and not isinstance(e, Exception)
    assert (e.code, e.reason) == (jpre.PreemptedExit("why").code, "why")


# --------------------------------------------------------------- watchdog


def _outcome(dog, *args, **kw):
    try:
        return ("value", dog.call(*args, **kw))
    except Exception as exc:  # noqa: BLE001 — the outcome is compared
        return (type(exc).__name__, str(exc))


def test_watchdog_equals_jax():
    for mod in (wd, jwd):
        with pytest.raises(ValueError, match="deadline_s must be > 0"):
            mod.HangWatchdog(0)

    def boom():
        raise KeyError("inside")

    seen = {"mine": [], "ref": []}
    dogs = {"mine": wd.HangWatchdog(0.2, on_timeout=lambda p, d: seen[
                "mine"].append((p, d))),
            "ref": jwd.HangWatchdog(0.2, on_timeout=lambda p, d: seen[
                "ref"].append((p, d)))}
    results = {}
    for name, dog in dogs.items():
        before = threading.active_count()
        results[name] = [
            _outcome(dog, "p", lambda a, b=0: a + b, 2, b=3),
            _outcome(dog, "p", boom),
            _outcome(dog, "train_step", lambda cancel: cancel.wait(),
                     cancel_aware=True),
            _outcome(dog, "x", lambda cancel: cancel.wait(), cancel_aware=True,
                     deadline_s=0.1),
        ]
        # the cancel-aware hangs unwound: no thread left behind
        assert threading.active_count() == before
        results[name].append(dog.n_timeouts)
    assert results["mine"] == results["ref"]
    assert results["mine"][0] == ("value", 5)
    assert results["mine"][2][0] == "WatchdogTimeout"
    assert seen["mine"] == seen["ref"] == [("train_step", 0.2), ("x", 0.1)]
    assert issubclass(wd.WatchdogTimeout, TimeoutError)


# ------------------------------------------------------------ fault points


def test_the_trainer_fault_points_are_declared_with_jax_docs():
    for point in TRAINER_POINTS:
        assert point in faults.KNOWN_POINTS
        assert faults.POINT_DOCS[point] == jfaults.POINT_DOCS[point]
    assert len(faults.KNOWN_POINTS) == 30
    # the mesh's point, fired by parallel/mesh.py::build_mesh
    assert faults.POINT_DOCS["mesh.device_lost"] == \
        jfaults.POINT_DOCS["mesh.device_lost"]
    # the continual loop's three points, by name and doc against JAX's
    for point in ("continual.capture_drop", "continual.rollout_crash",
                  "continual.rollback_trigger"):
        assert point in faults.KNOWN_POINTS and point in jfaults.KNOWN_POINTS
        assert faults.POINT_DOCS[point] == jfaults.POINT_DOCS[point]


def test_known_points_are_the_jax_registry_less_the_mesh_point():
    """Every point of the JAX registry, ``mesh.device_lost`` included since
    the mesh was ported (the name is kept), in its order, with its doc."""
    assert faults.KNOWN_POINTS == tuple(jfaults.KNOWN_POINTS)
    assert faults.POINT_DOCS == dict(jfaults.POINT_DOCS)


@pytest.mark.parametrize("spec", [
    "ckpt.crash_between_state_and_meta@2",
    "step.nan_grads@3,4,5",
    "step.nan_grads:p=0.3:seed=11:max=4",
    "preempt.sigterm@7;step.hang:p=0.5:seed=2",
    "prefetch.producer_raises:p=0.1:seed=5",
])
def test_trainer_fault_schedules_equal_jax(spec):
    mine, ref = faults.parse_spec(spec), jfaults.parse_spec(spec)
    assert list(mine) == list(ref)
    for point in mine:
        assert mine[point].schedule(100) == ref[point].schedule(100)
    with faults.installed(spec), jfaults.installed(spec):
        fired = [(faults.fire(p), jfaults.fire(p)) for _ in range(40)
                 for p in TRAINER_POINTS]
        assert [a for a, _ in fired] == [b for _, b in fired]
        assert faults.counters() == jfaults.counters()


# ---------------------------------------------------------- fit: rollback

_TINY = {
    "model.hidden_dim": 8, "model.n_steps": 3, "model.num_output_layers": 2,
    "model.layout": "fused", "data.sample": True, "data.undersample": None,
    "data.feature.limit_all": 50, "data.batch.batch_graphs": 32,
    "data.batch.max_nodes": 160, "data.batch.max_edges": 320,
    "resilience.sentinel_patience": 2, "resilience.sentinel_lag": 1}


def _cfg(epochs: int, **extra):
    return load_config(overrides=_TINY | {"optim.max_epochs": epochs} | extra)


@pytest.fixture
def trainers(monkeypatch):
    """Every ``Trainer`` ``fit`` builds, kept to read its optimizer."""
    made = []

    class Kept(fit_mod.Trainer):
        def __post_init__(self):
            super().__post_init__()
            made.append(self)

    monkeypatch.setattr(fit_mod, "Trainer", Kept)
    return made


def _params(run_dir):
    mgr = CheckpointManager(run_dir / "checkpoints")
    return mgr.restore(mgr.latest_step())


def test_nan_grads_on_every_step_raises_divergence(tmp_path):
    """``step.nan_grads`` on every step with patience 2: every retry
    diverges again, and past ``max_rollbacks`` the error propagates."""
    cfg = _cfg(1, **{"resilience.max_rollbacks": 1})
    with faults.installed("step.nan_grads"):
        with pytest.raises(sen.DivergenceError):
            fit(cfg, tmp_path / "run", device="cpu")


def test_rollback_before_the_first_checkpoint_reinitialises(tmp_path,
                                                           trainers):
    """A divergence in epoch 0 re-initialises: the run then equals a clean
    run at the backed-off learning rate bit for bit (the parameters as
    make_model draws them, a fresh AdamW, a freshly seeded generator)."""
    cfg = _cfg(2)
    with faults.installed("step.nan_grads@2,3,4"):
        final = fit(cfg, tmp_path / "rolled", device="cpu")
    assert final["n_rollbacks"] == 1 and final["lr_scale"] == 0.5
    assert final["sentinel_bad_steps"] == 2  # the third was in the lag
    opt = trainers[0].optimizer
    assert all(g["lr"] == cfg.optim.lr * 0.5 for g in opt.param_groups)
    clean = _cfg(2, **{"optim.lr": cfg.optim.lr * 0.5})
    fit(clean, tmp_path / "clean", device="cpu")
    a, b = _params(tmp_path / "rolled"), _params(tmp_path / "clean")
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_rollback_restores_the_checkpoint_and_keeps_the_backoff(tmp_path,
                                                                trainers):
    """A divergence in epoch 1 restores epoch 0's checkpoint; loading its
    optimizer state must not undo the backoff, and a resume carries it."""
    cfg = _cfg(2)
    with faults.installed("step.nan_grads@100,101,102"):
        final = fit(cfg, tmp_path / "run", device="cpu")
        hits = faults.counters()["hits"]["step.nan_grads"]
    epoch_steps = CheckpointManager(tmp_path / "run" / "checkpoints").steps[0]
    assert epoch_steps < 100 < 102 < hits  # the armed hits fell in epoch 1
    assert final["n_rollbacks"] == 1 and final["lr_scale"] == 0.5
    for group in trainers[0].optimizer.param_groups:
        assert group["lr"] == cfg.optim.lr * 0.5
    resumed = fit(_cfg(3), tmp_path / "run", resume=True, device="cpu")
    assert resumed["n_rollbacks"] == 1 and resumed["lr_scale"] == 0.5
    for group in trainers[1].optimizer.param_groups:
        assert group["lr"] == cfg.optim.lr * 0.5


def test_train_epoch_closes_the_prefetch_thread_on_a_producer_fault(tmp_path):
    cfg = _cfg(1)
    with faults.installed("prefetch.producer_raises@3"):
        with pytest.raises(faults.InjectedFault, match="prefetch"):
            fit(cfg, tmp_path / "run", device="cpu")
    assert not [t for t in threading.enumerate()
                if t.name == "prefetch_to_device" and t.is_alive()]


def test_resilience_config_equals_jax_validation():
    from deepdfa_tpu.config import ResilienceConfig as JRes

    from deepdfa_tpu_torch.config import ResilienceConfig

    assert dataclasses.asdict(ResilienceConfig()) == dataclasses.asdict(JRes())
    for kw in ({"sentinel_patience": 0}, {"sentinel_lag": -1},
               {"lr_backoff": 0.0}, {"lr_backoff": 1.5},
               {"max_rollbacks": -1}, {"preempt_deadline_s": 0},
               {"step_deadline_s": -1}):
        with pytest.raises(ValueError) as mine:
            ResilienceConfig(**kw)
        with pytest.raises(ValueError) as ref:
            JRes(**kw)
        assert str(mine.value) == str(ref.value)
    assert np.isclose(ResilienceConfig(lr_backoff=0.25).lr_backoff, 0.25)
