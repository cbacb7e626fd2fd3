"""The port's tuning loop (deepdfa_tpu_torch/train/tune.py) against the
JAX package's: the search spaces and the median pruner's decisions on the
same curves, the selection of the best trial, and sweeps of the port's
``fit`` in process and in a child process (``python -m
deepdfa_tpu_torch.train.cli fit --device cpu``).

Tolerances: none — spaces, decisions, selections and the child's metrics
against its own ``final_metrics.json`` are compared exactly.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deepdfa_tpu.train import tune as jtune  # noqa: E402

from deepdfa_tpu_torch.train import tune  # noqa: E402

SPACE = {"optim.lr": [1e-3, 3e-4, 1e-4], "model.hidden_dim": [8, 16],
         "data.undersample": [None, "v1.0"]}
_TINY = {
    "model.hidden_dim": 8, "model.n_steps": 2, "model.num_output_layers": 2,
    "model.layout": "fused", "data.sample": True, "data.undersample": None,
    "data.feature.limit_all": 50, "data.batch.batch_graphs": 32,
    "data.batch.max_nodes": 160, "data.batch.max_edges": 320,
    "optim.max_epochs": 1}


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
    monkeypatch.setenv("DEEPDFA_STORAGE",
                       str(tmp_path_factory.mktemp("storage")))


def test_spaces_equal_jax():
    assert list(tune.grid_space(SPACE)) == list(jtune.grid_space(SPACE))
    for seed in (0, 3):
        assert list(tune.sample_space(SPACE, 9, seed=seed)) == list(
            jtune.sample_space(SPACE, 9, seed=seed))


CURVES = [[0.1, 0.2, 0.3, 0.35], [0.2, 0.1, 0.4, 0.5], [0.3, 0.3, 0.1, 0.1],
          [0.0, 0.0, 0.0], [0.5], [0.2, 0.25, 0.3, 0.3, 0.9]]


@pytest.mark.parametrize("warmup,history", [(0, 1), (1, 2), (2, 2), (3, 1)])
def test_the_median_pruner_decides_as_jax(warmup, history):
    mine = tune.MedianPruner(warmup_epochs=warmup, min_history=history)
    ref = jtune.MedianPruner(warmup_epochs=warmup, min_history=history)
    for curve in CURVES:
        decisions = [(mine.should_prune(e, f1), ref.should_prune(e, f1))
                     for e, f1 in enumerate(curve)]
        assert [a for a, _ in decisions] == [b for _, b in decisions]
        mine.record(curve)
        ref.record(curve)
    assert mine.histories == ref.histories


def test_trial_objective_and_selection_equal_jax():
    rows = [(0, {"a": 1}, {"val_F1Score": 0.4}, None, False),
            (1, {"a": 2}, {"val_F1Score": 0.7}, None, True),
            (2, {"a": 3}, {"val_F1Score": 0.9}, "boom", False),
            (3, {"a": 4}, {}, None, False)]
    mine = [tune.Trial(*r) for r in rows]
    ref = [jtune.Trial(*r) for r in rows]
    assert [t.objective for t in mine] == [t.objective for t in ref]
    assert tune.best_trial(mine).trial_id == jtune.best_trial(ref).trial_id
    for mod in (tune, jtune):
        with pytest.raises(ValueError, match="no trials"):
            mod.best_trial([])
        with pytest.raises(ValueError, match="isolate=True"):
            mod.run_trials(iter([{}]), "unused", pruner=mod.MedianPruner())


def test_an_in_process_grid_and_its_selection(tmp_path):
    grid = {"optim.lr": [1e-3, 0.0], "model.n_steps": [2]}
    trials = tune.run_trials(tune.grid_space(grid), tmp_path,
                             base_overrides=_TINY, device="cpu")
    assert [t.overrides for t in trials] == [
        _TINY | c for c in jtune.grid_space(grid)]
    assert all(t.error is None and "val_F1Score" in t.metrics
               for t in trials)
    for t in trials:
        final = json.loads((tmp_path / f"trial_{t.trial_id}" /
                            "final_metrics.json").read_text())
        assert t.metrics == {k: v for k, v in final.items()
                             if isinstance(v, float)}
    ref = [jtune.Trial(t.trial_id, t.overrides, t.metrics) for t in trials]
    assert tune.best_trial(trials).overrides == \
        jtune.best_trial(ref).overrides
    logged = [json.loads(line) for line in
              (tmp_path / "trials.jsonl").read_text().splitlines()]
    assert [sorted(r) for r in logged] == [
        ["error", "metrics", "overrides", "pruned", "trial_id"]] * 2
    # a bad draw is recorded, never raised
    bad = tune.run_trials(iter([{"model.layout": "nope"}]), tmp_path / "bad",
                          base_overrides=_TINY, device="cpu")
    assert bad[0].error and bad[0].objective == float("-inf")


def test_an_isolated_trial_runs_the_cli_in_a_child(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the child's threads
    trials = tune.run_trials(iter([{"optim.lr": 1e-3}]), tmp_path,
                             base_overrides=_TINY, isolate=True,
                             device="cpu")
    run = tmp_path / "trial_0"
    assert trials[0].error is None, trials[0].error
    final = json.loads((run / "final_metrics.json").read_text())
    assert trials[0].metrics == {k: v for k, v in final.items()
                                 if isinstance(v, float)}
    assert np.isfinite(trials[0].objective)
    config = json.loads((run / "config.json").read_text())
    assert config["optim"]["lr"] == 1e-3 and config["model"]["n_steps"] == 2
    assert "device=cpu" in (run / "run.log").read_text()
