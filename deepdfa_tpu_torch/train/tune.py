"""Hyperparameter tuning: the NNI hooks' replacement.

The port of ``deepdfa_tpu/train/tune.py``. The reference wires NNI into
parameter injection (``DDFA/code_gnn/main_cli.py:110-121``), per-epoch
intermediate F1 reports (``base_module.py:346``) and the final F1
(``main_cli.py:184``). Here a self-contained search loop works over the
typed config:

- a **search space** maps dotted config keys to value lists
  (``{"model.hidden_dim": [32, 64], "optim.lr": [1e-3, 3e-4]}``), passed
  to :func:`~deepdfa_tpu_torch.config.load_config` as overrides;
- each trial runs ``fit``; the per-epoch ``tuning.jsonl`` it writes is the
  intermediate-report stream and its ``val_F1Score`` the final report;
- trials append to ``trials.jsonl``; :func:`best_trial` picks the winner
  (objective: the final validation F1).

``isolate=True`` runs every trial as ``python -m
deepdfa_tpu_torch.train.cli fit`` in a child process with ``--device``
passed through: its CUDA context and memory die with it, and a crashing
trial cannot take the sweep down. ``pruner=MedianPruner(...)`` tails each
live trial's ``tuning.jsonl`` and stops it when its validation F1 falls
below the median of earlier trials at the same epoch (NNI's
``Medianstop``); a pruned trial keeps its best F1 so far as its objective.
When the optional ``nni`` package imports, results are also reported to
it.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import logging
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Iterator, Mapping, Sequence

import numpy as np

logger = logging.getLogger("deepdfa_tpu_torch")

__all__ = [
    "MedianPruner",
    "Trial",
    "best_trial",
    "grid_space",
    "run_trials",
    "sample_space",
]


@dataclasses.dataclass(frozen=True)
class Trial:
    trial_id: int
    overrides: dict[str, Any]
    metrics: dict[str, float]
    error: str | None = None  # set when the trial raised; objective -inf
    pruned: bool = False  # stopped early; metrics hold the best so far

    @property
    def objective(self) -> float:
        if self.error is not None:
            return float("-inf")
        return self.metrics.get("val_F1Score", float("-inf"))


@dataclasses.dataclass
class MedianPruner:
    """NNI ``Medianstop``: stop a trial whose val F1 at epoch *e* is below
    the median of the earlier trials' F1 at epoch *e*, after
    ``warmup_epochs`` and once ``min_history`` earlier curves reach *e*."""

    warmup_epochs: int = 2
    min_history: int = 2
    poll_seconds: float = 0.25
    histories: list[list[float]] = dataclasses.field(default_factory=list)

    def should_prune(self, epoch: int, f1: float) -> bool:
        if epoch < self.warmup_epochs:
            return False
        at_epoch = [h[epoch] for h in self.histories if len(h) > epoch]
        if len(at_epoch) < self.min_history:
            return False
        return f1 < float(np.median(at_epoch))

    def record(self, curve: list[float]) -> None:
        self.histories.append(curve)


def sample_space(space: Mapping[str, Sequence[Any]], n_trials: int,
                 seed: int = 0) -> Iterator[dict[str, Any]]:
    """Random search: each key drawn independently per trial."""
    rng = np.random.default_rng(seed)
    for _ in range(n_trials):
        yield {k: v[int(rng.integers(len(v)))] for k, v in space.items()}


def grid_space(space: Mapping[str, Sequence[Any]]) -> Iterator[dict[str, Any]]:
    """Exhaustive grid search."""
    keys = list(space)
    for combo in itertools.product(*(space[k] for k in keys)):
        yield dict(zip(keys, combo))


def _read_curve(tuning_file: Path) -> list[float]:
    """The per-epoch val F1 curve of a (possibly growing) tuning.jsonl."""
    if not tuning_file.exists():
        return []
    curve: list[float] = []
    for line in tuning_file.read_text().splitlines():
        try:
            row = json.loads(line)
        except json.JSONDecodeError:  # the torn tail of a write in flight
            break
        if "epoch" in row:
            curve.append(float(row["val_F1Score"]))
    return curve


def _trial_command(configs: Sequence[str], overrides: Mapping[str, Any],
                   run_dir: Path, device) -> list[str]:
    cmd = [sys.executable, "-m", "deepdfa_tpu_torch.train.cli", "fit",
           "--run-dir", str(run_dir)]
    for c in configs:
        cmd += ["--config", str(c)]
    for key, value in overrides.items():
        cmd += ["--set", f"{key}={json.dumps(value)}"]
    if device is not None:
        cmd += ["--device", str(device)]
    return cmd


def _run_trial_isolated(cmd: list[str], run_dir: Path,
                        pruner: MedianPruner | None
                        ) -> tuple[dict, str | None, bool]:
    """One trial in a child process; the parent tails ``tuning.jsonl`` for
    the pruner. Returns (metrics, error, pruned)."""
    repo_root = Path(__file__).resolve().parents[2]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(repo_root), env.get("PYTHONPATH")) if p)
    stderr_path = run_dir / "trial_stderr.log"
    tuning_file = run_dir / "tuning.jsonl"
    pruned = False
    with open(stderr_path, "w") as stderr_f:
        # stderr into a file: a chatty child would fill a pipe and stall
        proc = subprocess.Popen(cmd, env=env, cwd=repo_root,
                                stdout=subprocess.DEVNULL, stderr=stderr_f)
        try:
            while proc.poll() is None:
                time.sleep(pruner.poll_seconds if pruner else 0.5)
                if pruner is None:
                    continue
                curve = _read_curve(tuning_file)
                if any(pruner.should_prune(e, f1)
                       for e, f1 in enumerate(curve)):
                    proc.kill()
                    pruned = True
                    break
        finally:
            if proc.poll() is None and not pruned:
                proc.kill()
            proc.wait()
    stderr = stderr_path.read_text() if stderr_path.exists() else ""
    curve = _read_curve(tuning_file)
    if pruner is not None:
        pruner.record(curve)
    if pruned:
        return {"val_F1Score": max(curve, default=float("-inf"))}, None, True
    if proc.returncode != 0:
        return {}, f"trial subprocess rc={proc.returncode}: {stderr[-500:]}", \
            False
    final = run_dir / "final_metrics.json"
    metrics = json.loads(final.read_text()) if final.exists() else {}
    return metrics, None, False


def run_trials(candidates: Iterator[dict[str, Any]], out_dir: str | Path,
               configs: Sequence[str] = (),
               base_overrides: Mapping[str, Any] | None = None,
               isolate: bool = False, pruner: MedianPruner | None = None,
               device=None) -> list[Trial]:
    """One ``fit`` per candidate override set on ``device`` (``cuda``
    unless the caller names another), each in ``out_dir/trial_{i}``; every
    trial logged to ``trials.jsonl``. A failing trial is recorded
    (objective -inf), not raised: a bad draw must not end the sweep.

    ``isolate=True``: a child process per trial. ``pruner``: median early
    stopping on the live ``tuning.jsonl`` (needs ``isolate=True``)."""
    if pruner is not None and not isolate:
        raise ValueError("pruning requires isolate=True (a live child to stop)")
    if not isolate:
        # imported once, outside the per-trial try: a broken environment
        # raises instead of passing for N failed draws
        from deepdfa_tpu_torch.config import load_config
        from deepdfa_tpu_torch.train.fit import fit
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    trials_file = out_dir / "trials.jsonl"
    trials: list[Trial] = []
    for i, overrides in enumerate(candidates):
        merged = {**(base_overrides or {}), **overrides}
        run_dir = out_dir / f"trial_{i}"
        run_dir.mkdir(parents=True, exist_ok=True)
        error = None
        pruned = False
        metrics: dict = {}
        if isolate:
            try:
                cmd = _trial_command(configs, merged, run_dir, device)
            except TypeError as exc:
                error = f"overrides not serialisable: {exc}"
            else:
                metrics, error, pruned = _run_trial_isolated(cmd, run_dir,
                                                             pruner)
        else:
            try:
                cfg = load_config(*configs, overrides=merged)
                metrics = fit(cfg, run_dir, device=device)
            except Exception as exc:  # noqa: BLE001 — the sweep survives
                logger.warning("trial %d failed: %s", i, exc)
                error = str(exc)
        trial = Trial(i, dict(merged),
                      {k: v for k, v in metrics.items()
                       if isinstance(v, float)},
                      error=error, pruned=pruned)
        trials.append(trial)
        with open(trials_file, "a") as f:
            f.write(json.dumps({"trial_id": i, "overrides": trial.overrides,
                                "metrics": trial.metrics,
                                "error": trial.error,
                                "pruned": trial.pruned}) + "\n")
        _forward_to_nni(trial)
    return trials


def _forward_to_nni(trial: Trial) -> None:
    try:
        import nni
    except ImportError:
        return
    nni.report_final_result(trial.objective)


def best_trial(trials: Sequence[Trial]) -> Trial:
    if not trials:
        raise ValueError("no trials")
    return max(trials, key=lambda t: t.objective)
