"""Checkpointing: best/last/periodic policies, retention, crash-safe
commits, emergency checkpoints and the encoder transfer (partial load and
freeze).

The port of ``CheckpointManager`` (``deepdfa_tpu/train/checkpoint.py``)
with ``torch.save`` payloads in place of orbax. A step is written into
``{dir}/{step:08d}.tmp/`` — ``state.pt`` (the model's state dict), then
``aux.pt`` (the optimizer state, the generator state and the step, what
``fit(resume=True)`` needs), then ``meta.json`` — and only then renamed
into place with ``os.replace``. ``meta.json`` inside a committed directory
is therefore the commit marker (the ``ckpt.crash_between_state_and_meta``
fault point kills the process between the payload and the marker):
:meth:`CheckpointManager._scan` deletes
``*.tmp`` leftovers and marker-less step directories, and
:meth:`CheckpointManager.restore_resume` walks newest to oldest past any
step whose payload fails to load, so a corrupt step costs one step of
progress, never the run.

Payloads load with ``torch.load(weights_only=True)``: tensors, numbers and
containers only.

The encoder transfer (the reference's ``--freeze_graph``,
``main_cli.py:136-145``) works over state-dict keys: the head (``head.*``,
the JAX package's ``out_{i}``) and the pooling gate (``pooling.*``) are
re-initialised and trained, the rest loaded and frozen.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import time
from pathlib import Path
from typing import Any

import torch

from deepdfa_tpu_torch.config import CheckpointConfig
from deepdfa_tpu_torch.resilience import faults
from deepdfa_tpu_torch.resilience.journal import fsync_dir

__all__ = [
    "CheckpointManager",
    "encoder_partial_load",
    "freeze_mask",
    "frozen_encoder_optimizer",
    "is_head_key",
]


def is_head_key(key: str) -> bool:
    """State-dict entries of the classification head (``head.{i}``, the
    JAX package's ``out_{i}``) or the attention-pooling gate (``pooling``):
    left out and re-initialised on encoder transfer, the keys the reference
    drops (``main_cli.py:139-141``)."""
    return key.split(".", 1)[0] in ("pooling", "head")


class CheckpointManager:
    """best/last/periodic checkpoint policies over ``torch.save`` payloads."""

    _STEP_DIR = re.compile(r"\d{8}")

    def __init__(self, directory: str | Path, cfg: CheckpointConfig | None = None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.cfg = cfg or CheckpointConfig()
        self._saved: list[dict] = self._scan()

    # -- bookkeeping -------------------------------------------------------

    def _scan(self) -> list[dict]:
        # GC before indexing: a crash mid-commit leaves a *.tmp directory
        # (never renamed) or a step directory without its meta.json marker;
        # both are unreadable and must not shadow good checkpoints
        for entry in self.dir.iterdir():
            if not entry.is_dir():
                continue
            partial = entry.name.endswith(".tmp") or (
                self._STEP_DIR.fullmatch(entry.name)
                and not (entry / "meta.json").exists()
            )
            if partial:
                shutil.rmtree(entry, ignore_errors=True)
        out = []
        for meta_file in sorted(self.dir.glob("*/meta.json")):
            try:
                out.append(json.loads(meta_file.read_text()))
            except (OSError, json.JSONDecodeError):
                continue
        return sorted(out, key=lambda m: m["step"])

    def _path(self, step: int) -> Path:
        return self.dir / f"{step:08d}"

    @property
    def steps(self) -> list[int]:
        return [m["step"] for m in self._saved]

    # -- save --------------------------------------------------------------

    def save(self, step: int, state: Any, metrics: dict[str, float] | None = None,
             epoch: int | None = None, aux: Any | None = None,
             preempted: dict | None = None, force: bool = False) -> bool:
        """Save if any policy wants this step, then apply retention. Returns
        whether a checkpoint was written. ``state`` and ``aux`` are anything
        ``torch.save`` writes (tensors, numbers, containers); ``aux`` is
        restored by :meth:`restore_aux` only. ``preempted`` (``{"steps_done":
        n, "reason": ...}``) lands in ``meta.json`` for the mid-epoch
        resume; ``force`` commits whatever the policies say (the emergency
        checkpoint)."""
        metrics = {k: float(v) for k, v in (metrics or {}).items()}
        reasons = []
        if force:
            reasons.append("emergency")
        if self.cfg.save_last:
            reasons.append("last")
        if epoch is not None and self.cfg.periodic_every and (
            epoch % self.cfg.periodic_every == 0
        ):
            reasons.append("periodic")
        metric = metrics.get(self.cfg.save_best_metric)
        if metric is not None and self._is_best(metric):
            reasons.append("best")
        if not reasons:
            return False

        # build the whole step sideways, meta.json last, then one rename
        path = self._path(step)
        tmp = path.with_name(path.name + ".tmp")
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        torch.save(state, tmp / "state.pt")
        if aux is not None:
            torch.save(aux, tmp / "aux.pt")
        faults.crash_if("ckpt.crash_between_state_and_meta")
        meta = dict(step=int(step), epoch=epoch, metrics=metrics, reasons=reasons)
        if preempted is not None:
            meta["preempted"] = dict(preempted)
        (tmp / "meta.json").write_text(json.dumps(meta))
        if path.exists():
            shutil.rmtree(path)
        os.replace(tmp, path)
        fsync_dir(self.dir)
        # overwriting a step replaces its bookkeeping entry
        self._saved = [m for m in self._saved if m["step"] != int(step)]
        self._saved.append(meta)
        self._saved.sort(key=lambda m: m["step"])
        self._retain()
        return True

    def save_emergency(self, step: int, state: Any, *, epoch: int | None,
                       aux: Any | None = None, steps_done: int = 0,
                       reason: str = "preempted") -> float:
        """The preemption path's save: a forced commit through the ordinary
        atomic protocol whose ``meta.json`` records how far into the epoch
        the run got (the resume replays the epoch's deterministic stream and
        skips ``steps_done`` batches). Returns the commit's wall seconds,
        which the caller holds against ``resilience.preempt_deadline_s``.
        Tensors on the card are copied to the host inside the timed
        commit, after the stream has finished the step that made them."""
        t0 = time.monotonic()
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.save(step, state, metrics={}, epoch=epoch, aux=aux,
                  preempted={"steps_done": int(steps_done), "reason": reason},
                  force=True)
        return time.monotonic() - t0

    def _is_best(self, value: float) -> bool:
        best = self.best_metric()
        if best is None:
            return True
        return value < best if self.cfg.save_best_mode == "min" else value > best

    def best_metric(self) -> float | None:
        vals = [
            m["metrics"][self.cfg.save_best_metric]
            for m in self._saved
            if self.cfg.save_best_metric in m.get("metrics", {})
            and "best" in m.get("reasons", ())
        ]
        if not vals:
            return None
        return min(vals) if self.cfg.save_best_mode == "min" else max(vals)

    def _retain(self) -> None:
        """Keep the best checkpoint, every periodic one and the newest
        ``cfg.keep``; delete the rest."""
        keep_steps = set(self.steps[-max(self.cfg.keep, 1):])
        best = self.best_step()
        if best is not None:
            keep_steps.add(best)
        for m in self._saved:
            if "periodic" in m.get("reasons", ()):
                keep_steps.add(m["step"])
        for m in list(self._saved):
            if m["step"] not in keep_steps:
                shutil.rmtree(self._path(m["step"]), ignore_errors=True)
                self._saved.remove(m)

    # -- load --------------------------------------------------------------

    def best_step(self) -> int | None:
        """Step of the best checkpoint by the configured metric."""
        candidates = [
            m for m in self._saved if self.cfg.save_best_metric in m.get("metrics", {})
        ]
        if not candidates:
            return None
        key = lambda m: m["metrics"][self.cfg.save_best_metric]
        pick = min if self.cfg.save_best_mode == "min" else max
        return pick(candidates, key=key)["step"]

    def latest_step(self) -> int | None:
        return self.steps[-1] if self._saved else None

    def restore(self, step: int, map_location=None) -> Any:
        """The ``state`` payload of a step."""
        return torch.load(self._path(step) / "state.pt", map_location=map_location,
                          weights_only=True)

    def restore_best(self, map_location=None) -> Any:
        step = self.best_step()
        if step is None:
            raise FileNotFoundError("no best checkpoint recorded")
        return self.restore(step, map_location)

    def restore_latest(self, map_location=None) -> Any:
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoints")
        return self.restore(step, map_location)

    def restore_aux(self, step: int, map_location=None) -> Any:
        """The ``aux`` payload of a step (see :meth:`save`)."""
        path = self._path(step) / "aux.pt"
        if not path.exists():
            raise FileNotFoundError(f"checkpoint {step} has no aux payload ({path})")
        return torch.load(path, map_location=map_location, weights_only=True)

    def restore_resume(self, map_location=None) -> tuple[int, dict, Any, Any]:
        """Walk checkpoints newest to oldest and return the first that
        restores cleanly as ``(step, meta, state, aux)``. A checkpoint
        without its aux payload does not restore: resume needs the whole
        trainer state."""
        last_exc: Exception | None = None
        for m in reversed(self._saved):
            step = int(m["step"])
            try:
                state = self.restore(step, map_location)
                aux = self.restore_aux(step, map_location)
                return step, m, state, aux
            except Exception as exc:  # noqa: BLE001 — fall back to an older step
                last_exc = exc
                continue
        raise FileNotFoundError(
            f"no restorable checkpoint under {self.dir}"
        ) from last_exc

    def meta(self, step: int) -> dict:
        return json.loads((self._path(step) / "meta.json").read_text())


# ---------------------------------------------------------------------------
# encoder transfer (freeze_graph)


def encoder_partial_load(init_state: dict, ckpt_state: dict) -> dict:
    """``init_state`` with every entry of ``ckpt_state`` laid over it,
    *except* the head and the pooling gate, which keep their fresh values
    (``main_cli.py:136-145``: the checkpoint loaded minus ``out``/pooling)."""
    out = dict(init_state)
    for key, value in ckpt_state.items():
        if not is_head_key(key) and key in out:
            out[key] = value
    return out


def freeze_mask(state: dict) -> dict[str, bool]:
    """``{key: trainable}`` over a state dict: True for the head and the
    pooling gate, False for the frozen encoder."""
    return {key: is_head_key(key) for key in state}


def frozen_encoder_optimizer(model: torch.nn.Module, make_optimizer):
    """``make_optimizer(params)`` over the head and pooling parameters of
    ``model`` only (the ``--freeze_graph`` training mode,
    ``main_cli.py:142-145``). The encoder's parameters get
    ``requires_grad=False`` and stay out of the optimizer, so no update
    touches them, weight decay included (``optax.set_to_zero`` zeroes the
    whole update)."""
    trainable = []
    for name, param in model.named_parameters():
        keep = is_head_key(name)
        param.requires_grad_(keep)
        if keep:
            trainable.append(param)
    return make_optimizer(trainable)
