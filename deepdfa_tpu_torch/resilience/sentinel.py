"""Divergence sentinel: the host-side watch over the train step's loss.

A copy of ``deepdfa_tpu/resilience/sentinel.py``. The in-step half of the
defence lives in ``train/loop.py``: a step whose loss or any gradient is
non-finite keeps the previous parameters, optimizer state and metrics and
reports its loss as NaN, so a bad batch never corrupts the model. This
module is the host half: it watches the per-step losses, counts
*consecutive* skipped steps and raises :class:`DivergenceError` after
``patience`` of them, so ``fit`` can roll back to the last good checkpoint
with a learning-rate backoff.

Reading a device scalar syncs the host with the card. The sentinel checks
with a **lag**: ``observe(loss)`` buffers the loss (a float or a 0-d
tensor, on any device) and converts only the one ``lag`` steps back, whose
value has long since been computed.
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field

__all__ = ["DivergenceError", "DivergenceSentinel"]


class DivergenceError(RuntimeError):
    """``patience`` consecutive non-finite-loss steps: training has
    diverged and the current optimizer trajectory is unrecoverable."""

    def __init__(self, consecutive: int):
        super().__init__(
            f"{consecutive} consecutive non-finite train steps — rolling back"
        )
        self.consecutive = consecutive


@dataclass
class DivergenceSentinel:
    """See module docstring. ``patience``: consecutive bad steps before
    raising; ``lag``: how many steps behind the check runs (0 = immediate)."""

    patience: int = 3
    lag: int = 2
    consecutive: int = 0
    n_steps: int = 0
    n_bad: int = 0
    _pending: deque = field(default_factory=deque, repr=False)

    def __post_init__(self):
        if self.patience < 1:
            raise ValueError("patience must be >= 1")
        if self.lag < 0:
            raise ValueError("lag must be >= 0")

    def observe(self, loss) -> None:
        """Buffer one step's loss; check the one ``lag`` steps back. Raises
        :class:`DivergenceError` when the consecutive-bad run hits
        ``patience``."""
        self._pending.append(loss)
        while len(self._pending) > self.lag:
            self._check(self._pending.popleft())

    def flush(self) -> None:
        """Drain the lag buffer (end of epoch): trailing bad steps still
        count toward the consecutive run."""
        while self._pending:
            self._check(self._pending.popleft())

    def reset(self) -> None:
        """After a rollback: forget the in-flight window and the consecutive
        run (the restored state starts clean); the cumulative stats stay."""
        self._pending.clear()
        self.consecutive = 0

    def stats(self) -> dict[str, int]:
        return {"sentinel_steps": self.n_steps, "sentinel_bad_steps": self.n_bad}

    def _check(self, loss) -> None:
        self.n_steps += 1
        if math.isfinite(float(loss)):
            self.consecutive = 0
            return
        self.n_bad += 1
        self.consecutive += 1
        if self.consecutive >= self.patience:
            raise DivergenceError(self.consecutive)
