"""FLOPs and latency profiling with the reference's jsonl schema.

The port of ``deepdfa_tpu/train/profiling.py``. The reference profiles
with DeepSpeed's ``FlopsProfiler`` (FLOPs/MACs per test batch →
``profiledata.jsonl``) and CUDA-event wall timing (``timedata.jsonl``),
``base_module.py:240-281``, and aggregates with
``scripts/report_profiling.py``. Here:

- FLOPs from ``torch.utils.flop_counter.FlopCounterMode`` over one call of
  the step (:func:`flops_of`, or ``StepProfiler.step(count=True)``, which
  counts the profiled call itself): the matrix products PyTorch
  dispatches, and each hand-written kernel's formula
  (:mod:`deepdfa_tpu_torch.ops.flops`), so a count is the same on the card
  and on the CPU. The mode changes no value;
- wall time on the host around a step that has been synchronized
  (``torch.cuda.synchronize()`` for the devices the step's outputs lie on,
  the JAX version's ``block_until_ready``);
- the same jsonl rows, so the reference's aggregation (GFLOPs / ms per
  example) carries over in :func:`report`.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Any, Callable

import torch
from torch.utils import _pytree
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["flops_of", "StepProfiler", "report"]


def _total(counter: FlopCounterMode) -> float | None:
    return float(counter.get_total_flops()) or None


def flops_of(fn: Callable, *args, **kwargs) -> float | None:
    """FLOPs of one call of ``fn(*args, **kwargs)`` under
    ``FlopCounterMode``, without gradients; None when it counts none. The
    call runs (on the card it launches its kernels) and its result is
    discarded."""
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        fn(*args, **kwargs)
    return _total(counter)


def _block_until_ready(out: Any) -> None:
    """Wait for every card that holds a tensor of ``out``."""
    devices = {t.device for t in _pytree.tree_leaves(out)
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


class StepProfiler:
    """Per-batch profiling writer (``profiledata.jsonl`` +
    ``timedata.jsonl``).

    The reference skips the first batches to avoid warm-up skew
    (``base_module.py:240-248`` profiles batches > 2); ``skip_first`` does
    the same (the first calls also bear the kernels' builds)."""

    def __init__(self, out_dir: str | Path, skip_first: int = 2):
        self.dir = Path(out_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.skip_first = skip_first
        self._n = 0
        self.last_flops: float | None = None
        self._profile_rows: list[dict] = []
        self._time_rows: list[dict] = []

    def step(self, fn: Callable, *args, batch_size: int,
             flops: float | None = None, count: bool = False) -> Any:
        """Run one profiled step (synchronized) and record it. Warm-up
        batches (the first ``skip_first``) are written with ``warmup: true``
        so :func:`report` can exclude them. ``count``: the step runs under
        ``FlopCounterMode`` and its count, kept in ``last_flops``, is
        recorded in place of ``flops`` (its time then holds the counter's
        host work, as the JAX version's first call of a shape holds its
        compile)."""
        counter = FlopCounterMode(display=False) if count else None
        t0 = time.perf_counter()
        with counter or contextlib.nullcontext():
            out = fn(*args)
        _block_until_ready(out)
        ms = (time.perf_counter() - t0) * 1e3
        if counter is not None:
            flops = self.last_flops = _total(counter)
        self._n += 1
        warmup = self._n <= self.skip_first
        if flops is not None:
            self._profile_rows.append(
                {"batch": self._n, "flops": flops, "macs": flops / 2,
                 "batch_size": batch_size, "warmup": warmup})
        self._time_rows.append(
            {"batch": self._n, "ms": ms, "batch_size": batch_size,
             "warmup": warmup})
        return out

    def flush(self) -> tuple[Path, Path]:
        pf = self.dir / "profiledata.jsonl"
        tf = self.dir / "timedata.jsonl"
        with open(pf, "w") as f:
            for row in self._profile_rows:
                f.write(json.dumps(row) + "\n")
        with open(tf, "w") as f:
            for row in self._time_rows:
                f.write(json.dumps(row) + "\n")
        return pf, tf


def report(out_dir: str | Path) -> dict[str, float]:
    """Aggregate the jsonl files as ``scripts/report_profiling.py`` does:
    mean GFLOPs / GMACs / latency per example."""
    out_dir = Path(out_dir)
    stats: dict[str, float] = {}

    def load(path: Path) -> list[dict]:
        if not path.exists():
            return []
        rows = [json.loads(line) for line in path.read_text().splitlines()
                if line.strip()]
        steady = [r for r in rows if not r.get("warmup")]
        # a tiny corpus may give only warm-up batches: skewed numbers beat
        # none
        return steady or rows

    rows = load(out_dir / "profiledata.jsonl")
    if rows:
        n_ex = sum(r["batch_size"] for r in rows)
        stats["gflops_per_example"] = sum(r["flops"] for r in rows) / n_ex / 1e9
        stats["gmacs_per_example"] = sum(r["macs"] for r in rows) / n_ex / 1e9
    rows = load(out_dir / "timedata.jsonl")
    if rows:
        n_ex = sum(r["batch_size"] for r in rows)
        total_ms = sum(r["ms"] for r in rows)
        stats["ms_per_example"] = total_ms / n_ex
        stats["examples_per_sec"] = n_ex / (total_ms / 1e3) if total_ms \
            else 0.0
    return stats
