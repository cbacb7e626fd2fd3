"""Per-epoch class rebalancing, host-side.

A copy of the JAX package's ``deepdfa_tpu/data/sampler.py`` (numpy only):
each epoch re-draws the non-vulnerable subset and reshuffles. The ``"vX"``
undersample syntax keeps ``X × n_vul`` non-vul examples; a plain float
keeps that fraction of all non-vul; ``oversample`` duplicates vul examples
with replacement. The output is an ordering of graph indices, which the
fixed-shape ``GraphBatcher`` consumes. One seed and epoch give the same
indices in both packages.
"""

from __future__ import annotations

import numpy as np

__all__ = ["epoch_indices", "positive_weight"]


def epoch_indices(
    labels: np.ndarray,
    undersample: str | float | None = "v1.0",
    oversample: float | None = None,
    seed: int = 0,
    epoch: int = 0,
    shuffle: bool = True,
) -> np.ndarray:
    """Return the example indices to visit this epoch.

    ``labels``: per-example {0,1} vulnerability labels.
    """
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    idx = np.arange(len(labels))
    vul = idx[labels == 1]
    nonvul = idx[labels == 0]
    if undersample is not None:
        if isinstance(undersample, str) and undersample.startswith("v"):
            k = int(len(vul) * float(undersample[1:]))
        else:
            k = int(len(nonvul) * float(undersample))
        k = min(k, len(nonvul))
        nonvul = rng.choice(nonvul, size=k, replace=False)
    if oversample is not None:
        vul = rng.choice(vul, size=int(len(vul) * oversample), replace=True)
    out = np.concatenate([vul, nonvul])
    if shuffle:
        rng.shuffle(out)
    return out


def positive_weight(labels: np.ndarray) -> float:
    """``n_neg / n_pos`` over the train set, the BCE ``pos_weight``."""
    n_pos = int((labels == 1).sum())
    n_neg = int(len(labels) - n_pos)
    return n_neg / max(n_pos, 1)
