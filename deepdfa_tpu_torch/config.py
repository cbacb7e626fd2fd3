"""Typed configuration for the PyTorch port.

A trimmed copy of the JAX package's ``deepdfa_tpu/config.py``: the fields
the fused-layout scoring path and the trainer (``train.fit``) read. Field
names, defaults and derived properties are unchanged, so a config written
for the JAX package builds the same model and run here. A config that asks
for a part of the JAX package this port does not have yet (a mesh, the
serving shell, telemetry, preemption, divergence rollback, ...) raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

__all__ = ["ALL_SUBKEYS", "BatchConfig", "CheckpointConfig", "DataConfig",
           "DFA_FEATURE_DIMS", "DFA_LIVE_OUT_CLIP", "ExperimentConfig",
           "FeatureConfig", "GGNNConfig", "IDFA_REACH_CLIP", "LAYOUTS",
           "OptimConfig", "ResilienceConfig", "SINGLE_SUBKEYS", "load_config"]

ALL_SUBKEYS = ("api", "datatype", "literal", "operator")

# Subkeys whose per-definition value is single-valued: datatype has exactly
# one value per definition.
SINGLE_SUBKEYS = {"api": False, "datatype": True, "literal": False, "operator": False}

# The static-analysis feature families (cpg/analyses.py) and the
# interprocedural ones (cpg/interproc.py): small closed value sets, each
# clipped into a fixed-size embedding table. live_out counts live
# variables (clipped), uninit flags a possibly-uninitialized read, taint is
# 0 untouched / 1 uses / 2 introduces; ireach counts reaching definitions
# owned by another method (clipped), itaint is the interprocedural taint
# code, 3 where only a cross-call flow taints the node.
DFA_LIVE_OUT_CLIP = 16
IDFA_REACH_CLIP = 8
DFA_FEATURE_DIMS = {
    "live_out": DFA_LIVE_OUT_CLIP + 1, "uninit": 2, "taint": 3,
    "ireach": IDFA_REACH_CLIP + 1, "itaint": 4,
}

# Layouts this package runs, and the roadmap item that ports each other one.
LAYOUTS = ("segment", "fused", "megabatch")
_LATER_LAYOUTS = {
    "dense": "ROADMAP queue A, item A10 (dense layout)",
}


@dataclass(frozen=True)
class FeatureConfig:
    """Abstract-dataflow feature vocabulary settings.

    ``input_dim = limit_all + 2`` accounts for the not-a-definition token (0)
    and the UNKNOWN token. The family flags carry over to the model, which
    refuses them until ROADMAP A3 ports the families.
    """

    subkeys: tuple[str, ...] = ALL_SUBKEYS
    limit_subkeys: int | None = 1000
    limit_all: int | None = 1000
    combined: bool = True
    include_unknown: bool = False
    dataflow_families: bool = False
    interproc_families: bool = False

    def __post_init__(self):
        for k in self.subkeys:
            if k not in ALL_SUBKEYS:
                raise ValueError(f"unknown subkey {k!r}")

    @property
    def input_dim(self) -> int:
        if not self.combined:
            raise NotImplementedError("multi-hot (non-combined) features")
        assert self.limit_all is not None
        return self.limit_all + 2


@dataclass(frozen=True)
class GGNNConfig:
    """GGNN architecture (golden values: ``configs/ggnn.yaml``).

    ``layout`` is ``segment`` (gather + segment sum per round, plain torch),
    ``fused`` (every message round, forward and backward, on the
    hand-written CUDA kernels of :mod:`deepdfa_tpu_torch.ops.fused_ggnn`) or
    ``megabatch`` (the whole forward on the CUDA kernel of
    :mod:`deepdfa_tpu_torch.ops.megabatch`, trained through the fused
    kernels). All three share one parameter set. ``bwd_kernel`` is the
    fused layout's backward option (``auto`` | ``pallas`` | ``xla``): on
    the card ``auto`` and ``pallas`` run the backward kernel and ``xla``
    raises when training (see
    :func:`~deepdfa_tpu_torch.ops.fused_ggnn.fused_ggnn`).
    """

    hidden_dim: int = 32
    n_steps: int = 5
    num_output_layers: int = 3
    label_style: str = "graph"
    concat_all_absdf: bool = True
    encoder_mode: bool = False
    aggregation: str = "sum"
    dtype: str = "float32"
    layout: str = "segment"
    dataflow_families: bool = False
    interproc_families: bool = False
    bwd_kernel: str = "auto"

    def __post_init__(self):
        if self.layout in _LATER_LAYOUTS:
            raise NotImplementedError(
                f"layout={self.layout!r} is not ported yet: "
                f"{_LATER_LAYOUTS[self.layout]}")
        if self.layout not in LAYOUTS:
            raise ValueError(
                f"unknown layout {self.layout!r} (one of {', '.join(LAYOUTS)})")

    @property
    def out_dim(self) -> int:
        """Pooled embedding width: embed + hidden, each ×4 when the four
        subkey embeddings are concatenated."""
        mult = len(ALL_SUBKEYS) if self.concat_all_absdf else 1
        return 2 * self.hidden_dim * mult


@dataclass(frozen=True)
class BatchConfig:
    """Static-shape batch budgets."""

    batch_graphs: int = 256  # graphs per batch (``config_bigvul.yaml`` batch 256)
    max_nodes: int = 40960  # node budget incl. 1 padding node
    max_edges: int = 81920  # edge budget
    # True: graphs that alone exceed the budget go through a dedicated
    # overflow bucket (nothing silently lost). False: raise on the first.
    drop_oversize: bool = True
    # derive bucket budgets from corpus statistics (data/graphs.derive_buckets),
    # capped by the max_nodes/max_edges ceilings above
    auto_buckets: bool = True


@dataclass(frozen=True)
class DataConfig:
    dsname: str = "bigvul"
    sample: bool = False
    split: str = "fixed"
    seed: int = 0
    undersample: str | None = "v1.0"  # "vX" = X × #vul nonvul kept
    oversample: float | None = None
    # host→device prefetch depth for training/eval streams
    # (data/prefetch.py); 0 disables
    prefetch: int = 2
    batch: BatchConfig = field(default_factory=BatchConfig)
    feature: FeatureConfig = field(default_factory=FeatureConfig)


@dataclass(frozen=True)
class OptimConfig:
    """Golden values from ``configs/default.yaml``."""

    lr: float = 1e-3
    weight_decay: float = 1e-2
    max_epochs: int = 25
    use_weighted_loss: bool = True
    grad_clip: float | None = None
    # node-label training only (ROADMAP A3); graph labels ignore it
    undersample_node_on_loss_factor: float | None = None


@dataclass(frozen=True)
class CheckpointConfig:
    """best/last/periodic checkpoint policies and retention."""

    save_best_metric: str = "val_loss"
    save_best_mode: str = "min"
    save_last: bool = True
    periodic_every: int = 25
    keep: int = 3


@dataclass(frozen=True)
class ResilienceConfig:
    """The in-step non-finite guard: when ``sentinel`` is on, a step whose
    loss or any gradient is non-finite keeps the previous parameters,
    optimizer state and metrics and reports a NaN loss. The rest of the JAX
    package's resilience block (rollback, preemption, watchdog) is not
    ported yet."""

    sentinel: bool = True


@dataclass(frozen=True)
class ExperimentConfig:
    data: DataConfig = field(default_factory=DataConfig)
    model: GGNNConfig = field(default_factory=GGNNConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
    seed: int = 0
    run_name: str | None = None

    def __post_init__(self):
        # data→model link for the static-analysis families, as in the JAX
        # package (the model then refuses them until they are ported)
        feat = self.data.feature
        for flag in ("dataflow_families", "interproc_families"):
            if getattr(feat, flag) and not getattr(self.model, flag):
                object.__setattr__(self, "model", dataclasses.replace(
                    self.model, **{flag: True}))

    @property
    def input_dim(self) -> int:
        return self.data.feature.input_dim


_NESTED: dict[tuple[str, str], type] = {
    ("DataConfig", "batch"): BatchConfig,
    ("DataConfig", "feature"): FeatureConfig,
    ("ExperimentConfig", "data"): DataConfig,
    ("ExperimentConfig", "model"): GGNNConfig,
    ("ExperimentConfig", "optim"): OptimConfig,
    ("ExperimentConfig", "checkpoint"): CheckpointConfig,
    ("ExperimentConfig", "resilience"): ResilienceConfig,
}

# Fields of the JAX package's config that name parts not ported yet.
_NOT_PORTED: dict[tuple[str, str], str] = {
    ("ExperimentConfig", "mesh"): "ROADMAP A11 (data parallelism)",
    ("ExperimentConfig", "serve"): "ROADMAP A6 (the serving shell) and A4 "
                                   "(training telemetry)",
    ("ExperimentConfig", "profile"): "ROADMAP A13 (profiling)",
    ("ExperimentConfig", "time"): "ROADMAP A13 (profiling)",
    ("ExperimentConfig", "trace"): "ROADMAP A13 (profiling)",
    ("ResilienceConfig", "sentinel_patience"): "ROADMAP A4 (divergence "
                                               "rollback)",
    ("ResilienceConfig", "sentinel_lag"): "ROADMAP A4 (divergence rollback)",
    ("ResilienceConfig", "lr_backoff"): "ROADMAP A4 (divergence rollback)",
    ("ResilienceConfig", "max_rollbacks"): "ROADMAP A4 (divergence rollback)",
    ("ResilienceConfig", "emergency_ckpt"): "ROADMAP A4 (preemption and "
                                            "emergency checkpoints)",
    ("ResilienceConfig", "preempt_deadline_s"): "ROADMAP A4 (preemption and "
                                                "emergency checkpoints)",
    ("ResilienceConfig", "step_deadline_s"): "ROADMAP A4 (watchdog)",
}


def _from_dict(cls: type, data: dict[str, Any]) -> Any:
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for key, value in data.items():
        later = _NOT_PORTED.get((cls.__name__, key))
        if later is not None:
            raise NotImplementedError(
                f"{cls.__name__}.{key} is not ported yet: {later}")
        if key not in fields:
            raise KeyError(f"{cls.__name__} has no field {key!r}")
        target = _NESTED.get((cls.__name__, key))
        if target is not None and isinstance(value, dict):
            value = _from_dict(target, value)
        elif key == "subkeys" and isinstance(value, list):
            value = tuple(value)
        kwargs[key] = value
    return cls(**kwargs)


def _deep_merge(base: dict, new: dict) -> dict:
    out = dict(base)
    for k, v in new.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_config(*paths: str | Path,
                overrides: dict[str, Any] | None = None) -> ExperimentConfig:
    """Load layered JSON/YAML configs (later files win) with dotted
    overrides, as the JAX package's ``load_config`` does."""
    merged: dict[str, Any] = {}
    for p in paths:
        text = Path(p).read_text()
        if str(p).endswith((".yaml", ".yml")):
            import yaml

            data = yaml.safe_load(text)
        else:
            data = json.loads(text)
        merged = _deep_merge(merged, data or {})
    for dotted, value in (overrides or {}).items():
        cursor = merged
        *parents, leaf = dotted.split(".")
        for part in parents:
            cursor = cursor.setdefault(part, {})
        cursor[leaf] = value
    return _from_dict(ExperimentConfig, merged)
