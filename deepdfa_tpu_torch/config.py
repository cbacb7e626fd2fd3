"""Typed configuration for the PyTorch port.

A trimmed copy of the JAX package's ``deepdfa_tpu/config.py``: the fields
the fused-layout scoring path, the trainer (``train.fit``) and the HTTP
service (``serve.server``) read. Field names, defaults and derived
properties are unchanged, so a config written for the JAX package builds
the same model, run and server here. A config that asks for a part of the
JAX package this port does not have yet (a mesh, telemetry, preemption,
divergence rollback, admission control, the warm store, ...) raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

__all__ = ["AGGREGATIONS", "ALL_SUBKEYS", "BatchConfig", "CascadeConfig",
           "CheckpointConfig", "DataConfig", "DFA_FAMILIES",
           "DFA_FEATURE_DIMS", "DFA_LIVE_OUT_CLIP", "ExperimentConfig",
           "FeatureConfig", "FrontendConfig", "GGNNConfig", "IDFA_FAMILIES",
           "IDFA_REACH_CLIP", "LABEL_STYLES", "LAYOUTS", "ObsConfig",
           "OptimConfig", "ResilienceConfig", "SINGLE_SUBKEYS", "ServeConfig",
           "active_dfa_families", "load_config", "to_json"]

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
DFA_FAMILIES = ("live_out", "uninit", "taint")
IDFA_FAMILIES = ("ireach", "itaint")
DFA_LIVE_OUT_CLIP = 16
IDFA_REACH_CLIP = 8
DFA_FEATURE_DIMS = {
    "live_out": DFA_LIVE_OUT_CLIP + 1, "uninit": 2, "taint": 3,
    "ireach": IDFA_REACH_CLIP + 1, "itaint": 4,
}


def active_dfa_families(dataflow: bool, interproc: bool) -> tuple[str, ...]:
    """The families a (data, model) flag pair turns on, in embedding order:
    the one place the model and the bridge read, so their layouts agree."""
    fams: tuple[str, ...] = ()
    if dataflow:
        fams += DFA_FAMILIES
    if interproc:
        fams += IDFA_FAMILIES
    return fams


# Label styles and message aggregations the model takes.
LABEL_STYLES = ("graph", "node", "dataflow_solution_in",
                "dataflow_solution_out")
AGGREGATIONS = ("sum", "union_simple", "union_relu")

# Layouts this package runs, and the roadmap item that ports each other one.
LAYOUTS = ("segment", "fused", "megabatch")
_LATER_LAYOUTS = {
    "dense": "ROADMAP queue A, item A10 (dense layout)",
}


@dataclass(frozen=True)
class FeatureConfig:
    """Abstract-dataflow feature vocabulary settings.

    ``input_dim = limit_all + 2`` accounts for the not-a-definition token (0)
    and the UNKNOWN token. The family flags carry over to the model
    (``ExperimentConfig``), which widens its input by one table each.
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

    ``label_style``: ``graph`` (one logit per graph, attention pooling),
    ``node``, ``dataflow_solution_in`` or ``dataflow_solution_out`` (one
    logit per node, no pooling). ``aggregation``: ``sum`` (DGL parity),
    ``union_simple`` or ``union_relu`` (the DFA-lattice unions of
    :mod:`deepdfa_tpu_torch.ops.union`, segment layout only). The family
    flags widen the input with one ``hidden_dim`` table per family.
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
        subkey embeddings are concatenated, plus one ``hidden_dim`` slice
        per static-analysis family."""
        mult = len(ALL_SUBKEYS) if self.concat_all_absdf else 1
        mult += len(active_dfa_families(self.dataflow_families,
                                        self.interproc_families))
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
    # node-label training only: keep every vulnerable node and each other
    # node with probability factor × n_vul / n_nonvul in the loss
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
    """Fault-tolerance knobs (``deepdfa_tpu_torch/resilience``): the
    divergence sentinel (with ``sentinel`` on, a step whose loss or any
    gradient is non-finite keeps the previous parameters, optimizer state
    and metrics; after ``sentinel_patience`` consecutive skips ``fit`` rolls
    back to the last good checkpoint at ``lr * lr_backoff``, at most
    ``max_rollbacks`` times), the preemption handler and its emergency
    checkpoint, and the step watchdog."""

    sentinel: bool = True
    sentinel_patience: int = 3  # consecutive non-finite steps → rollback
    sentinel_lag: int = 2  # the host checks the loss N steps behind
    lr_backoff: float = 0.5  # LR scale applied per rollback
    max_rollbacks: int = 3  # rollbacks before the run gives up
    emergency_ckpt: bool = True  # SIGTERM/SIGUSR1 → step-boundary emergency save
    preempt_deadline_s: float = 30.0  # emergency-commit latency budget
    step_deadline_s: float = 0.0  # per-step watchdog deadline; 0 = off

    def __post_init__(self):
        if self.sentinel_patience < 1:
            raise ValueError("sentinel_patience must be >= 1")
        if self.sentinel_lag < 0:
            raise ValueError("sentinel_lag must be >= 0")
        if not 0.0 < self.lr_backoff <= 1.0:
            raise ValueError("lr_backoff must be in (0, 1]")
        if self.max_rollbacks < 0:
            raise ValueError("max_rollbacks must be >= 0")
        if self.preempt_deadline_s <= 0:
            raise ValueError("preempt_deadline_s must be > 0")
        if self.step_deadline_s < 0:
            raise ValueError("step_deadline_s must be >= 0 (0 disables)")


@dataclass(frozen=True)
class ObsConfig:
    """Observability knobs (``deepdfa_tpu_torch/obs``; CLI: ``--set
    serve.obs.*``): request tracing, slow-trace exemplars, the score-drift
    sentinel, the flight recorder, the SLO burn-rate engine and the
    trainer's telemetry endpoint (``train_port``)."""

    trace: bool = True  # record spans on the serve and train paths
    trace_buffer: int = 4096  # bounded in-memory span buffer per process
    # root spans slower than this journal their whole trace as an
    # event=trace exemplar (None/<=0 disables)
    slow_trace_ms: float = 1000.0
    trace_dir: str | None = None  # exemplar directory; None = no journaling
    max_exemplars: int = 16  # exemplar files kept per process
    # score-drift sentinel: per-model_rev PSI of the sliding score window
    # against the rev's frozen first window
    drift_window: int = 512
    drift_bins: int = 10
    drift_threshold: float = 0.2
    drift_min_samples: int = 64
    drift_max_revs: int = 64
    train_port: int = -1  # trainer /metrics, /healthz, /slo; -1 disables
    # flight recorder: bounded ring of the last N events, dumped atomically
    # as flight-<ts>.json on a crash or SIGUSR2
    flight_events: int = 256
    flight_dir: str | None = None  # None = the system temp directory
    # SLO burn-rate engine (/slo): multi-window alerting over the metrics
    slo_availability: float = 0.99  # non-5xx floor
    slo_error_rate: float = 0.95  # non-error (2xx) floor
    slo_p99_ms: float = 2000.0  # p99 latency ceiling
    slo_step_ms: float = 0.0  # train mean-step ceiling; 0 disables
    slo_mfu_floor: float = 0.0  # train MFU floor; 0 disables
    slo_fast_window_s: float = 300.0
    slo_slow_window_s: float = 3600.0
    slo_burn_threshold: float = 2.0
    alerts_path: str | None = None  # alerts.json veto artifact; None = off

    def __post_init__(self):
        if self.trace_buffer < 1:
            raise ValueError("trace_buffer must be >= 1")
        if self.max_exemplars < 0:
            raise ValueError("max_exemplars must be >= 0")
        if self.drift_window < 2:
            raise ValueError("drift_window must be >= 2")
        if self.drift_bins < 2:
            raise ValueError("drift_bins must be >= 2")
        if self.drift_threshold <= 0:
            raise ValueError("drift_threshold must be > 0")
        if self.drift_min_samples < 1:
            raise ValueError("drift_min_samples must be >= 1")
        if self.drift_max_revs < 1:
            raise ValueError("drift_max_revs must be >= 1")
        if self.train_port < -1:
            raise ValueError("train_port must be >= -1 (-1 disables)")
        if self.flight_events < 1:
            raise ValueError("flight_events must be >= 1")
        if not 0.0 < self.slo_availability < 1.0:
            raise ValueError("slo_availability must be in (0, 1)")
        if not 0.0 < self.slo_error_rate < 1.0:
            raise ValueError("slo_error_rate must be in (0, 1)")
        if self.slo_p99_ms <= 0:
            raise ValueError("slo_p99_ms must be > 0")
        if self.slo_step_ms < 0:
            raise ValueError("slo_step_ms must be >= 0 (0 disables)")
        if self.slo_mfu_floor < 0:
            raise ValueError("slo_mfu_floor must be >= 0 (0 disables)")
        if not 0 < self.slo_fast_window_s <= self.slo_slow_window_s:
            raise ValueError(
                "need 0 < slo_fast_window_s <= slo_slow_window_s")
        if self.slo_burn_threshold <= 0:
            raise ValueError("slo_burn_threshold must be > 0")


@dataclass(frozen=True)
class CascadeConfig:
    """Two-tier scoring cascade knobs (``serve/cascade.py``; CLI: ``--set
    serve.cascade.*``): tier 1 (the GGNN engine) answers every request;
    scores inside ``[band_lo, band_hi]`` escalate to a second bounded
    micro-batch queue feeding the joint LLM+GNN ``JointEngine``. Tier-2
    failure (queue full, deadline blown, engine error) degrades to the
    tier-1 answer with ``tier2_degraded: true``, never a failed request."""

    enabled: bool = False
    band_lo: float = 0.35
    band_hi: float = 0.65
    tier2_max_batch: int = 4
    tier2_max_wait_ms: float = 10.0
    tier2_max_queue: int = 64
    tier2_deadline_ms: float = 2000.0
    # a JointTrainer run dir holding epoch_N fusion checkpoints; restored
    # over the hermetic tiny LLM when the server gets no tier2_engine=
    joint_dir: str | None = None

    def __post_init__(self):
        if not 0.0 <= self.band_lo < self.band_hi <= 1.0:
            raise ValueError("need 0 <= band_lo < band_hi <= 1")
        if self.tier2_max_batch < 1:
            raise ValueError("tier2_max_batch must be >= 1")
        if self.tier2_max_wait_ms < 0:
            raise ValueError("tier2_max_wait_ms must be >= 0")
        if self.tier2_max_queue < 1:
            raise ValueError("tier2_max_queue must be >= 1")
        if self.tier2_deadline_ms <= 0:
            raise ValueError("tier2_deadline_ms must be > 0")


@dataclass(frozen=True)
class FrontendConfig:
    """Frontend encode pool knobs (``serve/frontend.py``; CLI: ``--set
    serve.frontend.*``): cold-request ``encode_source`` runs on a pool of
    encode workers instead of on the request-handler thread.
    ``mode="process"`` spawns vocab-warm child processes (the spawn
    handshake carries the vocabulary content hash; a mismatch fails fast),
    ``"thread"`` keeps the sessions in-process, ``"inline"`` disables the
    pool. Pool trouble always degrades to inline encode, never a 5xx."""

    mode: str = "inline"  # process | thread | inline
    workers: int = 2
    max_queue: int = 256
    spawn_timeout_s: float = 120.0
    encode_timeout_s: float = 120.0

    def __post_init__(self):
        if self.mode not in ("process", "thread", "inline"):
            raise ValueError("mode must be 'process', 'thread' or 'inline'")
        if self.workers < 1:
            raise ValueError("workers must be >= 1")
        if self.max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if self.spawn_timeout_s <= 0:
            raise ValueError("spawn_timeout_s must be > 0")
        if self.encode_timeout_s <= 0:
            raise ValueError("encode_timeout_s must be > 0")


@dataclass(frozen=True)
class AutoscaleConfig:
    """The fleet autoscaler's knobs, with the JAX package's names and
    defaults. Not ported yet: any other value raises (ROADMAP A15)."""

    enabled: bool = False
    min_replicas: int = 1
    max_replicas: int = 4
    poll_interval_s: float = 2.0
    burn_high: float = 2.0
    burn_low: float = 0.5
    up_consecutive: int = 2
    down_consecutive: int = 5
    cooldown_s: float = 30.0
    replace_deadline_s: float = 30.0
    spawn_attempts: int = 3
    spawn_backoff_s: float = 0.5

    def __post_init__(self):
        _refuse_non_default(self, "ROADMAP A15 (the fleet autoscaler)")


@dataclass(frozen=True)
class AdmissionConfig:
    """Admission control, QoS classes and brownout, with the JAX package's
    names and defaults. Not ported yet: any other value raises (ROADMAP
    A15)."""

    enabled: bool = False
    interactive_rate: float = 200.0
    interactive_burst: float = 200.0
    batch_rate: float = 50.0
    batch_burst: float = 50.0
    interactive_deadline_ms: float = 2000.0
    batch_deadline_ms: float = 10000.0
    depth_shed_factor: float = 4.0
    brownout: bool = True
    burn_high: float = 2.0
    burn_low: float = 0.5
    up_consecutive: int = 2
    down_consecutive: int = 5
    cooldown_s: float = 5.0
    poll_interval_s: float = 0.5
    max_level: int = 3

    def __post_init__(self):
        _refuse_non_default(self, "ROADMAP A15 (admission control)")


@dataclass(frozen=True)
class ContinualConfig:
    """The continuous-learning loop (request capture, shadow replay,
    promotion), with the JAX package's names and defaults. Not ported yet:
    any other value raises (ROADMAP A15)."""

    enabled: bool = False
    capture_path: str | None = None
    capture_sample_every: int = 1
    capture_max_records: int = 10000
    shadow_bins: int = 10
    shadow_max_psi: float = 0.25
    veto_max_age_s: float = 3600.0
    drift_settle_polls: int = 3
    poll_interval_s: float = 0.5
    join_timeout_s: float = 120.0

    def __post_init__(self):
        _refuse_non_default(self, "ROADMAP A15 (the continuous-learning "
                                  "loop)")


@dataclass(frozen=True)
class FederationConfig:
    """Multi-cell federation, with the JAX package's names and defaults.
    Not ported yet: any other value raises (ROADMAP A15)."""

    enabled: bool = False
    cells: tuple[str, ...] = ()
    vnodes: int = 16
    probe_interval_s: float = 1.0
    spill_brownout_level: int = 1
    spill_queue_wait_p99_ms: float = 5000.0
    spill_burn_high: float = 2.0
    drain_deadline_s: float = 30.0
    retry_after_floor_s: int = 1

    def __post_init__(self):
        object.__setattr__(self, "cells", tuple(self.cells))
        _refuse_non_default(self, "ROADMAP A15 (federation)")


@dataclass(frozen=True)
class ServeConfig:
    """Online scoring service knobs (``deepdfa_tpu_torch/serve``; CLI:
    ``--set serve.*``): the micro-batching window, the bounded queue, the
    content-addressed scan cache, the HTTP endpoint, the cascade, the
    frontend pool and the warm store (``warm_store_dir``). The JAX
    package's fleet parts keep their defaults here and raise when set:
    ``mesh_replicas > 1`` (ROADMAP A11), ``admission``, ``continual``,
    ``federation`` and ``autoscale`` (A15)."""

    host: str = "127.0.0.1"
    port: int = 8341  # 0 = ephemeral (the bound port is reported at start)
    max_batch: int = 16  # real graphs per dispatched micro-batch
    max_wait_ms: float = 5.0  # batching window after the first request
    max_queue: int = 128  # bounded request queue: beyond it, 503
    cache_entries: int = 4096  # scan-cache capacity (content-addressed LRU)
    drain_timeout_s: float = 10.0  # graceful-shutdown budget
    latency_window: int = 2048  # ring buffer behind the p50/p99 gauges
    # "f32" or "int8" (int8 conv products on kernel B5, gated against the
    # float32 scores at engine build; see ScoringEngine.from_model)
    precision: str = "f32"
    int8_max_score_delta: float = 0.01
    # every dispatch goes through ScoringEngine.submit: upload and launch
    # under the engine lock, the scores read back by PendingScore.result
    latency_mode: bool = False
    replica_id: str | None = None  # default: host:port at serve time
    # the fleet's store of exported bucket programs (serve/warmstore.py):
    # warmup loads each bucket from it, or exports it there
    warm_store_dir: str | None = None
    probe_interval_s: float = 2.0
    mesh_replicas: int = 0  # > 1: ROADMAP A11
    obs: ObsConfig = field(default_factory=ObsConfig)
    autoscale: AutoscaleConfig = field(default_factory=AutoscaleConfig)
    cascade: CascadeConfig = field(default_factory=CascadeConfig)
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    admission: AdmissionConfig = field(default_factory=AdmissionConfig)
    continual: ContinualConfig = field(default_factory=ContinualConfig)
    federation: FederationConfig = field(default_factory=FederationConfig)

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.max_wait_ms < 0:
            raise ValueError("max_wait_ms must be >= 0")
        if self.max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if self.cache_entries < 0:
            raise ValueError("cache_entries must be >= 0")
        if self.latency_window < 1:
            raise ValueError("latency_window must be >= 1")
        if self.precision not in ("f32", "int8"):
            raise ValueError("precision must be 'f32' or 'int8'")
        if self.int8_max_score_delta <= 0:
            raise ValueError("int8_max_score_delta must be > 0")
        if self.probe_interval_s <= 0:
            raise ValueError("probe_interval_s must be > 0")
        if self.mesh_replicas < 0:
            raise ValueError("mesh_replicas must be >= 0")
        if self.mesh_replicas > 1:
            raise NotImplementedError(
                "ServeConfig.mesh_replicas > 1 is not ported yet: ROADMAP "
                "A11 (mesh replication)")


def _default(cls: type, name: str) -> Any:
    f = cls.__dataclass_fields__[name]
    return f.default_factory() if f.default is dataclasses.MISSING \
        else f.default


def _refuse_non_default(cfg: Any, later: str) -> None:
    """Raise ``NotImplementedError`` naming ``later`` unless every field of
    ``cfg`` keeps its default: the block parses, and is not ported yet."""
    for f in dataclasses.fields(cfg):
        if getattr(cfg, f.name) != _default(type(cfg), f.name):
            raise NotImplementedError(
                f"{type(cfg).__name__}.{f.name} is not ported yet: {later}")


@dataclass(frozen=True)
class ExperimentConfig:
    data: DataConfig = field(default_factory=DataConfig)
    model: GGNNConfig = field(default_factory=GGNNConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    seed: int = 0
    run_name: str | None = None

    def __post_init__(self):
        # data→model link for the static-analysis families, as in the JAX
        # package: when the data emits them, the model widens
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
    ("ExperimentConfig", "serve"): ServeConfig,
    ("ServeConfig", "obs"): ObsConfig,
    ("ServeConfig", "autoscale"): AutoscaleConfig,
    ("ServeConfig", "cascade"): CascadeConfig,
    ("ServeConfig", "frontend"): FrontendConfig,
    ("ServeConfig", "admission"): AdmissionConfig,
    ("ServeConfig", "continual"): ContinualConfig,
    ("ServeConfig", "federation"): FederationConfig,
}

# Fields of the JAX package's config that name parts not ported yet.
_NOT_PORTED: dict[tuple[str, str], str] = {
    ("ExperimentConfig", "mesh"): "ROADMAP A11 (data parallelism)",
    ("ExperimentConfig", "profile"): "ROADMAP A13 (profiling)",
    ("ExperimentConfig", "time"): "ROADMAP A13 (profiling)",
    ("ExperimentConfig", "trace"): "ROADMAP A13 (profiling)",
}


def _to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        return {f.name: _to_dict(getattr(cfg, f.name))
                for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [_to_dict(v) for v in cfg]
    return cfg


def to_json(cfg: Any) -> str:
    """A config as the JAX package writes it (``config.json`` of a run)."""
    return json.dumps(_to_dict(cfg), indent=2, sort_keys=True)


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
