"""ScoringEngine — per-bucket scoring over a fixed ladder of padded shapes.

The port of ``deepdfa_tpu/serve/engine.py`` for live models. The engine owns
a small ladder of :class:`~deepdfa_tpu_torch.data.graphs.BucketSpec`
budgets (size classes per *graph*, batch budgets per *bucket*); requests
route to the smallest size class that fits their graph
(:meth:`ScoringEngine.assign_bucket`), the batcher packs per class, and
:meth:`ScoringEngine.score` pads and dispatches one forward.
:meth:`ScoringEngine.score_packed` scores a mixed-size window through one
wider megabatch shape. :meth:`ScoringEngine.warmup` runs every bucket once,
which also builds the CUDA kernel of the fused layout; with a
:class:`~deepdfa_tpu_torch.serve.warmstore.WarmStore` it loads each
bucket's exported program from the store, or exports it there for the next
replica (:meth:`ScoringEngine.bucket_key` is the content address).

``from_model(..., precision="int8")`` serves the conv products on int8
weights (kernel B5) once a calibration gate has compared its scores with the
float32 model's; :meth:`ScoringEngine.score_unit` scores a multi-function
unit through the hierarchical scorer (kernel B4).
:meth:`ScoringEngine.from_checkpoint` restores a ``train.fit`` run's best
(else latest) checkpoint into the fused layout, so a trained model serves
on kernel B1. :meth:`ScoringEngine.from_artifact` serves a ``torch.export``
artifact (:mod:`deepdfa_tpu_torch.serving`) at its one shape, without the
model code; a node-label artifact's per-node probabilities are reduced to
function scores on the host. With ``latency_mode`` every dispatch goes through
:meth:`ScoringEngine.submit`: pad, upload and launch under the engine lock
with no host sync, the scores read back by :meth:`PendingScore.result`.

`score` and `submit` are where the ``serve.engine_raises`` fault point
lives: an injected (or real) engine failure surfaces as a per-request error
in the batcher, never as a dead server. Mesh replication is not ported
yet (ROADMAP A11).
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
import warnings

import numpy as np
import torch

from deepdfa_tpu_torch import resolve_device
from deepdfa_tpu_torch.data.graphs import (BucketSpec, Graph, _round_up,
                                           batch_np, to_device)
from deepdfa_tpu_torch.resilience import faults

__all__ = ["OversizeGraphError", "ServeBucket", "serve_buckets",
           "mega_bucket", "ScoringEngine", "PendingScore", "model_revision"]


class OversizeGraphError(ValueError):
    """The function's graph exceeds every serving bucket — a per-request
    413, not a reason to grow the shape ladder at runtime."""


@dataclasses.dataclass(frozen=True)
class ServeBucket:
    """A size class: graphs with ``n_nodes <= graph_nodes`` (and edges
    within the per-graph share) route here; ``spec`` is the padded batch
    budget the bucket dispatches at."""

    spec: BucketSpec
    graph_nodes: int

    @property
    def capacity(self) -> int:
        """Real-graph slots (one BucketSpec slot is the padding sink)."""
        return self.spec.max_graphs - 1

    def admits(self, g: Graph) -> bool:
        return (g.n_nodes <= self.graph_nodes
                and g.n_edges <= 4 * self.graph_nodes
                and self.spec.fits(1, g.n_nodes, g.n_edges))


def serve_buckets(max_batch: int) -> tuple[ServeBucket, ...]:
    """The default ladder: small CFGs (DeepDFA's regime, ~50 nodes) batch
    ``max_batch``-wide; mid-size functions batch narrower; huge ones go
    one per batch. Three shapes in all."""
    ladder = ((126, max_batch), (1022, max(1, max_batch // 4)), (4094, 1))
    out = []
    for per_graph, gcap in ladder:
        nn = _round_up(gcap * per_graph + 2)
        out.append(ServeBucket(
            spec=BucketSpec(gcap + 1, nn, 4 * nn), graph_nodes=per_graph))
    return tuple(out)


def mega_bucket(max_batch: int, graph_nodes: int = 1022) -> ServeBucket:
    """The cross-bucket megabatch budget: one shape wide enough for a whole
    mixed-size request window (``2 * max_batch`` DeepDFA-regime graphs plus
    one ``graph_nodes``-sized straggler). Graphs over the budget route
    through the ladder."""
    gcap = 2 * max(1, int(max_batch))
    nn_ = _round_up(gcap * 126 + graph_nodes + 2)
    return ServeBucket(spec=BucketSpec(gcap + 1, nn_, 4 * nn_),
                       graph_nodes=graph_nodes)


def _calibration_graphs(feat_keys, buckets, n_per_bucket: int = 4,
                        seed: int = 0) -> list[Graph]:
    """The int8 gate's inputs when the caller gives none: a few random
    graphs per bucket size class (feature ids in {0, 1}, valid rows of
    every embedding table), from the JAX package's seeded numpy draws, so
    both packages gate on the same graphs."""
    rng = np.random.default_rng(seed)
    out = []
    for b in buckets:
        cap = min(b.graph_nodes, 48)
        for _ in range(n_per_bucket):
            n = int(rng.integers(max(2, cap // 2), cap + 1))
            feats = {k: rng.integers(0, 2, size=n).astype(np.int32)
                     for k in feat_keys}
            out.append(Graph(
                senders=rng.integers(0, n, size=2 * n).astype(np.int32),
                receivers=rng.integers(0, n, size=2 * n).astype(np.int32),
                node_feats=feats).with_self_loops())
    return out


def _dummy_graph(feat_keys) -> Graph:
    n = 2
    feats = {k: np.zeros(n, np.int32) for k in feat_keys}
    return Graph(senders=np.arange(n - 1, dtype=np.int32),
                 receivers=np.arange(1, n, dtype=np.int32),
                 node_feats=feats).with_self_loops()


def model_revision(state_dict, device) -> str:
    """Model revision: a content address of the state dict (names, dtypes,
    shapes, bytes), with the framework and the device kind folded in, so a
    torch engine never shares a key with a JAX one or with another card."""
    dev = torch.device(device)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type)
    h = hashlib.sha256(f"torch|{kind}".encode())
    for name in sorted(state_dict):
        t = state_dict[name].detach().cpu().contiguous()
        h.update(f"{name}|{t.dtype}|{tuple(t.shape)}".encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()[:16]


class PendingScore:
    """Handle returned by :meth:`ScoringEngine.submit`: the launched
    forward's probabilities stay on the device, with the batch tensors
    uploaded for it kept alive beside them; :meth:`result` is the one
    blocking read."""

    __slots__ = ("_dev", "_inputs", "_n")

    def __init__(self, dev, inputs, n: int):
        self._dev = dev
        self._inputs = inputs
        self._n = n

    def result(self) -> np.ndarray:
        probs = np.asarray(self._dev.to("cpu"), np.float32)
        self._inputs = None
        return probs[: self._n]


class ScoringEngine:
    """``score(graphs, bucket) -> fn_prob[len(graphs)]`` over a fixed
    bucket ladder. ``score_fn`` maps a padded numpy ``BatchedGraphs`` to
    per-graph probabilities ``[max_graphs]``.

    ``device_fn`` (the live-model constructors set it) maps a padded numpy
    batch to ``(probs on the device, the uploaded batch tensors)`` without
    a host sync; it backs :meth:`submit` and ``latency_mode``. The port's
    engines have one replica (``n_replicas`` is 1: mesh replication is
    ROADMAP A11). Every dispatch holds the engine lock, so concurrent
    ``submit`` callers never share or interleave their uploaded batches.
    ``flight`` is the server's flight recorder, given every dispatch.

    ``export_fn`` (live single-replica engines) maps a bucket to ``(the
    saved exported program, seconds)`` for the warm store; ``device`` is
    where a program loaded from the store runs."""

    def __init__(self, score_fn, buckets, label_style: str = "graph",
                 feat_keys=(), vocab_hash: str | None = None,
                 model_rev: str | None = None,
                 mega: ServeBucket | None = None, precision: str = "f32",
                 int8_score_delta: float | None = None, hier_factory=None,
                 device_fn=None, latency_mode: bool = False,
                 export_fn=None, device=None):
        if not buckets:
            raise ValueError("need at least one serving bucket")
        if latency_mode and device_fn is None:
            warnings.warn(
                "latency_mode requires a device_fn (live-model engines "
                "only); serving in synchronous mode", stacklevel=2)
            latency_mode = False
        self._score_fn = score_fn
        self._device_fn = device_fn
        self._export_fn = export_fn
        self.device = device
        self.latency_mode = latency_mode
        self.n_replicas = 1
        self.buckets = tuple(sorted(
            buckets, key=lambda b: (b.graph_nodes, b.spec.max_graphs)))
        self.label_style = label_style
        self.feat_keys = tuple(feat_keys)
        self.vocab_hash = vocab_hash
        self.model_rev = model_rev
        self.mega_bucket = mega
        self.precision = precision
        # the int8 gate's max probability difference, when it ran
        self.int8_score_delta = int8_score_delta
        self._hier_factory = hier_factory
        self._hier = None
        # nodes/edges/graphs fractions of the last score_packed call
        self.last_padding_efficiency: dict[str, float] | None = None
        self.n_dispatches = 0
        self.warm_buckets: list[int] = []
        self.last_warmup_report: dict | None = None
        # buckets served by a program loaded from the warm store
        self._bucket_fns: dict[ServeBucket, object] = {}
        self._lock = threading.RLock()
        # set by the server: every dispatch records its bucket and its
        # real-graph count into the crash flight recorder
        self.flight = None

    def _record_dispatch(self, kind: str, bucket, n_graphs: int) -> None:
        if self.flight is not None:  # record() never raises
            self.flight.record(kind, bucket=bucket.graph_nodes,
                               n_graphs=n_graphs,
                               dispatch=self.n_dispatches)

    # -- routing ------------------------------------------------------------

    def assign_bucket(self, g: Graph) -> ServeBucket:
        for b in self.buckets:
            if b.admits(g):
                return b
        raise OversizeGraphError(
            f"graph with {g.n_nodes} nodes / {g.n_edges} edges exceeds the "
            f"largest serving bucket "
            f"(graph_nodes={self.buckets[-1].graph_nodes})")

    # -- scoring ------------------------------------------------------------

    def _padded_batch(self, graphs, bucket: ServeBucket):
        return batch_np(graphs, bucket.spec.max_graphs,
                        bucket.spec.max_nodes, bucket.spec.max_edges)

    def score(self, graphs, bucket: ServeBucket) -> np.ndarray:
        """Pad ``graphs`` (all pre-routed to ``bucket``) and dispatch one
        forward; returns the real graphs' probabilities. In latency mode
        this is :meth:`submit` and its blocking read."""
        if self.latency_mode:
            return self.submit(graphs, bucket).result()
        faults.raise_if("serve.engine_raises")
        graphs = list(graphs)
        with self._lock:
            batch = self._padded_batch(graphs, bucket)
            fn = self._bucket_fns.get(bucket, self._score_fn)
            probs = np.asarray(fn(batch), np.float32)
            self.n_dispatches += 1
        self._record_dispatch("engine.dispatch", bucket, len(graphs))
        return probs[: len(graphs)]

    def submit(self, graphs, bucket: ServeBucket) -> PendingScore:
        """Latency-mode dispatch: pad, upload, launch — no host sync. The
        sequence runs under the engine lock, so each caller's
        :class:`PendingScore` holds exactly the tensors its own dispatch
        uploaded and produced."""
        if self._device_fn is None:
            raise RuntimeError(
                "submit() needs a live-model engine (device_fn)")
        faults.raise_if("serve.engine_raises")
        graphs = list(graphs)
        with self._lock:
            batch = self._padded_batch(graphs, bucket)
            dev, inputs = self._device_fn(batch)
            self.n_dispatches += 1
        self._record_dispatch("engine.submit", bucket, len(graphs))
        return PendingScore(dev, inputs, len(graphs))

    def score_packed(self, graphs) -> np.ndarray:
        """Score a mixed-size request set through the megabatch bucket:
        first-fit-decreasing pack the set into as few mega-shaped batches
        as the budgets allow and dispatch each. Graphs over the mega budget
        route through the ladder per graph (including
        :class:`OversizeGraphError`). Returns probabilities in input order;
        records the packed batches' padding efficiency in
        ``last_padding_efficiency``."""
        if self.mega_bucket is None:
            raise RuntimeError(
                "score_packed needs a megabatch engine — construct with "
                "from_model(..., megabatch=True) or pass mega=")
        graphs = list(graphs)
        if not graphs:
            return np.zeros(0, np.float32)
        spec = self.mega_bucket.spec
        cap = self.mega_bucket.capacity
        order = sorted(range(len(graphs)),
                       key=lambda i: (-graphs[i].n_nodes,
                                      -graphs[i].n_edges, i))
        bins: list[list[int]] = []
        loads: list[list[int]] = []  # [node-sum, edge-sum] per bin
        overflow: list[int] = []
        for i in order:
            g = graphs[i]
            if g.n_nodes > spec.max_nodes - 1 or g.n_edges > spec.max_edges:
                overflow.append(i)
                continue
            for b, load in zip(bins, loads):
                if (len(b) < cap
                        and load[0] + g.n_nodes <= spec.max_nodes - 1
                        and load[1] + g.n_edges <= spec.max_edges):
                    b.append(i)
                    load[0] += g.n_nodes
                    load[1] += g.n_edges
                    break
            else:
                bins.append([i])
                loads.append([g.n_nodes, g.n_edges])
        out = np.zeros(len(graphs), np.float32)
        for b in bins:
            out[np.asarray(b)] = self.score([graphs[i] for i in b],
                                            self.mega_bucket)
        for i in overflow:
            out[i] = self.score([graphs[i]], self.assign_bucket(graphs[i]))[0]
        if bins:
            real_n = sum(load[0] for load in loads)
            real_e = sum(load[1] for load in loads)
            self.last_padding_efficiency = {
                "nodes": real_n / (len(bins) * spec.max_nodes),
                "edges": real_e / (len(bins) * spec.max_edges),
                "graphs": sum(len(b) for b in bins)
                / (len(bins) * spec.max_graphs),
            }
        return out

    # -- hierarchical whole-unit scoring ------------------------------------

    @property
    def hier(self):
        """The lazy :class:`~deepdfa_tpu_torch.models.ggnn_hier.HierScorer`
        of a live megabatch-compatible engine. Attach an embedding cache
        with ``engine.hier.cache = FunctionEmbeddingCache(...)``."""
        with self._lock:
            if self._hier is None:
                if self._hier_factory is None:
                    raise RuntimeError(
                        "score_unit needs a live megabatch-compatible "
                        "engine (graph labels, concat-subkey embeddings) — "
                        "engines without a model and excluded model "
                        "variants have no hierarchical path")
                self._hier = self._hier_factory()
            return self._hier

    def score_unit(self, functions, unit) -> dict:
        """Score a multi-function unit as one request through the
        hierarchical path: per-function level-1 embeddings on B4
        (cache-fronted), composed over the call graph ``unit`` (the unit's
        :class:`~deepdfa_tpu_torch.cpg.interproc.Supergraph`, or a
        :class:`~deepdfa_tpu_torch.models.ggnn_hier.UnitCallGraph`) into a
        unit score and a per-function attribution. Never touches the bucket
        ladder; level-1 dispatches count in ``n_dispatches``."""
        faults.raise_if("serve.engine_raises")
        hier = self.hier
        with self._lock:
            before = hier.n_level1_dispatches + hier.n_fallback_dispatches
            out = hier.score_unit(functions, unit)
            self.n_dispatches += (hier.n_level1_dispatches
                                  + hier.n_fallback_dispatches - before)
        return out

    # -- warmup + warm store -----------------------------------------------

    def bucket_key(self, bucket: ServeBucket) -> str:
        """Warm-store content address of one bucket's exported program."""
        from deepdfa_tpu_torch.serve.warmstore import bucket_artifact_key

        return bucket_artifact_key(
            self.vocab_hash, self.model_rev, self.precision,
            self.label_style, self.feat_keys, bucket.spec.max_graphs,
            bucket.spec.max_nodes, bucket.spec.max_edges)

    def _warm_cold(self, bucket: ServeBucket, g: Graph) -> None:
        """The bucket's first call, made directly: warmup dispatches are
        not counted, and an armed ``serve.engine_raises`` is left for the
        first request."""
        with self._lock:
            batch = self._padded_batch([g], bucket)
            np.asarray(self._score_fn(batch), np.float32)

    def _load_bucket_fn(self, payload: bytes):
        """A warm-store payload as this bucket's score function, on the
        engine's device (the live path's feature-key contract)."""
        from deepdfa_tpu_torch.serving import _Servable, load_program

        dev = torch.device(self.device or "cpu")
        program, module = load_program(payload, dev)
        servable = _Servable(program=program, module=module, device=dev,
                             manifest={"node_feat_keys": list(self.feat_keys)})
        return (_function_max(servable) if self.label_style == "node"
                else servable)

    def warmup(self, warm_store=None, journal=None) -> dict:
        """Warm every bucket's callable so the first request pays neither
        the kernel build nor first-call setup; returns a report
        (``buckets``, ``hits``, ``misses``, ``compile_seconds_saved``,
        ``per_bucket``: per bucket its ``key``, ``source`` and seconds).

        With a ``warm_store``, each bucket first tries the store: a hit
        loads the content-addressed exported program and serves the bucket
        from it, and ``compile_seconds_saved`` is the populating replica's
        recorded first-call seconds less this load's (never below 0); a
        miss runs the bucket's first call and, when the engine can export
        (live single-replica, synchronous mode), commits the program for
        the next replica (a failed export warns and is reported, warmup
        goes on). The megabatch shape never exports. Journaled
        (``event="warmup"``) when ``journal`` is given."""
        use_store = (warm_store is not None and self._export_fn is not None
                     and not self.latency_mode)
        g = _dummy_graph(self.feat_keys)
        report: dict = {"buckets": len(self.buckets), "hits": 0, "misses": 0,
                        "compile_seconds_saved": 0.0, "per_bucket": {}}
        for b in self.buckets:
            key = self.bucket_key(b) if use_store else None
            entry = warm_store.get(key) if use_store else None
            row: dict = {"key": key}
            if entry is not None:
                t0 = time.perf_counter()
                fn = self._load_bucket_fn(entry.payload)
                with self._lock:
                    fn(self._padded_batch([g], b))
                warm_s = time.perf_counter() - t0
                self._bucket_fns[b] = fn
                recorded = float(entry.meta.get("compile_seconds", 0.0))
                saved = max(0.0, recorded - warm_s)
                report["hits"] += 1
                report["compile_seconds_saved"] += saved
                row.update(source="store", warm_seconds=warm_s,
                           compile_seconds=recorded,
                           compile_seconds_saved=saved)
            else:
                t0 = time.perf_counter()
                self._warm_cold(b, g)
                compile_s = time.perf_counter() - t0
                report["misses"] += 1
                row.update(source="compile", compile_seconds=compile_s)
                if use_store:
                    try:
                        payload, export_s = self._export_fn(b)
                        warm_store.put(key, payload, {
                            "compile_seconds": compile_s,
                            "vocab_hash": self.vocab_hash,
                            "model_rev": self.model_rev,
                            "precision": self.precision,
                            "label_style": self.label_style,
                            "graph_nodes": b.graph_nodes,
                            "spec": [b.spec.max_graphs, b.spec.max_nodes,
                                     b.spec.max_edges],
                        })
                        row["export_seconds"] = export_s
                    except Exception as exc:  # noqa: BLE001 — the store is
                        # an optimization: the bucket is already warm
                        warnings.warn(
                            f"warm-store export failed for bucket "
                            f"{b.graph_nodes}: {type(exc).__name__}: {exc}",
                            stacklevel=2)
                        row["export_error"] = f"{type(exc).__name__}: {exc}"
            report["per_bucket"][str(b.graph_nodes)] = row
        if self.mega_bucket is not None:
            # the packed shape warms like a ladder bucket, never exports,
            # and reports under "mega" so ladder rows keep their node keys
            t0 = time.perf_counter()
            self._warm_cold(self.mega_bucket, g)
            report["per_bucket"]["mega"] = {
                "key": None, "source": "compile",
                "compile_seconds": time.perf_counter() - t0}
        self.warm_buckets = [b.graph_nodes for b in self.buckets]
        self.last_warmup_report = report
        if journal is not None:
            journal.write(event="warmup", vocab_hash=self.vocab_hash,
                          model_rev=self.model_rev, precision=self.precision,
                          **report)
        return report

    # -- constructor --------------------------------------------------------

    @classmethod
    def from_model(cls, model, state=None, label_style: str = "graph",
                   feat_keys=(), max_batch: int = 16, buckets=None,
                   megabatch: bool = False, device=None,
                   vocab_hash: str | None = None, precision: str = "f32",
                   mesh=None, int8_max_score_delta: float = 0.01,
                   calibration_graphs=None, journal=None,
                   latency_mode: bool = False) -> "ScoringEngine":
        """Live-model engine. ``state`` (a state dict, or None to keep the
        model's own weights) is loaded into ``model``, which moves to
        ``device`` — ``cuda`` unless the caller names another; without a
        GPU and without an explicit ``"cpu"`` this raises.
        ``megabatch=True`` adds the :func:`mega_bucket` shape for
        :meth:`score_packed`. A ``layout="megabatch"`` model raises
        ``ValueError`` here (see :func:`~deepdfa_tpu_torch.predict.
        make_scorer`).

        ``precision="int8"`` quantizes the conv products
        (:func:`~deepdfa_tpu_torch.models.ggnn_int8.quantize_conv_params`)
        and gates the result: the float32 and int8 models score a
        calibration batch per bucket (``calibration_graphs`` or the seeded
        :func:`_calibration_graphs`), and int8 is served only if the largest
        probability difference is within ``int8_max_score_delta``.
        Otherwise — or when calibration refuses a non-finite checkpoint —
        the engine warns, writes an ``int8_gate_refused`` event to
        ``journal`` (a :class:`~deepdfa_tpu_torch.resilience.journal.
        RunJournal`) when one is given, and serves float32. A kernel that
        fails to build or launch raises ``RuntimeError`` out of this call.

        A megabatch-compatible model also gets the hierarchical path
        (:meth:`score_unit`), always over the float32 weights.
        ``latency_mode`` sends every dispatch through :meth:`submit`."""
        from deepdfa_tpu_torch.models.ggnn_hier import (HierScorer,
                                                        megabatch_compatible)
        from deepdfa_tpu_torch.predict import make_scorer

        if precision not in ("f32", "int8"):
            raise ValueError(
                f"precision must be 'f32' or 'int8', got {precision!r}")
        if mesh is not None:
            raise NotImplementedError(
                "mesh replication is not ported yet (ROADMAP A11)")
        dev = resolve_device(device)
        if state is not None:
            model.load_state_dict(state)
        model = model.to(dev).eval()
        keys = tuple(feat_keys)
        buckets = tuple(buckets or serve_buckets(max_batch))
        model_rev = model_revision(model.state_dict(), dev)

        def make_fns(m):
            scorer = make_scorer(m, label_style)

            def device_fn(batch):
                inputs = to_device(batch, dev, keys)
                probs, _ = scorer(inputs)
                return probs, inputs

            def score_fn(batch):
                return device_fn(batch)[0].cpu().numpy()

            return score_fn, device_fn, m

        score_fn, device_fn, chosen = make_fns(model)
        int8_delta = None
        if precision == "int8":
            fns8, int8_delta, reason = _int8_gate(
                model, score_fn, make_fns, keys, buckets, dev,
                calibration_graphs, int8_max_score_delta)
            if fns8 is not None:
                score_fn, device_fn, chosen = fns8
            else:
                warnings.warn(
                    f"int8 serving path refused — {reason}; serving f32",
                    stacklevel=2)
                if journal is not None:
                    journal.write(event="int8_gate_refused", reason=reason,
                                  int8_max_score_delta=int8_max_score_delta,
                                  int8_score_delta=int8_delta)
                precision = "f32"

        # the hierarchical path: always the float32 weights
        hier_factory = None
        cfg = getattr(model, "cfg", None)
        if cfg is not None and megabatch_compatible(cfg):
            f32_state = {k: v.detach().clone()
                         for k, v in model.state_dict().items()}
            hier_factory = (lambda: HierScorer(
                cfg, model.input_dim, f32_state, model_rev=model_rev,
                device=dev))

        return cls(score_fn, buckets, label_style=label_style, feat_keys=keys,
                   vocab_hash=vocab_hash, model_rev=model_rev,
                   mega=mega_bucket(max_batch) if megabatch else None,
                   precision=precision, int8_score_delta=int8_delta,
                   hier_factory=hier_factory, device_fn=device_fn,
                   latency_mode=latency_mode,
                   export_fn=_make_export_fn(chosen, keys),
                   device=dev)

    @classmethod
    def from_checkpoint(cls, cfg, ckpt_dir, vocabs,
                        max_batch: int | None = None, journal=None,
                        device=None) -> "ScoringEngine":
        """Restore a ``train.fit`` run's best (else latest) checkpoint, as
        predict does, and serve it on ``device`` (``cuda`` unless the
        caller names another). The model is always built in the **fused**
        layout — every message round on kernel B1 on the card — whatever
        layout trained it: the segment, fused and megabatch layouts share
        one parameter set (the JAX package serves on its segment layout,
        which in the port runs no kernel). ``cfg.serve`` supplies the batch
        width, ``precision``, the int8 gate and ``latency_mode``;
        ``mesh_replicas > 1`` cannot reach here (the config refuses it)."""
        from deepdfa_tpu_torch.models import make_model
        from deepdfa_tpu_torch.pipeline import vocab_content_hash
        from deepdfa_tpu_torch.train.checkpoint import CheckpointManager

        dev = resolve_device(device)
        ckpts = CheckpointManager(ckpt_dir, cfg.checkpoint)
        if ckpts.latest_step() is None:
            raise FileNotFoundError(
                f"no checkpoint under {ckpt_dir} — the engine serves a "
                "trained model; run fit first")
        state = (ckpts.restore_best(map_location="cpu")
                 if ckpts.best_step() is not None
                 else ckpts.restore_latest(map_location="cpu"))
        mcfg = dataclasses.replace(cfg.model, layout="fused")
        model = make_model(mcfg, cfg.input_dim, device="cpu")
        return cls.from_model(
            model, state, mcfg.label_style, feat_keys=tuple(vocabs),
            max_batch=max_batch or cfg.serve.max_batch, device=dev,
            vocab_hash=vocab_content_hash(vocabs),
            precision=cfg.serve.precision,
            int8_max_score_delta=cfg.serve.int8_max_score_delta,
            journal=journal, latency_mode=cfg.serve.latency_mode)

    @classmethod
    def from_artifact(cls, artifact_dir, vocabs=None,
                      device=None) -> "ScoringEngine":
        """Engine over an exported artifact (:func:`deepdfa_tpu_torch.
        serving.export_ggnn`) on ``device`` (``cuda`` unless the caller
        names another). The program is traced at ONE shape, so the ladder
        is one bucket at the manifest's budgets. With ``vocabs``, their
        content hash is checked against the manifest (``load_exported``
        warns on a mismatch). No megabatch shape, no hierarchical path, no
        ``latency_mode``."""
        from deepdfa_tpu_torch.serving import load_exported

        vocab_hash = None
        if vocabs is not None:
            from deepdfa_tpu_torch.pipeline import vocab_content_hash

            vocab_hash = vocab_content_hash(vocabs)
        dev = resolve_device(device)
        servable = load_exported(artifact_dir, expect_vocab_hash=vocab_hash,
                                 device=dev)
        man = servable.manifest
        leaves = man["input_leaves"]
        # flatten order: node_feats (sorted keys), senders, receivers,
        # node_gidx, node_mask, edge_mask, graph_mask
        max_graphs = int(leaves[-1]["shape"][0])
        max_edges = int(leaves[-2]["shape"][0])
        max_nodes = int(leaves[-3]["shape"][0])
        spec = BucketSpec(max_graphs, max_nodes, max_edges)
        bucket = ServeBucket(spec=spec, graph_nodes=max_nodes - 1)
        label_style = man.get("label_style", "graph")
        score_fn = (_function_max(servable) if label_style == "node"
                    else servable)
        return cls(score_fn, (bucket,), label_style=label_style,
                   feat_keys=tuple(man["node_feat_keys"]),
                   vocab_hash=man.get("vocab_hash"), device=dev)


def _function_max(servable):
    """A node-label program's per-node probabilities reduced to function
    scores on the host: per graph slot, the largest over its real nodes
    (0 for an empty slot), as the JAX package's ``from_artifact`` does."""

    def score_fn(batch):
        node_p = np.asarray(servable(batch), np.float32)
        fn = np.zeros(batch.max_graphs, np.float32)
        mask = np.asarray(batch.node_mask)
        np.maximum.at(fn, np.asarray(batch.node_gidx)[mask], node_p[mask])
        return fn

    return score_fn


def _make_export_fn(model, feat_keys):
    """``bucket -> (saved exported program, export seconds)`` for the warm
    store: :func:`deepdfa_tpu_torch.serving.export_program` of ``model``
    (the engine's chosen model: int8 when the gate accepted it) at one
    bucket's padded shape, on the model's device. The program is
    ``serving.ScoreProgram``: the probabilities :func:`~deepdfa_tpu_torch.
    predict.make_scorer` gives, without the gate weights (per node for a
    node-label model, reduced per function on the host when loaded)."""

    def export_bucket(bucket: ServeBucket):
        from deepdfa_tpu_torch.serving import export_program, save_program

        t0 = time.perf_counter()
        ex = batch_np([_dummy_graph(feat_keys)], bucket.spec.max_graphs,
                      bucket.spec.max_nodes, bucket.spec.max_edges)
        program = export_program(model, ex, feat_keys)
        return save_program(program), time.perf_counter() - t0

    return export_bucket


def _int8_gate(model, score_fn, make_fns, keys, buckets, dev,
               calibration_graphs, max_delta: float):
    """Quantize ``model``'s conv and compare the int8 model's scores with
    ``score_fn``'s on a calibration batch per bucket. Returns ``((score,
    device) functions of the int8 model and the model, or None; max
    probability difference; reason for a refusal)``. Only calibration's ``ValueError`` (a non-finite
    checkpoint) is a refusal; anything the scoring raises propagates."""
    from deepdfa_tpu_torch.models.ggnn_int8 import (GGNNInt8,
                                                    quantize_conv_params)

    try:
        qstate = quantize_conv_params(model.state_dict())
    except ValueError as exc:
        return None, None, f"calibration refused: {exc}"
    model8 = GGNNInt8(model.cfg, model.input_dim)
    model8.load_state_dict(qstate)
    fns8 = make_fns(model8.to(dev).eval())
    score8 = fns8[0]
    cal = list(calibration_graphs or _calibration_graphs(keys, buckets))
    delta = 0.0
    for b in buckets:
        gs = [g for g in cal if b.admits(g)][: b.capacity]
        if not gs:
            continue
        batch = batch_np(gs, b.spec.max_graphs, b.spec.max_nodes,
                         b.spec.max_edges)
        p32 = np.asarray(score_fn(batch), np.float32)[: len(gs)]
        p8 = np.asarray(score8(batch), np.float32)[: len(gs)]
        delta = max(delta, float(np.max(np.abs(p32 - p8))))
    if delta <= max_delta:
        return fns8, delta, None
    return None, delta, (f"max score delta {delta:.2e} exceeds "
                         f"serve.int8_max_score_delta {max_delta:.2e}")
