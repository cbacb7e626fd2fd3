"""ScoringEngine — per-bucket scoring over a fixed ladder of padded shapes.

The port of ``deepdfa_tpu/serve/engine.py`` for live models. The engine owns
a small ladder of :class:`~deepdfa_tpu_torch.data.graphs.BucketSpec`
budgets (size classes per *graph*, batch budgets per *bucket*); requests
route to the smallest size class that fits their graph
(:meth:`ScoringEngine.assign_bucket`), the batcher packs per class, and
:meth:`ScoringEngine.score` pads and dispatches one forward.
:meth:`ScoringEngine.score_packed` scores a mixed-size window through one
wider megabatch shape. :meth:`ScoringEngine.warmup` runs every bucket once,
which also builds the CUDA kernel of the fused layout.

int8 serving, mesh replication, latency-mode ``submit``, the warm store,
artifact export and ``score_unit`` are not ported yet (ROADMAP A6, A8, A9,
A11).
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time

import numpy as np
import torch

from deepdfa_tpu_torch import resolve_device
from deepdfa_tpu_torch.data.graphs import (BucketSpec, Graph, _round_up,
                                           batch_np, to_device)

__all__ = ["OversizeGraphError", "ServeBucket", "serve_buckets",
           "mega_bucket", "ScoringEngine", "model_revision"]


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


class ScoringEngine:
    """``score(graphs, bucket) -> fn_prob[len(graphs)]`` over a fixed
    bucket ladder. ``score_fn`` maps a padded numpy ``BatchedGraphs`` to
    per-graph probabilities ``[max_graphs]``. Every dispatch holds the
    engine lock."""

    def __init__(self, score_fn, buckets, label_style: str = "graph",
                 feat_keys=(), vocab_hash: str | None = None,
                 model_rev: str | None = None,
                 mega: ServeBucket | None = None):
        if not buckets:
            raise ValueError("need at least one serving bucket")
        self._score_fn = score_fn
        self.buckets = tuple(sorted(
            buckets, key=lambda b: (b.graph_nodes, b.spec.max_graphs)))
        self.label_style = label_style
        self.feat_keys = tuple(feat_keys)
        self.vocab_hash = vocab_hash
        self.model_rev = model_rev
        self.mega_bucket = mega
        self.precision = "f32"
        # nodes/edges/graphs fractions of the last score_packed call
        self.last_padding_efficiency: dict[str, float] | None = None
        self.n_dispatches = 0
        self.warm_buckets: list[int] = []
        self.last_warmup_report: dict | None = None
        self._lock = threading.RLock()

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

    def score(self, graphs, bucket: ServeBucket) -> np.ndarray:
        """Pad ``graphs`` (all pre-routed to ``bucket``) and dispatch one
        forward; returns the real graphs' probabilities."""
        graphs = list(graphs)
        with self._lock:
            batch = batch_np(graphs, bucket.spec.max_graphs,
                             bucket.spec.max_nodes, bucket.spec.max_edges)
            probs = np.asarray(self._score_fn(batch), np.float32)
            self.n_dispatches += 1
        return probs[: len(graphs)]

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

    # -- warmup -------------------------------------------------------------

    def _dummy_graph(self) -> Graph:
        n = 2
        feats = {k: np.zeros(n, np.int32) for k in self.feat_keys}
        return Graph(senders=np.arange(n - 1, dtype=np.int32),
                     receivers=np.arange(1, n, dtype=np.int32),
                     node_feats=feats).with_self_loops()

    def warmup(self) -> dict:
        """Run every bucket (and the megabatch shape) once, so the first
        request pays neither the kernel build nor first-call setup; returns
        ``{"buckets": n, "per_bucket": {name: {"seconds": s}}}``. Calls the
        score function directly: warmup dispatches are not counted."""
        g = self._dummy_graph()
        report: dict = {"buckets": len(self.buckets), "per_bucket": {}}
        shapes = [(str(b.graph_nodes), b) for b in self.buckets]
        if self.mega_bucket is not None:
            shapes.append(("mega", self.mega_bucket))
        for name, b in shapes:
            t0 = time.perf_counter()
            with self._lock:
                batch = batch_np([g], b.spec.max_graphs, b.spec.max_nodes,
                                 b.spec.max_edges)
                np.asarray(self._score_fn(batch), np.float32)
            report["per_bucket"][name] = {"seconds": time.perf_counter() - t0}
        self.warm_buckets = [b.graph_nodes for b in self.buckets]
        self.last_warmup_report = report
        return report

    # -- constructor --------------------------------------------------------

    @classmethod
    def from_model(cls, model, state=None, label_style: str = "graph",
                   feat_keys=(), max_batch: int = 16, buckets=None,
                   megabatch: bool = False, device=None,
                   vocab_hash: str | None = None, precision: str = "f32",
                   mesh=None) -> "ScoringEngine":
        """Live-model engine. ``state`` (a state dict, or None to keep the
        model's own weights) is loaded into ``model``, which moves to
        ``device`` — ``cuda`` unless the caller names another; without a
        GPU and without an explicit ``"cpu"`` this raises.
        ``megabatch=True`` adds the :func:`mega_bucket` shape for
        :meth:`score_packed`. A ``layout="megabatch"`` model raises
        ``ValueError`` here (see :func:`~deepdfa_tpu_torch.predict.
        make_scorer`)."""
        from deepdfa_tpu_torch.predict import make_scorer

        if precision != "f32":
            raise NotImplementedError(
                f"precision={precision!r}: int8 serving is not ported yet "
                "(ROADMAP A9, kernel B5)")
        if mesh is not None:
            raise NotImplementedError(
                "mesh replication is not ported yet (ROADMAP A11)")
        dev = resolve_device(device)
        if state is not None:
            model.load_state_dict(state)
        model = model.to(dev).eval()
        keys = tuple(feat_keys)
        scorer = make_scorer(model, label_style)

        def score_fn(batch):
            probs, _ = scorer(to_device(batch, dev, keys))
            return probs.cpu().numpy()

        return cls(score_fn, tuple(buckets or serve_buckets(max_batch)),
                   label_style=label_style, feat_keys=keys,
                   vocab_hash=vocab_hash,
                   model_rev=model_revision(model.state_dict(), dev),
                   mega=mega_bucket(max_batch) if megabatch else None)
