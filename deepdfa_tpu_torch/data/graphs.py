"""Fixed-shape batched graph container and host-side batcher.

A copy of the serving and training subset of the JAX package's
``deepdfa_tpu/data/graphs.py`` (host-side numpy, no framework): :class:`Graph`,
:class:`BatchedGraphs`, :func:`batch_np`, :class:`BucketSpec`,
:class:`GraphBatcher`, :func:`derive_buckets`, :func:`padding_efficiency`,
plus :func:`to_device`, which moves a padded batch onto a torch device.

- :class:`BatchedGraphs` — flat arrays with **static shapes**: every batch in a
  bucket has exactly ``max_nodes`` nodes, ``max_edges`` edges and
  ``max_graphs`` graph slots; real entries are marked by masks.
- Padding convention: the **last graph slot** owns all padding nodes; padding
  edges are self-loops on the last (padding) node. Segment reductions therefore
  dump padding contributions into padding slots that masks exclude.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, NamedTuple, Sequence

import numpy as np
import torch

__all__ = [
    "Graph",
    "BatchedGraphs",
    "batch_np",
    "BucketSpec",
    "GraphBatcher",
    "derive_buckets",
    "padding_efficiency",
    "to_device",
]


@dataclasses.dataclass
class Graph:
    """A single (host-side, numpy) graph.

    ``node_feats`` values are ``[n_nodes, ...]`` arrays; integer feature ids
    and labels (``_VULN``) live here.
    """

    senders: np.ndarray  # [n_edges] int32, source node index
    receivers: np.ndarray  # [n_edges] int32
    node_feats: dict[str, np.ndarray]
    gid: int = -1  # dataset graph id; host-side only

    @property
    def n_nodes(self) -> int:
        for v in self.node_feats.values():
            return int(v.shape[0])
        if self.senders.size == 0:
            return 0
        return int(max(self.senders.max(), self.receivers.max()) + 1)

    @property
    def n_edges(self) -> int:
        return int(self.senders.shape[0])

    def with_self_loops(self) -> "Graph":
        """Append one self-loop per node; GGNN message passing needs every
        node to see its own state."""
        n = self.n_nodes
        loop = np.arange(n, dtype=np.int32)
        return dataclasses.replace(
            self,
            senders=np.concatenate([self.senders.astype(np.int32), loop]),
            receivers=np.concatenate([self.receivers.astype(np.int32), loop]),
        )


class BatchedGraphs(NamedTuple):
    """Device-ready batch. All shapes static within a bucket.

    node_feats: dict of ``[max_nodes, ...]`` arrays.
    senders/receivers: ``[max_edges]`` int32 into the node axis, SORTED by
    receiver (``batch_np`` contract).
    node_gidx: ``[max_nodes]`` int32 graph slot of each node.
    node_mask / edge_mask / graph_mask: bool validity masks.
    """

    node_feats: dict
    senders: np.ndarray
    receivers: np.ndarray
    node_gidx: np.ndarray
    node_mask: np.ndarray
    edge_mask: np.ndarray
    graph_mask: np.ndarray

    @property
    def max_nodes(self) -> int:
        return self.node_gidx.shape[0]

    @property
    def max_graphs(self) -> int:
        return self.graph_mask.shape[0]


def batch_np(
    graphs: Sequence[Graph],
    max_graphs: int,
    max_nodes: int,
    max_edges: int,
    extra_feat_pad: dict[str, float] | None = None,
) -> BatchedGraphs:
    """Concatenate ``graphs`` and pad to the static budget (numpy, host-side).

    Requires ``sum(n_nodes) <= max_nodes - 1`` (one node reserved for edge
    padding) and ``len(graphs) <= max_graphs - 1`` (one slot reserved as the
    padding graph).
    """
    n_real = len(graphs)
    tot_nodes = sum(g.n_nodes for g in graphs)
    tot_edges = sum(g.n_edges for g in graphs)
    if n_real > max_graphs - 1:
        raise ValueError(f"{n_real} graphs > budget {max_graphs - 1}")
    if tot_nodes > max_nodes - 1:
        raise ValueError(f"{tot_nodes} nodes > budget {max_nodes - 1}")
    if tot_edges > max_edges:
        raise ValueError(f"{tot_edges} edges > budget {max_edges}")

    senders = np.full(max_edges, max_nodes - 1, dtype=np.int32)
    receivers = np.full(max_edges, max_nodes - 1, dtype=np.int32)
    node_gidx = np.full(max_nodes, max_graphs - 1, dtype=np.int32)

    node_off = 0
    edge_off = 0
    for gi, g in enumerate(graphs):
        nn, ne = g.n_nodes, g.n_edges
        senders[edge_off : edge_off + ne] = g.senders + node_off
        receivers[edge_off : edge_off + ne] = g.receivers + node_off
        node_gidx[node_off : node_off + nn] = gi
        node_off += nn
        edge_off += ne

    # Contract: edges sorted by receiver (stable). Real receivers are all
    # < max_nodes-1 (the padding sink), so padding edges stay at the end.
    # The fused kernel builds its CSR row pointer from this order, and sums
    # each receiver's messages in it.
    order = np.argsort(receivers, kind="stable")
    senders = senders[order]
    receivers = receivers[order]

    node_feats: dict[str, np.ndarray] = {}
    keys = graphs[0].node_feats.keys() if graphs else ()
    pad_values = extra_feat_pad or {}
    for key in keys:
        parts = [g.node_feats[key] for g in graphs]
        sample = parts[0]
        shape = (max_nodes,) + sample.shape[1:]
        out = np.full(shape, pad_values.get(key, 0), dtype=sample.dtype)
        cat = np.concatenate(parts, axis=0)
        out[: cat.shape[0]] = cat
        node_feats[key] = out

    node_mask = np.arange(max_nodes) < tot_nodes
    edge_mask = np.arange(max_edges) < tot_edges
    graph_mask = np.arange(max_graphs) < n_real
    return BatchedGraphs(
        node_feats=node_feats,
        senders=senders,
        receivers=receivers,
        node_gidx=node_gidx,
        node_mask=node_mask,
        edge_mask=edge_mask,
        graph_mask=graph_mask,
    )


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Static padded-batch budget. One graph slot (``max_graphs - 1``) and one
    node slot (``max_nodes - 1``) are RESERVED as the padding sinks, so a
    bucket holds at most ``max_graphs - 1`` real graphs over
    ``max_nodes - 1`` real nodes (see :func:`batch_np`)."""

    max_graphs: int
    max_nodes: int
    max_edges: int

    def fits(self, n_graphs: int, n_nodes: int, n_edges: int) -> bool:
        return (
            n_graphs <= self.max_graphs - 1
            and n_nodes <= self.max_nodes - 1
            and n_edges <= self.max_edges
        )


class GraphBatcher:
    """Greedy fixed-shape packer.

    Packs graphs in the given order until the next graph would exceed the
    largest bucket's budget, then emits a padded :class:`BatchedGraphs` in
    the smallest bucket that fits. A graph that alone exceeds the largest
    bucket is collected in ``oversize_graphs`` (``collect_oversize``, the
    trainer's route through an overflow bucket), dropped and counted in
    ``n_dropped`` (``drop_oversize``), or raises. Both counters are per
    pass. ``overflow_bucket`` may be set by the caller to pre-size the
    overflow bucket (see ``train.fit``).
    """

    def __init__(self, buckets: Sequence[BucketSpec], drop_oversize: bool = True,
                 collect_oversize: bool = False):
        if not buckets:
            raise ValueError("need at least one bucket")
        for b in buckets:
            if b.max_graphs < 2 or b.max_nodes < 2:
                # the padding-sink reservation makes such a bucket hold zero
                # real graphs — with drop_oversize it would silently drop ALL
                raise ValueError(
                    f"unusable bucket {b}: max_graphs and max_nodes must be "
                    "≥ 2 (one slot each is reserved as the padding sink)"
                )
        self.buckets = sorted(buckets, key=lambda b: (b.max_nodes, b.max_edges, b.max_graphs))
        self.big = self.buckets[-1]
        self.drop_oversize = drop_oversize
        self.collect_oversize = collect_oversize
        self.n_dropped = 0
        self.oversize_graphs: list[Graph] = []
        self.overflow_bucket: BucketSpec | None = None

    def batches(self, graphs: Sequence[Graph]) -> Iterator[BatchedGraphs]:
        # per-pass counters (batches() is re-run every epoch)
        self.n_dropped = 0
        self.oversize_graphs = []
        pending: list[Graph] = []
        nn = ne = 0
        for g in graphs:
            if not self.big.fits(1, g.n_nodes, g.n_edges):
                if self.collect_oversize:
                    self.oversize_graphs.append(g)
                    continue
                if self.drop_oversize:
                    self.n_dropped += 1
                    continue
                raise ValueError(
                    f"graph gid={g.gid} ({g.n_nodes} nodes, {g.n_edges} edges) "
                    f"exceeds the largest bucket {self.big}"
                )
            if pending and not self.big.fits(len(pending) + 1, nn + g.n_nodes, ne + g.n_edges):
                yield self._emit(pending, nn, ne)
                pending, nn, ne = [], 0, 0
            pending.append(g)
            nn += g.n_nodes
            ne += g.n_edges
        if pending:
            yield self._emit(pending, nn, ne)

    def _emit(self, pending: list[Graph], nn: int, ne: int) -> BatchedGraphs:
        bucket = next(b for b in self.buckets if b.fits(len(pending), nn, ne))
        return batch_np(pending, bucket.max_graphs, bucket.max_nodes, bucket.max_edges)


def _round_up(x: int, mult: int = 128) -> int:
    return ((int(x) + mult - 1) // mult) * mult


def derive_buckets(
    graphs: Sequence[Graph],
    batch_graphs: int,
    headroom: float = 1.08,
    sub_buckets: Sequence[float] = (0.25, 0.5),
    round_to: int = 128,
) -> list[BucketSpec]:
    """Bucket budgets sized to the corpus instead of a worst-case constant:
    the main bucket from the mean nodes and edges per graph
    (``batch_graphs × mean × headroom``, rounded up to ``round_to``), plus
    scaled-down sub-buckets so tail batches do not pay full-size padding.
    Every bucket holds at least the largest single graph."""
    if not graphs:
        raise ValueError("cannot derive buckets from an empty corpus")
    mean_nodes = float(np.mean([g.n_nodes for g in graphs]))
    mean_edges = float(np.mean([g.n_edges for g in graphs]))
    max_nodes_1 = max(g.n_nodes for g in graphs)
    max_edges_1 = max(g.n_edges for g in graphs)

    def spec(frac: float) -> BucketSpec:
        n_g = max(int(round(batch_graphs * frac)), 1)
        return BucketSpec(
            max_graphs=n_g + 1,
            max_nodes=_round_up(max(n_g * mean_nodes * headroom, max_nodes_1 + 1), round_to),
            max_edges=_round_up(max(n_g * mean_edges * headroom, max_edges_1), round_to),
        )

    buckets = [spec(f) for f in (*sub_buckets, 1.0)]
    # drop sub-buckets that collapsed into the same size as a larger one
    out: list[BucketSpec] = []
    for b in buckets:
        if not out or b != out[-1]:
            out.append(b)
    return out


def padding_efficiency(batches: Sequence[BatchedGraphs]) -> dict[str, float]:
    """Fraction of the padded budgets occupied by real entries."""
    real_n = sum(int(b.node_mask.sum()) for b in batches)
    real_e = sum(int(b.edge_mask.sum()) for b in batches)
    real_g = sum(int(b.graph_mask.sum()) for b in batches)
    pad_n = sum(b.node_mask.shape[0] for b in batches)
    pad_e = sum(b.edge_mask.shape[0] for b in batches)
    pad_g = sum(b.graph_mask.shape[0] for b in batches)
    return {
        "nodes": real_n / pad_n if pad_n else 0.0,
        "edges": real_e / pad_e if pad_e else 0.0,
        "graphs": real_g / pad_g if pad_g else 0.0,
    }


def to_device(batch: BatchedGraphs, device, feat_keys=None) -> BatchedGraphs:
    """The batch as torch tensors on ``device``. ``feat_keys`` keeps only
    those feature columns (request graphs carry columns the model never
    reads, such as ``_VULN``)."""
    keys = batch.node_feats.keys() if feat_keys is None else feat_keys

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return BatchedGraphs(
        node_feats={k: put(batch.node_feats[k]) for k in keys},
        senders=put(batch.senders),
        receivers=put(batch.receivers),
        node_gidx=put(batch.node_gidx),
        node_mask=put(batch.node_mask),
        edge_mask=put(batch.edge_mask),
        graph_mask=put(batch.graph_mask),
    )
