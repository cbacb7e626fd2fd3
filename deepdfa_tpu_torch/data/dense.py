"""Dense-adjacency batch layout: each graph in a fixed node slot with its
adjacency materialised as a ``[n, n]`` count matrix.

A copy of ``deepdfa_tpu/data/dense.py`` (host-side numpy, no framework):
:class:`DenseBatch`, :func:`batch_dense`, :func:`derive_dense_size`,
:func:`derive_dense_sizes` (the occupancy-optimal bucket split) and
:class:`DenseBatcher`. The arrays and sizes are byte for byte the JAX
module's on the same graphs; :func:`dense_to_device` moves a batch onto a
torch device.

Semantics match :func:`~deepdfa_tpu_torch.data.graphs.batch_np` with the
segment reductions: ``adj[g, j, i]`` counts the edges j→i within graph
``g`` (duplicate edges accumulate, as duplicate entries do in a segment
sum); self-loops are expected in the edge lists. Padding nodes have zero
adjacency rows and columns and are excluded from pooling by
``node_mask``.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Sequence

import numpy as np

from deepdfa_tpu_torch.data.graphs import Graph

__all__ = ["DenseBatch", "batch_dense", "DenseBatcher", "derive_dense_size",
           "derive_dense_sizes", "dense_to_device"]


class DenseBatch(NamedTuple):
    """Device-ready dense batch. All shapes static.

    node_feats: dict of ``[max_graphs, nodes_per_graph, ...]`` arrays,
    carried generically (any key on the input graphs, the ``_DFA_*``
    static-analysis families included, is padded and batched unchanged).
    adj: ``[max_graphs, n, n]`` float32, ``adj[g, j, i]`` = #edges j→i.
    node_mask: ``[max_graphs, n]`` bool. graph_mask: ``[max_graphs]`` bool.
    """

    node_feats: dict
    adj: np.ndarray
    node_mask: np.ndarray
    graph_mask: np.ndarray

    @property
    def max_graphs(self) -> int:
        return self.graph_mask.shape[0]

    @property
    def nodes_per_graph(self) -> int:
        return self.node_mask.shape[1]


def batch_dense(
    graphs: Sequence[Graph],
    max_graphs: int,
    nodes_per_graph: int,
    extra_feat_pad: dict[str, float] | None = None,
) -> DenseBatch:
    """Pack ``graphs`` (each with ``n_nodes <= nodes_per_graph``) into one
    dense batch. No slots are reserved: padding nodes and graphs are inert
    (zero adjacency, masked out of pooling)."""
    n_real = len(graphs)
    if n_real > max_graphs:
        raise ValueError(f"{n_real} graphs > budget {max_graphs}")
    n = nodes_per_graph
    adj = np.zeros((max_graphs, n, n), np.float32)
    node_mask = np.zeros((max_graphs, n), bool)
    pad_values = extra_feat_pad or {}

    node_feats: dict[str, np.ndarray] = {}
    keys = graphs[0].node_feats.keys() if graphs else ()
    for key in keys:
        sample = graphs[0].node_feats[key]
        node_feats[key] = np.full(
            (max_graphs, n) + sample.shape[1:], pad_values.get(key, 0),
            dtype=sample.dtype,
        )

    for gi, g in enumerate(graphs):
        nn_ = g.n_nodes
        if nn_ > n:
            raise ValueError(
                f"graph gid={g.gid} has {nn_} nodes > nodes_per_graph={n}")
        np.add.at(adj[gi], (g.senders, g.receivers), 1.0)
        node_mask[gi, :nn_] = True
        for key in keys:
            node_feats[key][gi, :nn_] = g.node_feats[key]

    graph_mask = np.arange(max_graphs) < n_real
    return DenseBatch(node_feats=node_feats, adj=adj, node_mask=node_mask,
                      graph_mask=graph_mask)


def derive_dense_size(graphs: Sequence[Graph], quantile: float = 0.99,
                      round_to: int = 8) -> int:
    """Per-graph node budget from the corpus size distribution: the
    ``quantile`` node count rounded up to ``round_to`` (graphs above it take
    the batcher's oversize route)."""
    if not graphs:
        raise ValueError("empty corpus")
    sizes = np.array([g.n_nodes for g in graphs])
    q = float(np.quantile(sizes, quantile))
    return int(-(-max(q, 1.0) // round_to) * round_to)


def derive_dense_sizes(
    graphs: Sequence[Graph],
    quantiles: Sequence[float] | None = None,
    round_to: int = 8,
    k: int = 6,
    oversize_quantile: float = 0.99,
) -> list[int]:
    """Per-graph node budgets (one shape each) that minimise the total
    padded node slots: an O(k·U²) dynamic program over the rounded size
    histogram with at most ``k`` buckets, the largest being the
    ``oversize_quantile`` budget (graphs above it take the oversize route).
    ``quantiles``, when passed, picks one budget per quantile instead."""
    if quantiles is not None:
        return sorted({derive_dense_size(graphs, q, round_to)
                       for q in quantiles})
    if not graphs:
        raise ValueError("empty corpus")
    cap = derive_dense_size(graphs, oversize_quantile, round_to)
    rounded = np.array(sorted(
        int(-(-max(g.n_nodes, 1) // round_to) * round_to)
        for g in graphs
        if -(-max(g.n_nodes, 1) // round_to) * round_to <= cap
    ))
    cands = sorted(set(rounded.tolist()) | {cap})
    # prefix[i] = #graphs with rounded size <= cands[i]
    prefix = np.searchsorted(rounded, cands, side="right")
    U = len(cands)
    k = min(k, U)
    INF = float("inf")
    # dp[m][j]: least total slots covering every graph <= cands[j] with m
    # buckets whose largest budget is cands[j]
    dp = [[INF] * U for _ in range(k + 1)]
    back = [[-1] * U for _ in range(k + 1)]
    for j in range(U):
        dp[1][j] = float(prefix[j] * cands[j])
    for m in range(2, k + 1):
        for j in range(m - 1, U):
            best, arg = dp[m - 1][j], -2  # fewer buckets is always legal
            for i in range(j):
                c = dp[m - 1][i] + float((prefix[j] - prefix[i]) * cands[j])
                if c < best:
                    best, arg = c, i
            dp[m][j] = best
            back[m][j] = arg
    # reconstruct from dp[k][U-1]: the top bucket is the cap, so every
    # graph that is not oversize fits
    sizes = []
    m, j = k, U - 1
    while m >= 1 and j >= 0:
        sizes.append(cands[j])
        i = back[m][j] if m > 1 else -1
        if i == -2:  # the same j with fewer buckets
            m -= 1
            continue
        j = i
        m -= 1
    return sorted(set(sizes))


class DenseBatcher:
    """Greedy fixed-shape packer for the dense layout: each graph goes to the
    smallest of ``sizes`` (per-graph node budgets, one shape each) that
    fits, and full batches of ``max_graphs`` are emitted per size.

    Graphs over the largest size have three routes:

    - ``collect_oversize=True`` (how the trainer runs it): kept in
      ``oversize_graphs`` for the caller to score through the segment-layout
      forward of the same parameters;
    - ``drop_oversize=True``: dropped and counted in ``n_dropped``;
    - otherwise: raise, as :class:`~deepdfa_tpu_torch.data.graphs.
      GraphBatcher` does.
    """

    def __init__(self, max_graphs: int, nodes_per_graph: int | Sequence[int],
                 drop_oversize: bool = True, collect_oversize: bool = False):
        sizes = ([nodes_per_graph] if isinstance(nodes_per_graph, int)
                 else sorted(nodes_per_graph))
        if max_graphs < 1 or not sizes or min(sizes) < 1:
            raise ValueError("max_graphs and every size must be >= 1")
        self.max_graphs = max_graphs
        self.sizes = sizes
        self.nodes_per_graph = sizes[-1]  # the largest
        self.drop_oversize = drop_oversize
        self.collect_oversize = collect_oversize
        self.n_dropped = 0
        self.oversize_graphs: list[Graph] = []
        self.overflow_bucket = None  # set by the trainer's batcher factory

    def _size_for(self, g: Graph) -> int | None:
        for s in self.sizes:
            if g.n_nodes <= s:
                return s
        return None

    def batches(
        self, graphs: Sequence[Graph], limit_per_size: int | None = None
    ) -> Iterator[DenseBatch]:
        """With ``limit_per_size``, emit at most that many FULL batches per
        size, skip graphs routed to sizes already full, and stop once every
        size is full. Partial batches are flushed only without a limit."""
        self.n_dropped = 0
        self.oversize_graphs = []
        pending: dict[int, list[Graph]] = {s: [] for s in self.sizes}
        emitted: dict[int, int] = {s: 0 for s in self.sizes}
        for g in graphs:
            s = self._size_for(g)
            if s is None:
                if self.collect_oversize:
                    self.oversize_graphs.append(g)
                    continue
                if self.drop_oversize:
                    self.n_dropped += 1
                    continue
                raise ValueError(
                    f"graph gid={g.gid} ({g.n_nodes} nodes) exceeds the "
                    f"largest dense size {self.sizes[-1]}")
            if limit_per_size is not None and emitted[s] >= limit_per_size:
                continue
            pending[s].append(g)
            if len(pending[s]) == self.max_graphs:
                yield batch_dense(pending[s], self.max_graphs, s)
                pending[s] = []
                emitted[s] += 1
                if (limit_per_size is not None
                        and all(n >= limit_per_size for n in emitted.values())):
                    return
        if limit_per_size is None:
            for s, left in pending.items():
                if left:
                    yield batch_dense(left, self.max_graphs, s)

    def occupancy(self, batches: Sequence[DenseBatch]) -> dict[str, float]:
        """Fraction of node slots and graph slots holding real data,
        weighted by slots (batches of different shapes hold different slot
        counts)."""
        if not batches:
            return {"nodes": 0.0, "graphs": 0.0}
        node_full = sum(int(b.node_mask.sum()) for b in batches)
        node_slots = sum(b.node_mask.size for b in batches)
        graph_full = sum(int(b.graph_mask.sum()) for b in batches)
        graph_slots = sum(b.graph_mask.size for b in batches)
        return {"nodes": node_full / node_slots,
                "graphs": graph_full / graph_slots}


def dense_to_device(batch: DenseBatch, device, feat_keys=None) -> DenseBatch:
    """The batch as torch tensors on ``device``; ``feat_keys`` keeps only
    those feature columns."""
    import torch

    keys = batch.node_feats.keys() if feat_keys is None else feat_keys

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return DenseBatch(node_feats={k: put(batch.node_feats[k]) for k in keys},
                      adj=put(batch.adj), node_mask=put(batch.node_mask),
                      graph_mask=put(batch.graph_mask))
