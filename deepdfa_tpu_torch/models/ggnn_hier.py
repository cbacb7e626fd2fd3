"""Hierarchical two-level GGNN: whole-unit scoring on the whole-model kernel.

The port of ``deepdfa_tpu/models/ggnn_hier.py``. A merged file or repo CPG
is larger than the largest serving bucket, so whole-unit scoring composes
per-function embeddings instead:

- **Level 1** — the golden per-function GGNN stopped at the pooled
  embedding: :func:`~deepdfa_tpu_torch.ops.megabatch.fused_ggnn_encoder`,
  which on the card is the whole-model kernel B3 with a head of 0 layers
  (kernel B4), fed by this module's own first-fit-decreasing packer (the
  JAX package's bins, index for index). A function's row does not depend on
  the other graphs of its bin: every kernel of the path works per node, per
  receiver or per graph slot.
- **Embedding cache** — a :class:`~deepdfa_tpu_torch.serve.embcache.
  FunctionEmbeddingCache` in front of level 1, so a warm rescan makes no
  level-1 dispatch.
- **Level 2** — :class:`CallGraphGGNN`, a small GGNN over the call graph
  (one node per function: its level-1 embedding beside
  :data:`N_SUMMARY_FEATURES` interprocedural summaries), giving the unit
  score and a per-function attribution. It is a handful of nodes and runs
  as plain torch on the scorer's device.

What differs from the JAX package:

- :meth:`HierScorer.score_unit` takes the unit's call graph either as a
  :class:`~deepdfa_tpu_torch.cpg.interproc.Supergraph`, as the JAX
  scorer does (:func:`unit_graph` maps it with :func:`unit_call_edges`
  and :func:`unit_summaries`), or already mapped, as a
  :class:`UnitCallGraph` (level 2's input type).
- Level-2 weights are drawn by the port's :func:`~deepdfa_tpu_torch.models.
  ggnn.init_params` from a seed derived, by the JAX package's formula, from a
  device-free content hash of the level-1 state dict: the same checkpoint
  gives the same level-2 weights on the card and on the CPU. They are not
  the JAX package's weights (its PRNG cannot be reproduced); carry those
  across with :func:`deepdfa_tpu_torch.bridge.level2_flax_to_torch`.
- Every level-1 bin runs on B4, which takes any shape the packer makes, so
  ``n_fallback_dispatches`` (the JAX scorer's count of bins its VMEM plan
  refused) stays 0.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import time
from typing import Sequence

import numpy as np
import torch
from torch import nn

from deepdfa_tpu_torch import resolve_device
from deepdfa_tpu_torch.config import ALL_SUBKEYS, GGNNConfig
from deepdfa_tpu_torch.data.graphs import Graph, _round_up, batch_np
from deepdfa_tpu_torch.models.ggnn import GRUCell, init_params
from deepdfa_tpu_torch.ops.megabatch import MegabatchPlan, fused_ggnn_encoder
from deepdfa_tpu_torch.ops.segment import gather, segment_sum

__all__ = ["CallGraphGGNN", "HierScorer", "N_SUMMARY_FEATURES",
           "UnitCallGraph", "UnitFunction", "megabatch_compatible",
           "unit_call_edges", "unit_graph", "unit_summaries"]

# per-function interprocedural summary width fed to level 2 beside the
# level-1 embedding: [log1p(n_nodes), log1p(Σ ireach), clip(max ireach)/8,
# max itaint / 3, any cross-boundary-only taint, log1p(callers),
# log1p(callees)]
N_SUMMARY_FEATURES = 7


def megabatch_compatible(cfg: GGNNConfig) -> bool:
    """Whether ``cfg`` is servable by the whole-model kernel — the
    constraints :class:`~deepdfa_tpu_torch.models.ggnn_megabatch.
    GGNNMegabatch` enforces. Engines outside this envelope have no
    hierarchical path."""
    return (cfg.concat_all_absdf
            and not cfg.dataflow_families
            and not cfg.interproc_families
            and cfg.label_style == "graph"
            and not cfg.encoder_mode
            and cfg.aggregation == "sum")


@dataclasses.dataclass(frozen=True)
class UnitFunction:
    """One function of a scoring unit: the name the call graph resolves,
    the source text the embedding cache keys on, and the encoded graph
    level 1 embeds on a miss."""

    name: str
    code: str
    graph: Graph


@dataclasses.dataclass(frozen=True)
class UnitCallGraph:
    """Level 2's view of a unit, in the order of its functions: the
    bidirectional call edges with one self-loop per function (as
    :func:`unit_call_edges` makes them), the ``[n, N_SUMMARY_FEATURES]``
    float32 summaries, and the number of call edges of the unit's call
    graph (reported as ``call_edges``)."""

    senders: np.ndarray
    receivers: np.ndarray
    summaries: np.ndarray
    n_call_edges: int


def unit_call_edges(sg, names: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
    """Call-graph edges of ``sg`` mapped onto unit-function indices,
    bidirectional (taint flows both ways across a call boundary) with one
    self-loop per function so isolated functions still see their own
    state. Edges touching a method outside ``names`` are dropped. ``sg``
    needs ``callgraph.edges`` (pairs of method ids) and ``method_names``
    (method id → name)."""
    index = {name: i for i, name in enumerate(names)}
    pairs: set[tuple[int, int]] = {(i, i) for i in range(len(names))}
    for caller_mid, callee_mid in sg.callgraph.edges:
        a = index.get(sg.method_names.get(caller_mid, ""))
        b = index.get(sg.method_names.get(callee_mid, ""))
        if a is None or b is None:
            continue
        pairs.add((a, b))
        pairs.add((b, a))
    ordered = sorted(pairs)
    senders = np.asarray([a for a, _ in ordered], np.int32)
    receivers = np.asarray([b for _, b in ordered], np.int32)
    return senders, receivers


def unit_summaries(sg, names: Sequence[str]) -> np.ndarray:
    """``[len(names), N_SUMMARY_FEATURES]`` per-function interprocedural
    summaries of the supergraph ``sg`` — the ``ireach``/``itaint`` node
    features of :func:`~deepdfa_tpu_torch.cpg.interproc.
    interproc_node_features` folded to one row per function, with its
    caller and callee counts; the JAX package's rows exactly."""
    from deepdfa_tpu_torch.cpg.interproc import interproc_node_features

    feats = interproc_node_features(sg.base, sg=sg)
    mid_of = {name: mid for mid, name in sg.method_names.items()}
    by_owner: dict[int, list[int]] = {}
    for nid in sg.base.nodes:
        mid = sg.owner.get(nid)
        if mid is not None:
            by_owner.setdefault(mid, []).append(nid)
    callers: dict[int, int] = {}
    callees: dict[int, int] = {}
    for a, b in sg.callgraph.edges:
        callees[a] = callees.get(a, 0) + 1
        callers[b] = callers.get(b, 0) + 1
    out = np.zeros((len(names), N_SUMMARY_FEATURES), np.float32)
    for i, name in enumerate(names):
        mid = mid_of.get(name)
        if mid is None:
            continue
        nodes = by_owner.get(mid, [])
        ireach = [feats["ireach"].get(n, 0) for n in nodes]
        itaint = [feats["itaint"].get(n, 0) for n in nodes]
        out[i] = [
            math.log1p(len(nodes)),
            math.log1p(float(sum(ireach))),
            min(max(ireach, default=0), 8) / 8.0,
            max(itaint, default=0) / 3.0,
            1.0 if any(c >= 3 for c in itaint) else 0.0,
            math.log1p(float(callers.get(mid, 0))),
            math.log1p(float(callees.get(mid, 0))),
        ]
    return out


def unit_graph(sg, names: Sequence[str]) -> UnitCallGraph:
    """Level 2's input for the functions ``names`` of the supergraph
    ``sg``: its call edges, summaries and call-edge count."""
    senders, receivers = unit_call_edges(sg, names)
    return UnitCallGraph(senders, receivers, unit_summaries(sg, names),
                         int(sg.n_call_edges))


class CallGraphGGNN(nn.Module):
    """Small GGNN over the call graph (one node per function).

    ``in_proj`` compresses ``[level-1 embedding | summaries]`` (``in_dim``
    wide) to ``hidden``; ``n_steps`` message rounds run over the call edges
    (linear message, sum over receivers, GRU — the level-1 update rule at
    call-graph scale); the readout is a masked softmax gate that pools the
    unit embedding for the ``out`` head, and a per-node ``attr`` head gives
    the per-function attribution logits. Module names follow the JAX
    package's Flax scopes (``in_proj``, ``edge_linear``,
    ``gru/{x_proj,h_proj}``, ``gate``, ``out``, ``attr``)."""

    def __init__(self, in_dim: int, hidden: int = 32, n_steps: int = 2):
        super().__init__()
        self.n_steps = n_steps
        self.in_proj = nn.Linear(in_dim, hidden)
        self.edge_linear = nn.Linear(hidden, hidden)
        self.gru = GRUCell(hidden)
        self.gate = nn.Linear(2 * hidden, 1)
        self.out = nn.Linear(2 * hidden, 1)
        self.attr = nn.Linear(2 * hidden, 1)

    def forward(self, emb, senders, receivers, mask):
        """``(unit_logit [], fn_logit [n], gate [n])``."""
        n = emb.shape[0]
        h = torch.tanh(self.in_proj(emb))
        h0 = h
        for _ in range(self.n_steps):
            msg = self.edge_linear(h)
            h = self.gru(segment_sum(gather(msg, senders), receivers, n), h)
        hcat = torch.cat([h, h0], dim=-1)
        gate_logit = self.gate(hcat)[:, 0]
        gate_logit = torch.where(mask, gate_logit,
                                 torch.full_like(gate_logit, float("-inf")))
        gate = torch.softmax(gate_logit, dim=0)
        pooled = torch.sum(gate[:, None] * hcat, dim=0)
        unit_logit = self.out(pooled)[0]
        fn_logit = self.attr(hcat)[:, 0]
        return unit_logit, fn_logit, gate


class HierScorer:
    """Two-level whole-unit scorer over a level-1 GGNN state dict.

    ``state_dict`` is the float32 state every layout shares
    (``embeddings.{sk}``, ``ggnn``, ``pooling``; the head is never read) of
    a megabatch-compatible ``cfg`` / ``input_dim``. ``cache`` (a
    :class:`~deepdfa_tpu_torch.serve.embcache.FunctionEmbeddingCache`) is
    consulted before any level-1 work and written after; attach or swap it
    freely. ``model_rev`` names the level-1 weights (the engine passes its
    own, which folds in the device kind; by default the same hash on
    ``device``); the level-2 seed comes from the device-free hash instead.
    Runs on ``device``, ``cuda`` unless the caller names another.

    Counters: ``n_level1_dispatches`` B4 calls (one per packed bin),
    ``n_fallback_dispatches`` always 0 (every bin runs on B4; the JAX
    scorer counts bins its VMEM plan sent to the plain version here),
    ``level1_recompute`` functions embedded rather than served from the
    cache. ``last_seconds`` holds the host seconds of the last
    :meth:`score_unit`'s two levels.
    """

    #: level-1 bin budget (graphs, nodes), the JAX package's
    MAX_BIN_GRAPHS = 64
    MAX_BIN_NODES = 4094

    def __init__(self, cfg: GGNNConfig, input_dim: int, state_dict, *,
                 cache=None, model_rev: str | None = None,
                 level2_hidden: int = 32, level2_steps: int = 2,
                 device=None):
        if not megabatch_compatible(cfg):
            raise ValueError(
                "HierScorer needs a megabatch-compatible level-1 config "
                "(concat_all_absdf=True, graph labels, sum aggregation, no "
                "dataflow/interproc families, no encoder_mode) — level 1 "
                "runs on the whole-model kernel")
        from deepdfa_tpu_torch.serve.engine import model_revision

        self.device = resolve_device(device)
        self.cfg = cfg
        self.input_dim = int(input_dim)
        self.cache = cache
        self.n_level1_dispatches = 0
        self.n_fallback_dispatches = 0
        self.level1_recompute = 0
        self.last_seconds: dict[str, float] | None = None
        self._width = cfg.hidden_dim * len(ALL_SUBKEYS)
        self.out_dim = 2 * self._width

        def f32(name: str) -> torch.Tensor:
            return state_dict[name].detach().to(self.device, torch.float32)

        def dense(prefix: str) -> tuple[torch.Tensor, torch.Tensor]:
            return (f32(f"{prefix}.weight").t().contiguous(),
                    f32(f"{prefix}.bias"))

        self._table = torch.cat(
            [f32(f"embeddings.{sk}.weight") for sk in ALL_SUBKEYS]).contiguous()
        self._weights = (dense("ggnn.edge_linear") + dense("ggnn.gru.x_proj")
                         + dense("ggnn.gru.h_proj") + dense("pooling.gate"))
        self.model_rev = model_rev or model_revision(state_dict, self.device)
        # the JAX package's seed formula over a device-free revision: the
        # card and the CPU draw the same level-2 weights
        seed = int.from_bytes(hashlib.sha256(
            model_revision(state_dict, "cpu").encode()).digest()[:4], "big")
        self.level2 = init_params(
            CallGraphGGNN(self.out_dim + N_SUMMARY_FEATURES, level2_hidden,
                          level2_steps), seed).to(self.device).eval()

    # -- level 1: pack + embed ----------------------------------------------

    def _plan(self, n_graphs: int, n_nodes: int, n_edges: int) -> MegabatchPlan:
        return MegabatchPlan(
            max_graphs=n_graphs + 1,
            max_nodes=_round_up(max(n_nodes + 1, 8), 8),
            max_edges=_round_up(max(n_edges, 1), 128),
            width=self._width,
            n_steps=self.cfg.n_steps,
            table_rows=self.input_dim * len(ALL_SUBKEYS),
            embed_width=self.cfg.hidden_dim,
            n_head_layers=0,
        )

    def _pack(self, graphs: Sequence[Graph]) -> list[tuple[list[int],
                                                           MegabatchPlan]]:
        """First-fit-decreasing pack ``graphs`` into bins of at most
        ``MAX_BIN_GRAPHS`` graphs and ``MAX_BIN_NODES`` nodes whose padded
        plan ``fits``; returns ``(indices, plan)`` per bin. Every bin
        remembers which input graphs it carries, so the embeddings land
        back in order."""
        order = sorted(range(len(graphs)),
                       key=lambda i: (-graphs[i].n_nodes,
                                      -graphs[i].n_edges, i))
        bins: list[list[int]] = []
        loads: list[list[int]] = []  # [node-sum, edge-sum]
        for i in order:
            g = graphs[i]
            for b, load in zip(bins, loads):
                if len(b) >= self.MAX_BIN_GRAPHS:
                    continue
                nn_, ne_ = load[0] + g.n_nodes, load[1] + g.n_edges
                if nn_ > self.MAX_BIN_NODES:
                    continue
                if self._plan(len(b) + 1, nn_, ne_).fits:
                    b.append(i)
                    load[0], load[1] = nn_, ne_
                    break
            else:
                bins.append([i])
                loads.append([g.n_nodes, g.n_edges])
        return [(b, self._plan(len(b), load[0], load[1]))
                for b, load in zip(bins, loads)]

    def _embed_batch(self, batch) -> np.ndarray:
        """One packed batch → pooled embeddings ``[max_graphs, out_dim]``
        through B4 (its plain version on the CPU)."""
        ids = np.stack([batch.node_feats[f"_ABS_DATAFLOW_{sk}"]
                        + i * self.input_dim
                        for i, sk in enumerate(ALL_SUBKEYS)], axis=-1)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        with torch.inference_mode():
            out = fused_ggnn_encoder(
                self._table, put(ids), put(batch.senders),
                put(batch.receivers), put(batch.node_gidx),
                put(batch.node_mask), *self._weights,
                n_steps=self.cfg.n_steps, n_graphs=batch.max_graphs)
            self.n_level1_dispatches += 1
            return out.cpu().numpy()

    def embed_graphs(self, graphs: Sequence[Graph]) -> np.ndarray:
        """Embed ``graphs`` through the packer and B4, without the cache:
        ``[len(graphs), out_dim]`` in input order."""
        out = np.zeros((len(graphs), self.out_dim), np.float32)
        for indices, plan in self._pack(graphs):
            batch = batch_np([graphs[i] for i in indices], plan.max_graphs,
                             plan.max_nodes, plan.max_edges)
            embs = self._embed_batch(batch)
            for slot, i in enumerate(indices):
                out[i] = embs[slot]
        return out

    def embed_functions(self, fns: Sequence[UnitFunction]) -> np.ndarray:
        """Cache-fronted level 1: consult the cache per function, pack and
        embed only the misses, commit them back. A warm cache makes this
        zero dispatches."""
        out = np.zeros((len(fns), self.out_dim), np.float32)
        misses: list[tuple[int, str | None]] = []
        for i, fn in enumerate(fns):
            if self.cache is not None:
                key = self.cache.key(fn.code)
                hit = self.cache.get(key)
                if hit is not None and hit.size == self.out_dim:
                    out[i] = hit
                    continue
                misses.append((i, key))
            else:
                misses.append((i, None))
        if misses:
            embs = self.embed_graphs([fns[i].graph for i, _ in misses])
            self.level1_recompute += len(misses)
            for (i, key), e in zip(misses, embs):
                out[i] = e
                if self.cache is not None and key is not None:
                    self.cache.put(key, e)
        return out

    # -- level 2: the unit score ---------------------------------------------

    def score_unit(self, fns: Sequence[UnitFunction], unit) -> dict:
        """Score one unit as one request: level-1 embeddings (cache-fronted,
        on B4) composed by the call-graph GGNN into a unit score and a
        per-function attribution. ``unit`` is the unit's
        :class:`~deepdfa_tpu_torch.cpg.interproc.Supergraph` (mapped onto
        ``fns`` by :func:`unit_graph` after level 1, as the JAX scorer
        does) or a :class:`UnitCallGraph` holding the call edges and
        summaries of ``fns``, in their order."""
        if not fns:
            raise ValueError("score_unit needs at least one function")
        n = len(fns)
        names = [fn.name for fn in fns]
        if isinstance(unit, UnitCallGraph):
            self._check_summaries(unit, n)
        t0 = time.perf_counter()
        embs = self.embed_functions(fns)
        t1 = time.perf_counter()
        if not isinstance(unit, UnitCallGraph):
            unit = unit_graph(unit, names)
        summaries = np.asarray(unit.summaries, np.float32)

        def put(a, dtype):
            return torch.from_numpy(np.asarray(a, dtype)).to(self.device)

        x = put(np.concatenate([embs, summaries], axis=-1), np.float32)
        with torch.inference_mode():
            unit_logit, fn_logit, gate = self.level2(
                x, put(unit.senders, np.int64), put(unit.receivers, np.int64),
                torch.ones(n, dtype=torch.bool, device=self.device))
            unit_p = float(torch.sigmoid(unit_logit))
            fn_p = torch.sigmoid(fn_logit).cpu().numpy()
            gate = gate.cpu().numpy()
        self.last_seconds = {"level1": t1 - t0,
                             "level2": time.perf_counter() - t1}
        attribution = sorted(
            ({"function": name, "weight": round(float(w), 6),
              "score": round(float(p), 6)}
             for name, w, p in zip(names, gate, fn_p)),
            key=lambda row: -row["weight"])
        return {
            "unit_score": round(unit_p, 6),
            "attribution": attribution,
            "n_functions": n,
            "call_edges": int(unit.n_call_edges),
            "level1": self.stats(),
        }

    @staticmethod
    def _check_summaries(unit: UnitCallGraph, n: int) -> None:
        shape = np.shape(unit.summaries)
        if shape != (n, N_SUMMARY_FEATURES):
            raise ValueError(f"unit summaries of shape {shape}, "
                             f"expected ({n}, {N_SUMMARY_FEATURES})")

    # -- accounting -----------------------------------------------------------

    def stats(self) -> dict:
        return {
            "dispatches": self.n_level1_dispatches,
            "fallback_dispatches": self.n_fallback_dispatches,
            "recompute": self.level1_recompute,
            "cache": self.cache.stats() if self.cache is not None else None,
        }

    def reset_counters(self) -> None:
        self.n_level1_dispatches = 0
        self.n_fallback_dispatches = 0
        self.level1_recompute = 0
