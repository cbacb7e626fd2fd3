"""CPG → model-ready graphs (the "dbize" stage).

A copy of ``deepdfa_tpu/data/materialize.py`` without pandas:

- node/edge selection (:func:`select_cfg_nodes`): keep nodes with a line
  number, restrict edges to the CFG subgraph, drop lone nodes, renumber to
  0..n-1;
- graph construction (:func:`graph_from_cpg`): the reference builds
  ``dgl.graph((innode, outnode))``, i.e. message passing runs against CPG
  edge direction, so ``Graph(senders=innode, receivers=outnode)``, and a
  self-loop per node is appended;
- the corpus vocabulary's two halves (:func:`corpus_hashes`,
  :func:`corpus_vocabs`): ``CorpusBuilder.extract`` and
  ``CorpusBuilder.vocabs`` of the JAX package, row for row and dict for
  dict. ``CorpusBuilder`` itself (label materialisation, the feature
  families, shard emission) waits for the ingest slice.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping

import numpy as np

from deepdfa_tpu_torch.config import ALL_SUBKEYS, FeatureConfig
from deepdfa_tpu_torch.cpg.schema import CPG, rdg
from deepdfa_tpu_torch.data.graphs import Graph
from deepdfa_tpu_torch.data.vocab import Vocabulary, build_vocab

__all__ = ["select_cfg_nodes", "graph_from_cpg", "corpus_hashes",
           "corpus_vocabs"]


def select_cfg_nodes(
    cpg: CPG, gtype: str = "cfg"
) -> tuple[list[int], list[tuple[int, int]]]:
    """(ordered node ids, edge list) after the reference's selection: nodes
    need a line number, edges are the deduped ``gtype`` subgraph
    (``rdg``, golden config = cfg) between kept nodes, lone nodes dropped."""
    with_line = [i for i, n in cpg.nodes.items() if n.line is not None]
    keep = set(with_line)
    edges = [(s, d) for s, d in rdg(cpg, gtype) if s in keep and d in keep]
    connected = {s for s, _ in edges} | {d for _, d in edges}
    nodes = [i for i in with_line if i in connected]
    return nodes, edges


def graph_from_cpg(
    cpg: CPG,
    gid: int,
    feat_ids: Mapping[str, Mapping[int, int]],
    vuln_lines: set[int] | None = None,
    graph_label: int | None = None,
    gtype: str = "cfg",
    dataflow_labels: bool = False,
    selection: tuple[list, list] | None = None,
) -> Graph | None:
    """Build one graph. ``feat_ids`` maps feature name → {node_id: int id}.
    Exactly one of ``vuln_lines`` (per-line labels) / ``graph_label``
    (broadcast) must be given.

    ``selection``: a precomputed ``select_cfg_nodes(cpg, gtype)`` result,
    so the node order used for features and the one a caller maps back to
    source lines are the same object.

    Returns None when no graph structure survives selection.
    """
    nodes, edges = selection if selection is not None else select_cfg_nodes(cpg, gtype)
    if not nodes:
        return None
    pos = {nid: i for i, nid in enumerate(nodes)}
    # reference direction: dgl.graph((innode, outnode)) — message source is
    # the CPG edge's destination (innode).
    senders = np.array([pos[d] for _, d in edges], dtype=np.int32)
    receivers = np.array([pos[s] for s, _ in edges], dtype=np.int32)

    if (vuln_lines is None) == (graph_label is None):
        raise ValueError("exactly one of vuln_lines/graph_label required")
    if vuln_lines is not None:
        vuln = np.array(
            [1 if cpg.nodes[n].line in vuln_lines else 0 for n in nodes],
            dtype=np.int32,
        )
    else:
        vuln = np.full(len(nodes), int(graph_label), dtype=np.int32)

    feats: dict[str, np.ndarray] = {"_VULN": vuln}
    for name, ids in feat_ids.items():
        feats[name] = np.array([ids.get(n, 0) for n in nodes], dtype=np.int32)

    if dataflow_labels:
        # 1 iff the node's reaching-definitions IN (OUT) set is non-empty;
        # ``add_dependence_edges`` caches its fixpoint on the CPG
        cached = getattr(cpg, "rd_solution", None)
        if cached is not None:
            in_sets, out_sets = cached
        else:
            from deepdfa_tpu_torch.cpg.dataflow import ReachingDefinitions

            in_sets, out_sets = ReachingDefinitions(cpg).solve()
        feats["_DF_IN"] = np.array(
            [1 if in_sets.get(n) else 0 for n in nodes], dtype=np.int32
        )
        feats["_DF_OUT"] = np.array(
            [1 if out_sets.get(n) else 0 for n in nodes], dtype=np.int32
        )

    g = Graph(senders=senders, receivers=receivers, node_feats=feats, gid=gid)
    return g.with_self_loops()


def corpus_hashes(cpgs: Mapping[int, CPG], subkeys: Iterable[str],
                  raise_all: bool = False) -> list[dict]:
    """Stage 1+2 over a corpus ``{graph id: CPG}``: the per-definition hash
    rows of every graph, sorted by ``(graph_id, node_id)``."""
    from deepdfa_tpu_torch.cpg.features import (extract_features,
                                                features_to_hashes)

    rows = []
    for gid, cpg in cpgs.items():
        rows.extend(extract_features(cpg, gid, raise_all=raise_all))
    return features_to_hashes(rows, subkeys)


def corpus_vocabs(hash_rows: list[dict], train_ids: Iterable[int],
                  feature: FeatureConfig = FeatureConfig(),
                  concat_all_absdf: bool = True) -> dict[str, Vocabulary]:
    """The combined vocab (``_ABS_DATAFLOW``) plus, with
    ``concat_all_absdf``, one single-subkey vocab per subkey
    (``_ABS_DATAFLOW_{subkey}``), each with the same limits."""
    train_ids = list(train_ids)
    out = {"_ABS_DATAFLOW": build_vocab(hash_rows, train_ids, feature)}
    if concat_all_absdf:
        for sk in ALL_SUBKEYS:
            cfg = dataclasses.replace(feature, subkeys=(sk,))
            out[f"_ABS_DATAFLOW_{sk}"] = build_vocab(hash_rows, train_ids, cfg)
    return out
