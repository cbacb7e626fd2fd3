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
  :func:`corpus_vocabs`), row for row and dict for dict the JAX package's;
- :class:`CorpusBuilder`: extraction → train-split vocabularies →
  per-node encoding (with the static-analysis and interprocedural
  families when the feature config asks for them) → labeled graphs, the
  JAX package's graphs bit for bit. ``data/graphs.py``'s ``save_shards``
  writes them.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping

import numpy as np

from deepdfa_tpu_torch.config import (ALL_SUBKEYS, DFA_FEATURE_DIMS,
                                      FeatureConfig)
from deepdfa_tpu_torch.cpg.schema import CPG, rdg
from deepdfa_tpu_torch.data.graphs import Graph
from deepdfa_tpu_torch.data.vocab import Vocabulary, build_vocab

__all__ = ["select_cfg_nodes", "graph_from_cpg", "corpus_hashes",
           "corpus_vocabs", "CorpusBuilder"]


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


def _clipped(values: Mapping[int, int], fam: str) -> dict[int, int]:
    """A family's raw per-node values clipped into its fixed embedding
    table (``config.DFA_FEATURE_DIMS``)."""
    dim = DFA_FEATURE_DIMS[fam]
    return {n: min(max(int(v), 0), dim - 1) for n, v in values.items()}


@dataclasses.dataclass
class CorpusBuilder:
    """The feature pipeline over an in-memory corpus ``{graph id: CPG}``:
    stage-1/2 extraction → train-split vocabularies → per-node encoding →
    graphs. One instance per :class:`FeatureConfig`. After :meth:`build`,
    ``hash_rows`` holds the stage-2 rows (the coverage table
    ``hashes.csv.gz``)."""

    feature: FeatureConfig = dataclasses.field(default_factory=FeatureConfig)
    concat_all_absdf: bool = True
    hash_rows: list[dict] = dataclasses.field(default_factory=list, repr=False)

    def extract(self, cpgs: Mapping[int, CPG], raise_all: bool = False) -> list[dict]:
        """Stage 1+2: per-definition hash rows for the whole corpus."""
        return corpus_hashes(cpgs, self.feature.subkeys, raise_all=raise_all)

    def vocabs(self, hash_rows: list[dict],
               train_ids: Iterable[int]) -> dict[str, Vocabulary]:
        """The combined vocabulary plus one per subkey when
        ``concat_all_absdf``."""
        return corpus_vocabs(hash_rows, train_ids, self.feature,
                             self.concat_all_absdf)

    def build(
        self,
        cpgs: Mapping[int, CPG],
        train_ids: Iterable[int],
        vuln_lines: Mapping[int, set[int]] | None = None,
        graph_labels: Mapping[int, int] | None = None,
        raise_all: bool = False,
        dataflow_labels: bool = False,
    ) -> tuple[list[Graph], dict[str, Vocabulary]]:
        """The whole pipeline; returns (graphs, vocabs). Graphs with no CFG
        are dropped."""
        self.hash_rows = self.extract(cpgs, raise_all=raise_all)
        vocabs = self.vocabs(self.hash_rows, train_ids)
        by_graph: dict[int, dict[int, str]] = {}
        for row in self.hash_rows:
            by_graph.setdefault(int(row["graph_id"]), {})[int(row["node_id"])] = row["hash"]

        graphs: list[Graph] = []
        for gid, cpg in cpgs.items():
            hashes = by_graph.get(int(gid), {})
            feat_ids = {
                name: {n: voc.feature_id(h) for n, h in hashes.items()}
                for name, voc in vocabs.items()
            }
            if self.feature.dataflow_families:
                from deepdfa_tpu_torch.cpg.features import dataflow_node_features

                for fam, values in dataflow_node_features(cpg).items():
                    feat_ids[f"_DFA_{fam}"] = _clipped(values, fam)
            if self.feature.interproc_families:
                # per graph: a corpus graph is one parse unit, so the
                # supergraph spans that unit only
                from deepdfa_tpu_torch.cpg.interproc import interproc_node_features

                for fam, values in interproc_node_features(cpg).items():
                    feat_ids[f"_DFA_{fam}"] = _clipped(values, fam)
            g = graph_from_cpg(
                cpg,
                gid,
                feat_ids,
                vuln_lines=set(vuln_lines[gid]) if vuln_lines is not None else None,
                graph_label=graph_labels[gid] if graph_labels is not None else None,
                dataflow_labels=dataflow_labels,
            )
            if g is not None:
                graphs.append(g)
        return graphs, vocabs
