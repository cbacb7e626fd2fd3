"""Train-split abstract-dataflow vocabularies and node-feature encoding.

A copy of ``deepdfa_tpu/data/vocab.py`` without pandas. The vocabularies
come out dict for dict the JAX package's, ids included:

- per-subkey vocabularies are frequency-ranked over train-split
  definitions only, with a ``limit_subkeys`` cutoff; index 0 is reserved;
- the combined vocabulary re-hashes each definition with out-of-vocab
  subkey values replaced by ``"UNKNOWN"`` (unless ``include_unknown``),
  then ranks the combined JSON hashes with a ``limit_all`` cutoff;
- node feature ids: ``0`` = not a definition, ``1`` = definition with an
  out-of-vocab hash (UNKNOWN), ``2..`` = known hashes — hence
  ``input_dim = limit_all + 2``.

Ranking (:func:`_rank`) reproduces pandas' ``value_counts``: counts
descending, ties in order of first occurrence (pandas sorts the counts
with a stable sort over the first-occurrence order of its hash table).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterable, Mapping

from deepdfa_tpu_torch.config import SINGLE_SUBKEYS, FeatureConfig

__all__ = ["Vocabulary", "build_vocab", "encode_nodes", "encode_dfa_nodes",
           "UNKNOWN"]

UNKNOWN = "UNKNOWN"


def _hash_values(hash_dict: Mapping[str, list], subkey: str) -> list[str]:
    """The (deduped, sorted) subkey values of one definition hash; datatype
    is single-valued."""
    values = [str(v) for v in hash_dict.get(subkey, [])]
    if SINGLE_SUBKEYS.get(subkey, False):
        return values[:1]
    return sorted(set(values))


@dataclasses.dataclass(frozen=True)
class Vocabulary:
    """Subkey vocabs + the combined vocab for one :class:`FeatureConfig`."""

    cfg: FeatureConfig
    subkey_vocabs: dict[str, dict[str, int]]
    all_vocab: dict[str | None, int]

    def combined_hash(self, hash_dict: Mapping[str, list]) -> str:
        """Canonical combined hash with UNKNOWN substitution."""
        out = {}
        for sk in sorted(self.cfg.subkeys):
            values = _hash_values(hash_dict, sk)
            if not self.cfg.include_unknown:
                vocab = self.subkey_vocabs[sk]
                values = [v if v in vocab else UNKNOWN for v in values]
            out[sk] = sorted(set(values))
        return json.dumps(out)

    def feature_id(self, hash_json: str | None) -> int:
        """Node feature id: 0 not-a-def, 1 UNKNOWN, 2.. known."""
        if hash_json is None:
            return 0
        return self.feature_id_from_dict(json.loads(hash_json))

    def feature_id_from_dict(self, hash_dict: Mapping[str, list]) -> int:
        """:meth:`feature_id` for an already-parsed hash."""
        combined = self.combined_hash(hash_dict)
        return self.all_vocab.get(combined, 0) + 1

    @property
    def input_dim(self) -> int:
        return self.cfg.input_dim

    def to_dict(self) -> dict:
        """Full JSON-serialisable form (``cfg``, ``subkey_vocabs``,
        ``all_vocab``): what a shard dir's ``vocab.json`` holds per name."""
        return {
            "cfg": dataclasses.asdict(self.cfg),
            "subkey_vocabs": self.subkey_vocabs,
            "all_vocab": self.all_vocab,
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "Vocabulary":
        cfg_d = dict(d["cfg"])
        cfg_d["subkeys"] = tuple(cfg_d["subkeys"])
        return cls(
            cfg=FeatureConfig(**cfg_d),
            subkey_vocabs={k: dict(v) for k, v in d["subkey_vocabs"].items()},
            all_vocab={k: int(v) for k, v in d["all_vocab"].items()},
        )


def _rank(values: Iterable, limit: int | None) -> dict:
    """``{value: rank}`` from 1, most frequent first, ties in order of first
    occurrence; only the ``limit`` most frequent when ``limit`` is set."""
    counts: dict = {}
    for v in values:
        counts[v] = counts.get(v, 0) + 1
    ordered = sorted(counts, key=lambda v: -counts[v])  # stable: ties keep order
    if limit is not None:
        ordered = ordered[:limit]
    return {v: i + 1 for i, v in enumerate(ordered)}


def build_vocab(
    hash_rows: Iterable[Mapping], train_ids: Iterable[int], cfg: FeatureConfig
) -> Vocabulary:
    """Build vocabularies from stage-2 hashes.

    ``hash_rows``: rows with ``graph_id``, ``node_id`` and ``hash`` (JSON;
    a row may carry the parsed ``hash_dict`` instead), as
    :func:`~deepdfa_tpu_torch.cpg.features.features_to_hashes` gives them.
    Ranking uses only rows whose ``graph_id`` is in ``train_ids``.
    """
    train_ids = set(int(i) for i in train_ids)
    train = [r["hash_dict"] if "hash_dict" in r else json.loads(r["hash"])
             for r in hash_rows if int(r["graph_id"]) in train_ids]

    subkey_vocabs: dict[str, dict[str, int]] = {}
    for sk in cfg.subkeys:
        exploded = (v for h in train for v in _hash_values(h, sk))
        subkey_vocabs[sk] = _rank(exploded, cfg.limit_subkeys)

    vocab = Vocabulary(cfg=cfg, subkey_vocabs=subkey_vocabs, all_vocab={})
    all_vocab = _rank((vocab.combined_hash(h) for h in train), cfg.limit_all)
    return dataclasses.replace(vocab, all_vocab=all_vocab)


def encode_nodes(
    node_ids: Iterable[int],
    graph_hashes: Mapping[int, str],
    vocab: Vocabulary,
) -> list[int]:
    """Feature ids for one graph's nodes. ``graph_hashes`` maps node_id →
    stage-2 hash JSON for that graph's definitions; non-definition nodes
    get 0."""
    return [vocab.feature_id(graph_hashes.get(int(n))) for n in node_ids]


def encode_dfa_nodes(
    node_ids: Iterable[int], family_values: Mapping[int, int], family: str
) -> list[int]:
    """Feature ids for one static-analysis family: the raw value clipped
    into the family's embedding-table range (``DFA_FEATURE_DIMS``); nodes
    the analysis didn't touch get 0."""
    from deepdfa_tpu_torch.config import DFA_FEATURE_DIMS

    dim = DFA_FEATURE_DIMS[family]
    return [min(max(int(family_values.get(int(n), 0)), 0), dim - 1) for n in node_ids]
