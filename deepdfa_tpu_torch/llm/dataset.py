"""Text batches and the graph join for the fusion head.

A copy of ``deepdfa_tpu/llm/dataset.py`` (host-side numpy, no
framework):

- :class:`HashTokenizer` — stable hashes of IVDetect subtokens into
  ``[n_special, vocab_size)``, bos 1 prepended, eos 2 as the pad; no vocab
  file, so it needs no download;
- :func:`_fit_block` — truncate or left-pad to ``block_size`` with an
  explicit pad mask (pads share the eos id, so values cannot tell them);
- :class:`TextExamples` / :class:`TextBatch`, :func:`encode_functions`
  (an HF tokenizer also works), :func:`devign_split` (the sequential
  80/10/10 split) and :func:`text_batches` (the tail batch is padded with
  masked rows, so every batch has one shape);
- :class:`GraphJoin` / :class:`JoinedBatch` — example ``i`` of a batch owns
  graph slot ``i`` of a ``batch_np`` batch (or, in the dense layout, of a
  ``batch_dense`` batch); a missing graph becomes an empty placeholder with
  ``mask=False``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import re
import threading
from typing import Iterator, NamedTuple, Sequence

import numpy as np

from deepdfa_tpu_torch.data.dense import (DenseBatch, batch_dense,
                                          derive_dense_size)
from deepdfa_tpu_torch.data.graphs import BatchedGraphs, Graph, batch_np
from deepdfa_tpu_torch.data.tokenise import tokenise

__all__ = ["GraphJoin", "HashTokenizer", "JoinedBatch", "TextBatch",
           "TextExamples", "devign_split", "encode_functions",
           "normalize_whitespace", "text_batches"]


def normalize_whitespace(code: str) -> str:
    """Strip each line, collapse runs of spaces/tabs, drop blank lines."""
    lines = [re.sub(r"[\t ]+", " ", ln.strip()) for ln in code.splitlines()
             if ln.strip()]
    return "\n".join(lines)


class HashTokenizer:
    """Hermetic subtoken tokenizer: ids are stable hashes of IVDetect
    subtokens into ``[n_special, vocab_size)``. Llama's special ids: bos=1
    prepended, eos=2 used as the pad."""

    def __init__(self, vocab_size: int = 320, bos_token_id: int = 1,
                 eos_token_id: int = 2):
        if vocab_size < 8:
            raise ValueError("vocab_size too small")
        self.vocab_size = vocab_size
        self.bos_token_id = bos_token_id
        self.eos_token_id = eos_token_id
        self._floor = max(bos_token_id, eos_token_id) + 1

    def _id(self, token: str) -> int:
        h = int(hashlib.sha1(token.encode()).hexdigest(), 16)
        return self._floor + h % (self.vocab_size - self._floor)

    def encode_raw(self, text: str) -> list[int]:
        """Bare token ids, no specials and no padding."""
        return [self._id(t) for t in tokenise(text).split()]

    def encode_block(self, text: str,
                     block_size: int) -> tuple[np.ndarray, np.ndarray]:
        ids = [self.bos_token_id] + self.encode_raw(text)
        return _fit_block(np.array(ids, np.int32), block_size,
                          self.eos_token_id)


def _fit_block(ids: np.ndarray, block_size: int, pad_id: int,
               pad_left: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """(ids, pad_mask): truncate or pad to ``block_size``; mask True = real
    token. Left padding is the framework's convention: the last position is
    the last real token."""
    n_real = min(ids.shape[0], block_size)
    ids = ids[:block_size]
    mask = np.ones(block_size, bool)
    if ids.shape[0] < block_size:
        pad = np.full(block_size - ids.shape[0], pad_id, np.int32)
        ids = np.concatenate([pad, ids] if pad_left else [ids, pad])
        if pad_left:
            mask[: block_size - n_real] = False
        else:
            mask[n_real:] = False
    return ids.astype(np.int32), mask


class TextExamples(NamedTuple):
    """Column-major example store."""

    input_ids: np.ndarray  # [n, block_size] int32
    labels: np.ndarray  # [n] int32
    indices: np.ndarray  # [n] int64 dataset ids (the graph-join key)
    pad_mask: np.ndarray  # [n, block_size] bool — True = real token

    def __len__(self) -> int:
        return int(self.input_ids.shape[0])


class TextBatch(NamedTuple):
    """Fixed-shape batch; ``mask`` rows are real examples."""

    input_ids: np.ndarray  # [b, block_size]
    labels: np.ndarray  # [b]
    indices: np.ndarray  # [b]
    mask: np.ndarray  # [b] bool
    pad_mask: np.ndarray  # [b, block_size] bool — True = real token


def encode_functions(funcs: Sequence[str], labels: Sequence[int], tokenizer,
                     block_size: int, indices: Sequence[int] | None = None,
                     normalize: bool = False) -> TextExamples:
    """Tokenize a table of functions to ``block_size``. ``tokenizer`` has
    ``encode_block`` (:class:`HashTokenizer`) or is an HF tokenizer, called
    with ``padding="max_length"``, truncation and left padding."""
    if indices is None:
        indices = np.arange(len(funcs))
    hf = not hasattr(tokenizer, "encode_block")
    if hf:  # force the left-pad convention for the call, then restore
        saved = (tokenizer.pad_token, tokenizer.padding_side)
        tokenizer.pad_token = tokenizer.pad_token or tokenizer.eos_token
        tokenizer.padding_side = "left"
    try:
        rows, masks = [], []
        for func in funcs:
            text = normalize_whitespace(str(func)) if normalize else str(func)
            if not hf:
                ids, mask = tokenizer.encode_block(text, block_size)
            else:
                out = tokenizer(text, padding="max_length", truncation=True,
                                max_length=block_size)
                ids = np.asarray(out["input_ids"], np.int32)
                mask = np.asarray(out["attention_mask"], bool)
            rows.append(ids)
            masks.append(mask)
    finally:
        if hf:
            tokenizer.pad_token, tokenizer.padding_side = saved
    return TextExamples(
        input_ids=np.stack(rows) if rows else np.zeros((0, block_size),
                                                       np.int32),
        labels=np.asarray(labels, np.int32),
        indices=np.asarray(indices, np.int64),
        pad_mask=np.stack(masks) if masks else np.zeros((0, block_size),
                                                        bool),
    )


def devign_split(n: int) -> dict[str, np.ndarray]:
    """Sequential 80/10/10 index split (the reference's
    ``train_test_split(shuffle=False)`` twice, ``train.py:102-115``)."""
    i80, i90 = int(n * 0.8), int(n * 0.8) + int(n * 0.2 * 0.5)
    idx = np.arange(n)
    return {"train": idx[:i80], "eval": idx[i80:i90], "test": idx[i90:]}


def text_batches(examples: TextExamples, batch_size: int,
                 shuffle: bool = False, seed: int = 0,
                 pad_id: int = 0) -> Iterator[TextBatch]:
    """Fixed-shape batches; the tail batch is padded with masked rows."""
    order = np.arange(len(examples))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    for start in range(0, len(order), batch_size):
        take = order[start: start + batch_size]
        b = take.shape[0]
        block = examples.input_ids.shape[1]
        ids = np.full((batch_size, block), pad_id, np.int32)
        labels = np.zeros(batch_size, np.int32)
        indices = np.full(batch_size, -1, np.int64)
        pad_mask = np.zeros((batch_size, block), bool)
        ids[:b] = examples.input_ids[take]
        labels[:b] = examples.labels[take]
        indices[:b] = examples.indices[take]
        pad_mask[:b] = examples.pad_mask[take]
        mask = np.arange(batch_size) < b
        yield TextBatch(ids, labels, indices, mask, pad_mask)


class JoinedBatch(NamedTuple):
    text: TextBatch
    # BatchedGraphs or DenseBatch (GraphJoin.layout); None without a GNN
    graphs: BatchedGraphs | DenseBatch | None
    # example is real AND its graph was found: what the loss sees
    mask: np.ndarray  # [b] bool


@dataclasses.dataclass
class GraphJoin:
    """Id-keyed graph lookup for fusion batches: example ``i`` of the batch
    owns graph slot ``i``; a miss becomes an empty graph with
    ``mask=False`` and counts in ``num_missing``.

    ``layout``: ``"segment"`` (flat :class:`BatchedGraphs` at the
    ``max_nodes``/``max_edges`` budget) or ``"dense"`` (a
    :class:`~deepdfa_tpu_torch.data.dense.DenseBatch` at one per-graph
    budget: the store's 99th-percentile size, capped by ``max_nodes``). In
    the dense layout a graph over the budget is treated as missing
    (``mask=False``) and counts in ``num_oversize``, so one outlier never
    grows every batch's ``n²`` adjacency. Must match the fusion model's
    ``GGNNConfig.layout``."""

    graphs: dict[int, Graph]
    max_nodes: int = 4096
    max_edges: int = 8192
    num_missing: int = 0
    num_oversize: int = 0
    layout: str = "segment"

    def __post_init__(self):
        if self.layout not in ("segment", "dense"):
            raise ValueError(f"unknown layout {self.layout!r} (segment | "
                             f"dense)")
        self._counter_lock = threading.Lock()
        self._npg: int | None = None

    def _placeholder(self) -> Graph:
        if not self.graphs:
            raise ValueError(
                "GraphJoin has an empty graph store — no graphs were loaded; "
                "cannot build the placeholder's feature schema")
        any_g = next(iter(self.graphs.values()))
        feats = {k: np.zeros((0,) + v.shape[1:], v.dtype)
                 for k, v in any_g.node_feats.items()}
        return Graph(senders=np.zeros(0, np.int32),
                     receivers=np.zeros(0, np.int32), node_feats=feats,
                     gid=-1)

    def join(self, batch: TextBatch) -> JoinedBatch:
        picked: list[Graph] = []
        found = np.zeros(batch.indices.shape[0], bool)
        placeholder = self._placeholder()
        n_missing = 0
        for i, idx in enumerate(batch.indices):
            g = self.graphs.get(int(idx)) if batch.mask[i] else None
            if g is not None:
                picked.append(g)
                found[i] = True
            else:
                picked.append(placeholder)
                if batch.mask[i]:
                    n_missing += 1
        if self.layout == "dense":
            npg = self._dense_npg()
            n_oversize = 0
            for i, g in enumerate(picked):
                if g.n_nodes > npg:
                    picked[i] = placeholder
                    found[i] = False
                    n_oversize += 1
            with self._counter_lock:
                self.num_oversize += n_oversize
            graphs = batch_dense(picked, len(picked), npg)
        else:
            graphs = batch_np(picked, len(picked) + 1, self.max_nodes,
                              self.max_edges)
        with self._counter_lock:
            self.num_missing += n_missing
        return JoinedBatch(text=batch, graphs=graphs, mask=batch.mask & found)

    def _dense_npg(self) -> int:
        """The dense per-graph budget, derived once from the store."""
        if self._npg is None:
            npg = derive_dense_size(list(self.graphs.values()), quantile=0.99)
            self._npg = min(npg, max(self.max_nodes, 8))
        return self._npg
