"""Tier-2 scoring engine: the joint LLM+GNN model, packaged for serving.

The port of ``deepdfa_tpu/llm/joint_engine.py``. The cascade escalates
tier-1 borderline scores here; :meth:`JointEngine.score` is the whole
contract:

- input: ``[(source_text, Graph), ...]`` — the request's raw source (the LLM
  branch tokenizes it) paired with its encoded graph (the GGNN branch;
  ``None`` with ``use_gnn=False``);
- output: ``P(vulnerable)`` per item, computed by the same
  :func:`~deepdfa_tpu_torch.llm.joint.eval_step` the trainer evaluates with;
- fixed shapes: every chunk pads to ``max_batch`` text rows and a fixed
  ``(max_nodes, max_edges)`` graph budget.

On the card the LLM's attention runs on kernel B6 with
``attn_impl="flash"`` and its projections on kernel B5 with
``int8_runtime=True``; with ``gnn_cfg.layout="fused"`` the GGNN's rounds run
on kernel B1.

:meth:`JointEngine.from_run_dir` restores the newest ``epoch_N`` fusion
checkpoint of a run directory (:func:`~deepdfa_tpu_torch.llm.joint.
save_fusion_epoch`'s format) over either the hermetic LLM (``tiny_llama`` +
:class:`~deepdfa_tpu_torch.llm.dataset.HashTokenizer`, with weights drawn
from ``seed`` — not the JAX package's draw — or given as ``llm_state``) or
an HF checkpoint directory (``hf_checkpoint=``, read locally). With
``mesh=`` the LLM is sharded over it (:mod:`deepdfa_tpu_torch.llm.llama`:
each rank holds its shard, the forward runs with explicit collectives and
every rank gets the whole hidden states), while the fusion head and the
GGNN stay whole on every rank (B1 on the card): every rank scores the same
probabilities.
"""

from __future__ import annotations

import re
import threading
from pathlib import Path
from typing import Any, Sequence

import numpy as np

from deepdfa_tpu_torch import resolve_device
from deepdfa_tpu_torch.config import ALL_SUBKEYS, FeatureConfig, GGNNConfig
from deepdfa_tpu_torch.data.graphs import Graph
from deepdfa_tpu_torch.llm.dataset import (GraphJoin, HashTokenizer,
                                           JoinedBatch, encode_functions,
                                           text_batches)
from deepdfa_tpu_torch.llm.joint import (JointConfig, eval_step,
                                         load_fusion_epoch)
from deepdfa_tpu_torch.serve.engine import model_revision

__all__ = ["JointEngine", "newest_epoch_dir"]

_EPOCH = re.compile(r"epoch_(\d+)")


def _placeholder_graph(n_nodes: int = 1) -> Graph:
    """A minimal graph carrying the full feature schema real extractions
    emit (``_ABS_DATAFLOW`` combined-vocab + one column per subkey)."""
    feats = {f"_ABS_DATAFLOW_{sk}": np.zeros(n_nodes, np.int32)
             for sk in ALL_SUBKEYS}
    feats["_ABS_DATAFLOW"] = np.zeros(n_nodes, np.int32)
    return Graph(senders=np.zeros(0, np.int32),
                 receivers=np.zeros(0, np.int32), node_feats=feats, gid=0)


def newest_epoch_dir(run_dir: str | Path) -> Path | None:
    """The newest ``epoch_N`` directory under a run directory (numeric
    order: ``epoch_10`` beats ``epoch_9``), or None."""
    epochs = [p for p in Path(run_dir).glob("epoch_*")
              if p.is_dir() and _EPOCH.fullmatch(p.name)]
    if not epochs:
        return None
    return max(epochs, key=lambda p: int(_EPOCH.fullmatch(p.name).group(1)))


class JointEngine:
    """Joint-model rescorer over a fusion model and a frozen LLM.

    ``llm`` and ``fusion`` are modules already holding their weights; both
    move to ``device`` (``cuda`` unless the caller names another). Thread-
    safe: ``score`` serialises on one lock."""

    def __init__(self, llm, fusion, tokenizer, jcfg: JointConfig | None = None,
                 *, max_batch: int = 4, max_nodes: int = 4096,
                 max_edges: int = 8192, device=None):
        self.device = resolve_device(device)
        self.llm = llm.to(self.device).eval()
        self.fusion = fusion.to(self.device).eval()
        self.tokenizer = tokenizer
        self.cfg = jcfg or JointConfig()
        self.max_batch = int(max_batch)
        self.max_nodes = int(max_nodes)
        self.max_edges = int(max_edges)
        # the tier-1 engine's revision scheme over the trained (fusion) tree
        self.model_rev = model_revision(self.fusion.state_dict(), self.device)
        self.n_batches = 0
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ build

    @classmethod
    def from_run_dir(cls, run_dir: str | Path, *,
                     jcfg: JointConfig | None = None,
                     gnn_cfg: GGNNConfig | None = None,
                     input_dim: int | None = None, vocab_size: int = 2048,
                     use_gnn: bool = True, max_batch: int = 4,
                     max_nodes: int = 4096, max_edges: int = 8192,
                     hf_checkpoint: str | None = None,
                     llm_state: dict | None = None, llm_cfg=None, mesh=None,
                     device=None, seed: int = 0) -> "JointEngine":
        """Restore the newest ``epoch_N`` fusion checkpoint of ``run_dir``.

        Hermetic by default: ``tiny_llama(vocab_size)`` (or ``llm_cfg``, a
        :class:`~deepdfa_tpu_torch.llm.llama.LlamaConfig`) +
        :class:`HashTokenizer`, its weights ``llm_state`` when given (for
        example the JAX package's, through ``bridge.llama_flax_to_torch``),
        else drawn from ``seed``. ``hf_checkpoint`` switches to an HF
        CodeLlama directory (config, weights and tokenizer read locally).
        ``mesh`` (a :class:`~deepdfa_tpu_torch.parallel.mesh.Mesh` over a
        process group) shards the LLM, which every rank of it must build
        alike; ``device`` then defaults to the mesh's device for this rank.
        An orbax directory raises ``ValueError`` (see
        :func:`~deepdfa_tpu_torch.llm.joint.load_fusion_epoch`)."""
        from deepdfa_tpu_torch.llm.fusion import build_fusion
        from deepdfa_tpu_torch.llm.llama import (build_llama, shard_state,
                                                 tiny_llama)

        jcfg = jcfg or JointConfig()
        newest = newest_epoch_dir(run_dir)
        if newest is None:
            raise FileNotFoundError(
                f"no epoch_* fusion checkpoint under {run_dir}")
        fusion_state = load_fusion_epoch(newest)
        dev = resolve_device(mesh.device if device is None and
                             mesh is not None else device)
        if hf_checkpoint is not None:
            from transformers import AutoTokenizer

            from deepdfa_tpu_torch.llm.convert import (load_hf_checkpoint,
                                                       load_hf_config)

            llm_cfg = load_hf_config(hf_checkpoint)
            tokenizer = AutoTokenizer.from_pretrained(hf_checkpoint,
                                                      local_files_only=True)
            llm_state = load_hf_checkpoint(hf_checkpoint, bare=True)
        else:
            llm_cfg = llm_cfg or tiny_llama(vocab_size=vocab_size)
            tokenizer = HashTokenizer(vocab_size=llm_cfg.vocab_size)
        llm = build_llama(llm_cfg, dev, seed=None if llm_state else seed,
                          mesh=mesh)
        if llm_state is not None:
            llm.load_state_dict(llm_state if mesh is None
                                else shard_state(llm_state, mesh))
        fusion = build_fusion(
            gnn_cfg or GGNNConfig(),
            input_dim if input_dim is not None else FeatureConfig().input_dim,
            llm_cfg.hidden_size, use_gnn=use_gnn, dropout_rate=0.1,
            pool="last", device=dev)
        fusion.load_state_dict(fusion_state)
        return cls(llm, fusion, tokenizer, jcfg, max_batch=max_batch,
                   max_nodes=max_nodes, max_edges=max_edges, device=dev)

    # ------------------------------------------------------------------ score

    def score(self, items: Sequence[tuple[str, Any]]) -> np.ndarray:
        """``P(vulnerable)`` per ``(source_text, graph)`` item, in chunks of
        ``max_batch``."""
        out = np.zeros(len(items), np.float64)
        with self._lock:
            for start in range(0, len(items), self.max_batch):
                chunk = items[start: start + self.max_batch]
                out[start: start + len(chunk)] = self._score_chunk(chunk)
        return out

    def _score_chunk(self, chunk: Sequence[tuple[str, Any]]) -> np.ndarray:
        n = len(chunk)
        examples = encode_functions([text for text, _ in chunk], [0] * n,
                                    self.tokenizer, self.cfg.block_size)
        tb = next(text_batches(examples, self.max_batch))
        if self.fusion.use_gnn:
            join = GraphJoin(
                graphs={i: g for i, (_, g) in enumerate(chunk)
                        if g is not None},
                max_nodes=self.max_nodes, max_edges=self.max_edges)
            jb = join.join(tb)
        else:
            jb = JoinedBatch(text=tb, graphs=None, mask=tb.mask)
        _loss, probs = eval_step(self.llm, self.fusion, jb, self.device)
        self.n_batches += 1
        return probs[:n, 1].to("cpu").double().numpy()

    # ----------------------------------------------------------------- warmup

    def warmup(self) -> dict:
        """Score one placeholder item, so the first request pays no kernel
        build."""
        g = _placeholder_graph() if self.fusion.use_gnn else None
        self.score([("int main() { return 0; }", g)])
        return {"max_batch": self.max_batch, "model_rev": self.model_rev}

    def describe(self) -> dict:
        return {"model_rev": self.model_rev, "max_batch": self.max_batch,
                "block_size": self.cfg.block_size,
                "use_gnn": bool(self.fusion.use_gnn)}
