"""Score raw C source with a trained GGNN: per-function vulnerability
probabilities and ranked suspicious statements.

The port of ``deepdfa_tpu/predict.py``. The C front end, the
abstract-dataflow features encoded with the TRAINING vocabulary (never one
rebuilt from the code being scored) and the model compose into one call:
:func:`predict_paths` over files and directories, :func:`predict_source`
over one source text.

Statement ranking for graph-label models: by default **occlusion
saliency** (:func:`occlusion_saliency`: the drop in the function's
probability when one statement's dataflow features are masked), 16 masked
copies to one padded batch and one scorer call per batch; ``saliency=
"gate"`` ranks by the readout's attention weights, one forward per
function. Node-label models (``label_style="node"``) score a function as
the largest probability of its real nodes and rank statements by those
node probabilities (``saliency`` ``"node_probability"``); a
dataflow-solution model predicts solver bits, not vulnerability, and is
refused.

The scorer runs on the model's device: on the card the fused layout's
message rounds are kernel B1 for every forward, the occlusion batches
included, and a batch the kernel refuses raises.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Sequence

import numpy as np
import torch

from deepdfa_tpu_torch.data.graphs import _round_up, batch_np, to_device
from deepdfa_tpu_torch.ops.segment import segment_max
from deepdfa_tpu_torch.pipeline import encode_source, load_vocabs

__all__ = ["Scorer", "load_vocabs", "make_scorer", "occlusion_saliency",
           "predict_source", "predict_paths", "collect_sources"]


def make_scorer(model, label_style: str) -> Callable:
    """``batch -> (fn_prob[max_graphs], node_saliency[max_nodes])`` over a
    batch of tensors on the model's device, under
    ``torch.inference_mode()``: the pooling's gate weights for a graph-label
    model; for a node-label model the node probabilities, and as the
    function's probability the largest over its real nodes (0 for a slot
    with none, as ``serve.engine``'s artifact path gives). Unsupported
    models fail here with a clear message."""
    cfg = getattr(model, "cfg", None)
    if cfg is not None and cfg.encoder_mode:
        raise ValueError(
            "predict needs a classifier head; encoder_mode models return "
            "pooled embeddings")
    if cfg is not None and cfg.layout == "megabatch":
        raise ValueError(
            "a layout='megabatch' model computes no per-node gate weights, "
            "which scoring reports; serve its state dict with "
            "layout='fused' (the same parameters and logits)")
    if label_style == "node":
        def score_nodes(batch):
            with torch.inference_mode():
                node_p = torch.sigmoid(model(batch))
                masked = torch.where(batch.node_mask, node_p,
                                     torch.full_like(node_p, float("-inf")))
                fn_p = segment_max(masked, batch.node_gidx,
                                   batch.max_graphs)
                return torch.clamp_min(fn_p, 0.0), node_p

        return score_nodes
    if label_style != "graph":
        raise ValueError(
            f"predict supports label_style 'graph' or 'node', not "
            f"{label_style!r} (dataflow-solution checkpoints score RD bits, "
            "not vulnerability)")

    def score(batch):
        with torch.inference_mode():
            logits, gate = model(batch, return_gate=True)
            return torch.sigmoid(logits), gate

    return score


class Scorer:
    """:func:`make_scorer` over host-side padded batches: moves each batch
    to the model's device and returns ``(fn_prob, node_saliency)`` as
    float32 numpy arrays. ``n_calls`` counts the forwards."""

    def __init__(self, model, label_style: str = "graph"):
        self._score = make_scorer(model, label_style)
        self.device = next(model.parameters()).device
        self.n_calls = 0

    def __call__(self, batch) -> tuple[np.ndarray, np.ndarray]:
        probs, sal = self._score(to_device(batch, self.device))
        self.n_calls += 1
        return probs.float().cpu().numpy(), sal.float().cpu().numpy()


def _single_batch(g):
    """One function in its own padded batch (budgets rounded up, so similar
    sizes share a shape)."""
    return batch_np([g], 2, _round_up(g.n_nodes + 2),
                    max(_round_up(g.n_edges), 128))


def occlusion_saliency(scorer, g, n_real: int, chunk: int = 16,
                       full_p: float | None = None) -> np.ndarray:
    """Per-node evidence contribution: the drop in the function's
    probability when that node's abstract-dataflow features are masked to
    not-a-definition (id 0).

    One scorer call per ``chunk`` masked copies: the copies ride one padded
    batch, and the tail chunk is padded with unmasked copies, so every
    chunk of a function shares one shape."""
    if full_p is None:
        fp, _ = scorer(_single_batch(g))
        full_p = float(fp[0])

    sal = np.zeros(n_real, np.float32)
    abs_keys = [k for k in g.node_feats if k.startswith("_ABS_DATAFLOW")]
    for start in range(0, n_real, chunk):
        idxs = list(range(start, min(start + chunk, n_real)))
        copies = []
        for i in idxs:
            nf = {k: (v.copy() if k in abs_keys else v)
                  for k, v in g.node_feats.items()}
            for k in abs_keys:
                nf[k][i] = 0
            copies.append(dataclasses.replace(g, node_feats=nf))
        copies += [g] * (chunk - len(idxs))  # shape-stable tail padding
        mb = batch_np(
            copies, chunk + 1, _round_up(chunk * g.n_nodes + 2),
            max(_round_up(chunk * g.n_edges), 128),
        )
        probs, _ = scorer(mb)
        for j, i in enumerate(idxs):
            sal[i] = full_p - probs[j]
    return sal


def predict_source(
    code: str,
    *,
    scorer,
    vocabs: dict,
    top_k: int = 5,
    name: str = "<source>",
    saliency: str = "occlusion",
    label_style: str = "graph",
) -> list[dict]:
    """Score every function in ``code``; one result dict per function
    (``function``, ``file``, ``vulnerable_probability``, ``saliency``,
    ``top_statements`` of ``line``/``code``/``weight``), or an ``error``
    row for a function with no CFG.

    ``saliency`` (graph-label models): ``"occlusion"`` (default) or
    ``"gate"``. Node-label models always rank by the node probabilities."""
    if saliency not in ("occlusion", "gate"):
        raise ValueError(f"saliency must be 'occlusion' or 'gate', "
                         f"not {saliency!r}")
    results = []
    for enc in encode_source(code, vocabs):
        fname, g, node_ids, cpg = enc.name, enc.graph, enc.node_ids, enc.cpg
        if g is None:
            results.append({"function": fname, "file": name,
                            "error": enc.error})
            continue
        fn_p, node_sal = scorer(_single_batch(g))
        prob = float(fn_p[0])
        used = saliency
        if label_style == "node":
            used = "node_probability"
            sal = node_sal[: len(node_ids)]
        elif saliency == "occlusion":
            sal = occlusion_saliency(scorer, g, len(node_ids), full_p=prob)
        else:
            sal = node_sal[: len(node_ids)]
        order = np.argsort(-sal)[: max(top_k, 0)]
        statements = [
            {
                "line": cpg.nodes[node_ids[i]].line,
                "code": cpg.nodes[node_ids[i]].code,
                "weight": round(float(sal[i]), 6),
            }
            for i in order
        ]
        results.append({
            "function": fname,
            "file": name,
            "vulnerable_probability": round(prob, 6),
            "saliency": used,
            "top_statements": statements,
        })
    return results


def collect_sources(paths: Sequence[str | Path]) -> list[tuple[str, str]]:
    """(display name, source text) for each file; directories recurse over
    ``*.c`` only, an explicit file path of any extension is honored.
    Missing paths raise."""
    out: list[tuple[str, str]] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            files = sorted(p.rglob("*.c"))
        elif p.exists():
            files = [p]
        else:
            raise FileNotFoundError(p)
        out.extend((str(f), f.read_text(errors="replace")) for f in files)
    return out


def predict_paths(
    paths: Sequence[str | Path],
    *,
    cfg,
    model,
    vocabs: dict,
    top_k: int = 5,
    saliency: str = "occlusion",
    scorer: Scorer | None = None,
) -> dict:
    """Scan files and directories with ``model`` (an ``ExperimentConfig``
    ``cfg`` describes it). Returns ``{results, n_scored, n_errors}``:
    ``n_scored`` counts scored functions; an unparseable file, a function
    with no CFG or a directory with no ``.c`` file is an error row.
    ``scorer`` (a :class:`Scorer` of ``model``) lets a caller read its
    call count."""
    from deepdfa_tpu_torch.cpg.frontend import FrontendError

    any_voc = next(iter(vocabs.values()))
    if any_voc.input_dim != cfg.input_dim:
        raise ValueError(
            f"vocab input_dim {any_voc.input_dim} != config input_dim "
            f"{cfg.input_dim} — the checkpoint and the shard dir disagree"
        )
    if scorer is None:
        scorer = Scorer(model, cfg.model.label_style)
    results: list[dict] = []
    for p in paths:
        found = collect_sources([p])
        if not found:
            results.append({
                "file": str(p),
                "error": "directory contains no .c files "
                         "(the frontend parses C11 only)",
            })
            continue
        for name, code in found:
            try:
                results.extend(predict_source(
                    code, scorer=scorer, vocabs=vocabs, top_k=top_k,
                    name=name, saliency=saliency,
                    label_style=cfg.model.label_style,
                ))
            except (FrontendError, SyntaxError, ValueError) as e:
                results.append({"file": name,
                                "error": f"{type(e).__name__}: {e}"})
    n_err = sum(1 for r in results if "error" in r)
    return {
        "results": results,
        "n_scored": len(results) - n_err,
        "n_errors": n_err,
    }
