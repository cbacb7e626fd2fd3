"""Int8 training experiment on the message-passing products.

The port of ``deepdfa_tpu/train/int8_train.py``. The serving path's int8
discipline at train time, over megabatch-packed (or per-bucket)
segment-layout batches:

- the conv (``edge_linear`` and both fused GRU projections) is quantized
  once by :func:`~deepdfa_tpu_torch.models.ggnn_int8.quantize_conv_params`
  and frozen: its int8 buffers are not parameters and stay out of the
  optimizer. :func:`~deepdfa_tpu_torch.ops.int8_matmul.int8_matmul` is
  differentiable with respect to its activations, so gradients still flow
  through the int8 products (kernel B5 on the card) into the embeddings;
- everything outside the conv (embedding tables, pooling gate, head) trains
  in float32 against the masked BCE, with Adam;
- admission is the serving gate per bucket shape: before any step, the
  float32-conv and int8-conv probabilities of the same parameters are
  compared for every batch, and the run refuses (``accepted=False``,
  nothing trained) when a bucket's largest delta exceeds
  ``max_score_delta``. A refusal is the gate working, not a failure.
"""

from __future__ import annotations

import dataclasses

import torch

from deepdfa_tpu_torch import resolve_device
from deepdfa_tpu_torch.config import ExperimentConfig
from deepdfa_tpu_torch.data.graphs import to_device
from deepdfa_tpu_torch.models import make_model
from deepdfa_tpu_torch.models.ggnn import build
from deepdfa_tpu_torch.models.ggnn_int8 import GGNNInt8, quantize_conv_params
from deepdfa_tpu_torch.train.loop import bce_with_logits, extract_labels

__all__ = ["DEFAULT_MAX_SCORE_DELTA", "bucket_shape_key", "run_int8_train"]

# looser than serving's 0.01: the deltas compound over optimizer steps
# anyway; the gate only has to catch a quantisation wrong from step zero
DEFAULT_MAX_SCORE_DELTA = 0.05


def bucket_shape_key(batch) -> str:
    """The gate's bucket identity: the batch's padded shape."""
    return (f"g{batch.graph_mask.shape[0]}"
            f"_n{batch.node_mask.shape[0]}"
            f"_e{batch.senders.shape[0]}")


def run_int8_train(batches, *, cfg: ExperimentConfig | None = None,
                   steps: int = 8, learning_rate: float = 1e-3,
                   pos_weight: float = 15.0,
                   max_score_delta: float = DEFAULT_MAX_SCORE_DELTA,
                   state_dict: dict | None = None, device=None) -> dict:
    """Run the frozen-int8-conv training experiment over ``batches``
    (segment-layout ``BatchedGraphs``) on ``device`` (``cuda`` unless the
    caller names another).

    The float32 parameters are ``make_model(seed=cfg.seed)``'s, or
    ``state_dict`` when given (a segment-layout GGNN state dict). Returns a
    JSON-able dict: the gate's verdict (``accepted``, ``int8_score_delta``,
    ``per_bucket_delta``, ``refused_reason``) and, when accepted, the
    training trace (``steps``, ``loss_first``, ``loss_last``,
    ``loss_decreased``): the JAX package's keys. Never raises on
    refusal."""
    cfg = cfg or ExperimentConfig()
    dev = resolve_device(device)
    mcfg = dataclasses.replace(cfg.model, layout="segment", dtype="float32")
    model32 = make_model(mcfg, cfg.input_dim, device=dev, seed=cfg.seed)
    if state_dict is not None:
        model32.load_state_dict(state_dict)
    model8 = build(GGNNInt8, mcfg, cfg.input_dim, device=dev)
    model8.load_state_dict(quantize_conv_params(model32.state_dict()))
    model32.eval()
    model8.eval()
    dev_batches = [to_device(b, dev) for b in batches]

    # -- the per-bucket float32-delta admission gate ----------------------
    per_bucket: dict[str, float] = {}
    with torch.no_grad():
        for b in dev_batches:
            real = b.graph_mask.bool()
            d = torch.abs(torch.sigmoid(model32(b))
                          - torch.sigmoid(model8(b)))[real]
            delta = float(d.max()) if d.numel() else 0.0
            key = bucket_shape_key(b)
            per_bucket[key] = max(per_bucket.get(key, 0.0), delta)
    int8_delta = max(per_bucket.values(), default=0.0)
    result: dict = {
        "accepted": int8_delta <= max_score_delta,
        "int8_score_delta": round(int8_delta, 6),
        "max_score_delta": max_score_delta,
        "per_bucket_delta": {k: round(v, 6)
                             for k, v in sorted(per_bucket.items())},
        "refused_reason": None,
        "steps": 0,
    }
    if not result["accepted"]:
        result["refused_reason"] = (
            f"max per-bucket score delta {int8_delta:.2e} exceeds "
            f"max_score_delta {max_score_delta:.2e}")
        return result

    # -- frozen-conv training: the int8 buffers are not parameters -------
    model8.train()
    opt = torch.optim.Adam(model8.parameters(), lr=learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    losses: list[float] = []
    for i in range(steps):
        batch = dev_batches[i % len(dev_batches)]
        opt.zero_grad(set_to_none=True)
        labels, weights = extract_labels(batch, mcfg.label_style)
        loss = bce_with_logits(model8(batch), labels, weights, pos_weight)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    result.update(
        steps=steps,
        loss_first=round(losses[0], 6),
        loss_last=round(losses[-1], 6),
        loss_decreased=bool(losses[-1] < losses[0]),
    )
    return result
