"""Model export for serving: the trained GGNN as a ``torch.export`` program.

The port of ``deepdfa_tpu/serving.py``. :func:`export_ggnn` writes the
scoring forward with its parameters inside to a self-contained artifact;
:func:`load_exported` reads it back and scores WITHOUT the model code, the
config system or the checkpoint machinery: only torch, this module and the
registered ops of :mod:`deepdfa_tpu_torch.ops.custom_ops`, through which
every message round runs on kernel B1 on the card (and every conv product
on B5 for an int8 model). The program is traced at one fixed shape.

Artifact layout (one directory):

- ``model.pt2``: ``torch.export.save`` of the program;
- ``manifest.json``: the JAX manifest's keys (input schema in flatten
  order, the producing config, provenance, ``vocab_hash``), ``format``
  ``"torch.export"``, and ``torch_version``. Written last: a directory
  without it holds no export.

The program takes the batch's leaves as positional tensors, in the JAX
manifest's flatten order: ``node_feats`` by sorted key, then ``senders``,
``receivers``, ``node_gidx``, ``node_mask``, ``edge_mask``,
``graph_mask``. It returns ``sigmoid(GGNNFused(batch))`` per graph slot
``[max_graphs]``; padding slots carry garbage, and callers mask with
``graph_mask``. Its nodes carry no device: :func:`load_program` places it
on any device, and the registered ops pick their CPU or CUDA
implementation from the inputs when they run. A torch loader never reads
a JAX StableHLO artifact.
"""

from __future__ import annotations

import dataclasses
import io
import json
import warnings
from pathlib import Path

import numpy as np
import torch
from torch import nn

from deepdfa_tpu_torch import resolve_device
from deepdfa_tpu_torch.config import ALL_SUBKEYS, ExperimentConfig, to_json
from deepdfa_tpu_torch.data.graphs import BatchedGraphs, Graph, batch_np
from deepdfa_tpu_torch.ops import custom_ops  # noqa: F401 (registers the ops)
from deepdfa_tpu_torch.resilience.journal import (atomic_write_bytes,
                                                  atomic_write_text)

__all__ = ["FORMAT", "ScoreProgram", "example_batch", "export_ggnn",
           "export_program", "exported_ops", "load_exported", "load_program",
           "save_program"]

FORMAT = "torch.export"
PLATFORMS = ("cpu", "cuda")
# the batch's array leaves after the feature columns, in flatten order
LEAF_FIELDS = ("senders", "receivers", "node_gidx", "node_mask", "edge_mask",
               "graph_mask")


def example_batch(cfg: ExperimentConfig, vocab_keys=None) -> BatchedGraphs:
    """A structurally valid batch at the config's ceiling shapes, feature
    columns only: the shape the exported program is traced at."""
    b = cfg.data.batch
    n = 4
    if vocab_keys is None:
        vocab_keys = ([f"_ABS_DATAFLOW_{sk}" for sk in ALL_SUBKEYS]
                      if cfg.model.concat_all_absdf else ["_ABS_DATAFLOW"])
    feats = {key: np.zeros(n, np.int32) for key in vocab_keys}
    g = Graph(senders=np.arange(n - 1, dtype=np.int32),
              receivers=np.arange(1, n, dtype=np.int32),
              node_feats=feats).with_self_loops()
    return batch_np([g], b.batch_graphs + 1, b.max_nodes, b.max_edges)


class ScoreProgram(nn.Module):
    """``sigmoid(model(batch))`` over the batch's positional leaves."""

    def __init__(self, model: nn.Module, feat_keys):
        super().__init__()
        self.model = model
        self.feat_keys = tuple(feat_keys)

    def forward(self, *leaves: torch.Tensor) -> torch.Tensor:
        k = len(self.feat_keys)
        batch = BatchedGraphs(dict(zip(self.feat_keys, leaves[:k])),
                              *leaves[k:])
        return torch.sigmoid(self.model(batch))


def _leaves(batch: BatchedGraphs, feat_keys) -> list[np.ndarray]:
    return ([batch.node_feats[k] for k in feat_keys]
            + [getattr(batch, f) for f in LEAF_FIELDS])


def _check_sorted(receivers: np.ndarray) -> None:
    # the check GatedGraphConv makes on live batches, here on the host: a
    # traced program cannot read values
    r = np.asarray(receivers)
    if r.size > 1 and bool(np.any(r[1:] < r[:-1])):
        raise ValueError(
            "edges are not sorted by receiver — sort hand-built edge lists "
            "(batch_np does this on the host)")


def _tensors(batch: BatchedGraphs, feat_keys, device) -> list[torch.Tensor]:
    _check_sorted(batch.receivers)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in _leaves(batch, feat_keys)]


def export_program(model: nn.Module, example: BatchedGraphs, feat_keys,
                   label_style: str = "graph"):
    """``torch.export`` of ``sigmoid(model(batch))`` at ``example``'s
    shapes, traced on the model's device with no gradient (so every
    kernel call is a registered op). Returns the ``ExportedProgram``."""
    if label_style != "graph":
        raise NotImplementedError(
            f"exporting label_style={label_style!r} is not ported yet: the "
            "node-label model is ROADMAP A3")
    dev = next(model.parameters()).device
    args = tuple(_tensors(example, feat_keys, dev))
    with torch.no_grad():
        return torch.export.export(ScoreProgram(model, feat_keys).eval(),
                                   args, strict=False)


def exported_ops(program) -> set[str]:
    """The ops an exported program calls, as its graph prints them
    (``"deepdfa.fused_ggnn.default"``, ``"aten.linear.default"``, ...)."""
    return {str(node.target) for node in program.graph.nodes
            if node.op == "call_function"}


def save_program(program) -> bytes:
    """``torch.export.save`` of ``program``, as bytes."""
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_program(src, device):
    """An exported program from a path or bytes, placed on ``device``.
    Returns ``(program, module)``: ``module`` is the callable."""
    from torch.export.passes import move_to_device_pass

    if isinstance(src, (bytes, bytearray)):
        src = io.BytesIO(src)
    program = move_to_device_pass(torch.export.load(src), torch.device(device))
    return program, program.module()


def export_ggnn(cfg: ExperimentConfig, state_dict, out_dir: str | Path,
                vocab_keys=None, model=None, example=None,
                provenance: dict | None = None,
                vocab_hash: str | None = None, device=None) -> Path:
    """Write ``sigmoid(GGNNFused(batch))`` with ``state_dict`` inside to
    ``out_dir`` (``model.pt2`` + ``manifest.json``), traced on ``device``
    (``cuda`` unless the caller names another) at ``example``'s shapes
    (default: :func:`example_batch`, the config's ceiling). The model is
    the **fused** layout whatever layout trained it (the layouts share one
    parameter set). ``model``: an already built fused model, given by a
    caller that restored into it; ``vocab_hash``: the training
    vocabularies' content hash, the stale-artifact guard's input."""
    if cfg.model.label_style != "graph":
        raise NotImplementedError(
            f"exporting label_style={cfg.model.label_style!r} is not ported "
            "yet: the node-label model is ROADMAP A3")
    from deepdfa_tpu_torch.models import make_model

    dev = resolve_device(device)
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, layout="fused"))
    if model is None:
        model = make_model(cfg.model, cfg.input_dim, device="cpu")
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model = model.to(dev).eval()
    ex = example_batch(cfg, vocab_keys) if example is None else example
    keys = sorted(ex.node_feats)
    program = export_program(model, ex, keys, cfg.model.label_style)

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    atomic_write_bytes(out_dir / "model.pt2", save_program(program))
    manifest = {
        "format": FORMAT,
        "callable": "sigmoid(GGNNFused(batch)) — probabilities; mask padding "
                    "with graph_mask",
        "label_style": cfg.model.label_style,
        "layout": cfg.model.layout,
        "input_treedef": "positional: node_feats[" + ", ".join(keys)
                         + "], " + ", ".join(LEAF_FIELDS),
        "node_feat_keys": keys,
        "input_leaves": [
            {"shape": list(np.shape(x)), "dtype": str(np.asarray(x).dtype)}
            for x in _leaves(ex, keys)],
        "platforms": list(PLATFORMS),
        "config": json.loads(to_json(cfg)),
        "provenance": provenance or {},
        "package_version": _package_version(),
        "torch_version": torch.__version__,
        "vocab_hash": vocab_hash,
    }
    # manifest last: the export's commit marker
    atomic_write_text(out_dir / "manifest.json", json.dumps(manifest, indent=2))
    return out_dir


@dataclasses.dataclass
class _Servable:
    """A loaded program: call it with a ``BatchedGraphs`` of numpy arrays
    at the program's shapes; returns float32 probabilities ``[max_graphs]``
    on the host."""

    program: object
    module: object
    manifest: dict
    device: torch.device

    def __call__(self, batch: BatchedGraphs) -> np.ndarray:
        # conform to the exported schema: extra feature columns (labels,
        # solver bits) are dropped, missing ones are a clear error
        want = self.manifest["node_feat_keys"]
        missing = [k for k in want if k not in batch.node_feats]
        if missing:
            raise ValueError(
                f"batch is missing node_feats {missing} required by the "
                f"exported model (manifest node_feat_keys={want})")
        args = _tensors(batch, want, self.device)
        with torch.inference_mode():
            probs = self.module(*args)
        return probs.to("cpu", torch.float32).numpy()


def _package_version() -> str:
    import deepdfa_tpu_torch

    return getattr(deepdfa_tpu_torch, "__version__", "unknown")


def load_exported(out_dir: str | Path, expect_vocab_hash: str | None = None,
                  device=None) -> _Servable:
    """Read an artifact directory onto ``device`` (``cuda`` unless the
    caller names another). ``expect_vocab_hash``: the content hash of the
    vocabularies the caller encodes requests with; when it and the
    manifest's differ, every score would be silently wrong, so a warning
    fires (a warning, as in the JAX package: hashless artifacts load). A
    JAX StableHLO directory raises ``ValueError``."""
    out_dir = Path(out_dir)
    dev = resolve_device(device)
    if not (out_dir / "model.pt2").exists() and \
            (out_dir / "model.stablehlo").exists():
        raise ValueError(
            f"{out_dir} holds a JAX 'jax.export stablehlo' artifact: the "
            f"torch loader reads only {FORMAT!r} artifacts (model.pt2); "
            "export the run with python -m deepdfa_tpu_torch.train.cli "
            "export")
    manifest = json.loads((out_dir / "manifest.json").read_text())
    if manifest.get("format") != FORMAT:
        raise ValueError(
            f"{out_dir}: manifest format {manifest.get('format')!r}, the "
            f"torch loader reads only {FORMAT!r}")
    program, module = load_program(out_dir / "model.pt2", dev)
    recorded = manifest.get("vocab_hash")
    if (expect_vocab_hash is not None and recorded is not None
            and recorded != expect_vocab_hash):
        warnings.warn(
            f"vocab hash mismatch: artifact {out_dir} was exported against "
            f"vocab {recorded}, but the serving vocabulary hashes to "
            f"{expect_vocab_hash} — scores will be wrong; re-export against "
            "the current shard dir", stacklevel=2)
    return _Servable(program=program, module=module, manifest=manifest,
                     device=dev)
