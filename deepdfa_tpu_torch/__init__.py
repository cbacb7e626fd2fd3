"""DeepDFA in PyTorch for one NVIDIA H100.

The port of the JAX package ``deepdfa_tpu`` (which stays the reference).
This package serves and trains (``train.fit``) the golden GGNN through the
fused layout: every message round runs on hand-written CUDA kernels, the
forward in ``csrc/fused_ggnn.cu`` and the training backward in
``csrc/fused_ggnn_bwd.cu``, built with ``nvcc`` for ``sm_90a`` at first
use. The megabatch layout and the hierarchical scorer's level 1 run the
whole model on ``csrc/megabatch.cu``; int8 serving runs the conv products
on ``csrc/int8_matmul.cu``. The LLM tier (``llm/``: CodeLlama, LoRA
fine-tuning, the fusion head, ``JointTrainer`` and ``JointEngine``) runs
attention on ``csrc/flash_attention.cu``, its backward on
``csrc/flash_attention_bwd.cu`` and int8 projections on
``csrc/int8_matmul.cu``. ``scan.scan_paths`` takes C source: the front
end (``cpg/``: pycparser, the dataflow solvers, with the C++ solver of
``native/dfa_solver.cpp`` built by the host compiler) and the encode
pipeline (``pipeline.py``, ``data/vocab.py``) run on the host, and the
functions and units are scored on the kernels above. ``preprocess``
builds training shards from generated C (byte for byte the JAX package's),
``train.fit`` trains on them, and ``predict.predict_paths`` scores C files
with statements ranked by occlusion saliency, every forward on the fused
kernels. It imports torch, numpy and pycparser, and nothing of JAX.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on a
host without a GPU they raise instead of running on the CPU.
"""

from __future__ import annotations

__all__ = ["__version__", "resolve_device"]

__version__ = "0.5.0"  # pyproject.toml


def resolve_device(device=None) -> "torch.device":
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. A CUDA request on a host without a GPU raises. (torch is
    imported here, not with the package, so host-only modules such as the
    dataset readers' worker processes start without it.)"""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: deepdfa_tpu_torch runs on the GPU "
            "unless the caller passes device='cpu' explicitly")
    return dev
