"""DeepDFA in PyTorch for one NVIDIA H100.

The port of the JAX package ``deepdfa_tpu`` (which stays the reference).
This package serves and trains (``train.fit``) the golden GGNN through the
fused layout: every message round runs on hand-written CUDA kernels, the
forward in ``csrc/fused_ggnn.cu`` and the training backward in
``csrc/fused_ggnn_bwd.cu``, built with ``nvcc`` for ``sm_90a`` at first
use. It imports torch and numpy and nothing of JAX.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on a
host without a GPU they raise instead of running on the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. A CUDA request on a host without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: deepdfa_tpu_torch runs on the GPU "
            "unless the caller passes device='cpu' explicitly")
    return dev
