"""PyTorch models: the GGNN classifier in the segment, fused and megabatch
layouts."""

from __future__ import annotations

from deepdfa_tpu_torch.config import GGNNConfig

__all__ = ["make_model"]


def make_model(cfg: GGNNConfig, input_dim: int, device=None, seed: int = 0):
    """The flagship model in the configured layout, initialised from
    ``seed`` on ``device`` (``cuda`` unless the caller names another). The
    layouts share one parameter set, so a state dict moves between them."""
    from deepdfa_tpu_torch.models.ggnn import GGNN, build
    from deepdfa_tpu_torch.models.ggnn_fused import GGNNFused
    from deepdfa_tpu_torch.models.ggnn_megabatch import GGNNMegabatch

    cls = {"fused": GGNNFused, "megabatch": GGNNMegabatch}.get(cfg.layout, GGNN)
    return build(cls, cfg, input_dim, device=device, seed=seed)
