"""Typed model and feature configuration for the PyTorch port.

A trimmed copy of the JAX package's ``deepdfa_tpu/config.py``: only the
fields the fused-layout scoring path reads. Field names, defaults and
derived properties are unchanged, so a config written for the JAX package
builds the same model here.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["ALL_SUBKEYS", "FeatureConfig", "GGNNConfig", "LAYOUTS"]

ALL_SUBKEYS = ("api", "datatype", "literal", "operator")

# Layouts this package serves, and the roadmap item that ports each other one.
LAYOUTS = ("segment", "fused")
_LATER_LAYOUTS = {
    "dense": "ROADMAP queue A, item A10 (dense layout)",
    "megabatch": "ROADMAP queue A, item A7 with kernel B3 (megabatch layout)",
}


@dataclass(frozen=True)
class FeatureConfig:
    """Abstract-dataflow feature vocabulary settings.

    ``input_dim = limit_all + 2`` accounts for the not-a-definition token (0)
    and the UNKNOWN token.
    """

    subkeys: tuple[str, ...] = ALL_SUBKEYS
    limit_subkeys: int | None = 1000
    limit_all: int | None = 1000
    combined: bool = True

    def __post_init__(self):
        for k in self.subkeys:
            if k not in ALL_SUBKEYS:
                raise ValueError(f"unknown subkey {k!r}")

    @property
    def input_dim(self) -> int:
        if not self.combined:
            raise NotImplementedError("multi-hot (non-combined) features")
        assert self.limit_all is not None
        return self.limit_all + 2


@dataclass(frozen=True)
class GGNNConfig:
    """GGNN architecture (golden values: ``configs/ggnn.yaml``).

    ``layout`` is ``segment`` (gather + segment sum per round, plain torch)
    or ``fused`` (every message round on the hand-written CUDA kernel of
    :mod:`deepdfa_tpu_torch.ops.fused_ggnn`). Both share one parameter set.
    """

    hidden_dim: int = 32
    n_steps: int = 5
    num_output_layers: int = 3
    label_style: str = "graph"
    concat_all_absdf: bool = True
    encoder_mode: bool = False
    aggregation: str = "sum"
    dtype: str = "float32"
    layout: str = "segment"
    dataflow_families: bool = False
    interproc_families: bool = False

    def __post_init__(self):
        if self.layout in _LATER_LAYOUTS:
            raise NotImplementedError(
                f"layout={self.layout!r} is not ported yet: "
                f"{_LATER_LAYOUTS[self.layout]}")
        if self.layout not in LAYOUTS:
            raise ValueError(
                f"unknown layout {self.layout!r} (one of {', '.join(LAYOUTS)})")

    @property
    def out_dim(self) -> int:
        """Pooled embedding width: embed + hidden, each ×4 when the four
        subkey embeddings are concatenated."""
        mult = len(ALL_SUBKEYS) if self.concat_all_absdf else 1
        return 2 * self.hidden_dim * mult
