"""Synthetic CFG-like request traffic.

A copy of the JAX package's ``deepdfa_tpu/data/synthetic.py`` without the
static-analysis feature families: graphs drawn to match Big-Vul's scale
(mean ~50 CFG nodes per function, heavy tail; self-loops added). Features
follow the abstract-dataflow contract: per-node integer ids in
``[0, input_dim)`` with 0 = not-a-definition, and a ``_VULN`` node label.
The random draws are made in the same order as the JAX package's, so one
seed gives the same graphs in both packages.
"""

from __future__ import annotations

import numpy as np

from deepdfa_tpu_torch.config import ALL_SUBKEYS
from deepdfa_tpu_torch.data.graphs import Graph

__all__ = ["random_graph", "random_dataset"]


def random_graph(
    rng: np.random.Generator,
    input_dim: int = 1002,
    mean_nodes: int = 50,
    vul: bool | None = None,
    def_rate: float = 0.35,
) -> Graph:
    n = max(3, int(rng.lognormal(mean=np.log(mean_nodes), sigma=0.6)))
    # CFG backbone: a chain with branch/merge shortcuts, like real control flow.
    senders = list(range(n - 1))
    receivers = list(range(1, n))
    n_extra = max(1, n // 8)
    src = rng.integers(0, n - 1, size=n_extra)
    dst = np.minimum(src + rng.integers(2, 5, size=n_extra), n - 1)
    senders += src.tolist()
    receivers += dst.tolist()

    is_def = rng.random(n) < def_rate
    feats: dict[str, np.ndarray] = {}
    for sk in ALL_SUBKEYS:
        ids = rng.integers(1, input_dim, size=n, dtype=np.int32)
        feats[f"_ABS_DATAFLOW_{sk}"] = np.where(is_def, ids, 0).astype(np.int32)
    # Combined-vocab id (the single-table feature `_ABS_DATAFLOW`).
    ids = rng.integers(1, input_dim, size=n, dtype=np.int32)
    feats["_ABS_DATAFLOW"] = np.where(is_def, ids, 0).astype(np.int32)

    if vul is None:
        vul = bool(rng.random() < 0.06)
    vuln = np.zeros(n, dtype=np.int32)
    if vul:
        # Mark 1-3 "vulnerable statements"; make them weakly learnable by
        # biasing the api feature id into a reserved low band.
        k = int(rng.integers(1, 4))
        idx = rng.choice(n, size=min(k, n), replace=False)
        vuln[idx] = 1
        feats["_ABS_DATAFLOW_api"][idx] = rng.integers(1, 1 + max(2, input_dim // 50))
    feats["_VULN"] = vuln

    g = Graph(
        senders=np.array(senders, dtype=np.int32),
        receivers=np.array(receivers, dtype=np.int32),
        node_feats=feats,
    )
    return g.with_self_loops()


def random_dataset(
    n_graphs: int,
    seed: int = 0,
    input_dim: int = 1002,
    mean_nodes: int = 50,
    vul_rate: float = 0.06,
) -> list[Graph]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_graphs):
        g = random_graph(
            rng, input_dim=input_dim, mean_nodes=mean_nodes,
            vul=bool(rng.random() < vul_rate),
        )
        g.gid = i
        out.append(g)
    return out
