"""Online scoring: the bucketed engine, the request micro-batcher, the scan
cache, the serving metrics, the two-tier cascade, the frontend encode pool,
the hierarchical scorer's embedding cache and the warm store of exported
bucket programs. The HTTP service is
:mod:`deepdfa_tpu_torch.serve.server` (``python -m
deepdfa_tpu_torch.serve.server``), the fleet router in front of its
replicas :mod:`deepdfa_tpu_torch.serve.router` (``python -m
deepdfa_tpu_torch.serve.router``), their launcher and autoscaler
:mod:`deepdfa_tpu_torch.serve.autoscaler` and the federation of cells
:mod:`deepdfa_tpu_torch.serve.federation` (``python -m
deepdfa_tpu_torch.serve.federation``). None of those modules is imported
with the package, so that ``-m`` runs each as a fresh module: the names
the JAX package exports from the autoscaler and the federation resolve on
first use."""

import importlib

from deepdfa_tpu_torch.serve.batcher import MicroBatcher, QueueFullError
from deepdfa_tpu_torch.serve.cache import ScanCache, ScanEntry
from deepdfa_tpu_torch.serve.cascade import (CascadeRouter,
                                             EscalationDropped,
                                             Tier2Batcher,
                                             Tier2DeadlineError,
                                             Tier2QueueFull)
from deepdfa_tpu_torch.serve.embcache import (EMBCACHE_VERSION,
                                              FunctionEmbeddingCache)
from deepdfa_tpu_torch.serve.engine import (OversizeGraphError, PendingScore,
                                            ScoringEngine, ServeBucket,
                                            mega_bucket, serve_buckets)
from deepdfa_tpu_torch.serve.frontend import (ENCODE_ITEM_ERRORS,
                                              FrontendPool,
                                              FrontendProcessSession,
                                              ThreadEncodeSession,
                                              VocabHashMismatch,
                                              encode_session_factory)
from deepdfa_tpu_torch.serve.metrics import LatencyReservoir, ServeMetrics
from deepdfa_tpu_torch.serve.warmstore import (WarmEntry, WarmStore,
                                               bucket_artifact_key)

# name -> the module that defines it, imported on first use
_LAZY = {"AdminRouterClient": "autoscaler", "Autoscaler": "autoscaler",
         "SpawnError": "autoscaler", "SubprocessLauncher": "autoscaler",
         "SubprocessReplica": "autoscaler", "Cell": "federation",
         "FederationMetrics": "federation",
         "FederationRouter": "federation"}


def __getattr__(name: str):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)


__all__ = ["AdminRouterClient", "Autoscaler", "Cell", "FederationMetrics",
           "FederationRouter", "SpawnError", "SubprocessLauncher",
           "SubprocessReplica", "CascadeRouter", "ENCODE_ITEM_ERRORS", "EMBCACHE_VERSION",
           "EscalationDropped", "FrontendPool", "FrontendProcessSession",
           "FunctionEmbeddingCache", "LatencyReservoir", "MicroBatcher",
           "OversizeGraphError", "PendingScore", "QueueFullError",
           "ScanCache", "ScanEntry", "ScoringEngine", "ServeBucket",
           "ServeMetrics", "ThreadEncodeSession", "Tier2Batcher",
           "Tier2DeadlineError", "Tier2QueueFull", "VocabHashMismatch",
           "WarmEntry", "WarmStore", "bucket_artifact_key",
           "encode_session_factory", "mega_bucket", "serve_buckets"]
