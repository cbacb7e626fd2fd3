"""Online scoring: the bucketed engine, the request micro-batcher and the
hierarchical scorer's embedding cache."""

from deepdfa_tpu_torch.serve.batcher import MicroBatcher, QueueFullError
from deepdfa_tpu_torch.serve.embcache import (EMBCACHE_VERSION,
                                              FunctionEmbeddingCache)
from deepdfa_tpu_torch.serve.engine import (OversizeGraphError, ScoringEngine,
                                            ServeBucket, mega_bucket,
                                            serve_buckets)

__all__ = ["EMBCACHE_VERSION", "FunctionEmbeddingCache", "MicroBatcher",
           "QueueFullError", "OversizeGraphError", "ScoringEngine",
           "ServeBucket", "mega_bucket", "serve_buckets"]
