"""Online scoring: the bucketed engine and the request micro-batcher."""

from deepdfa_tpu_torch.serve.batcher import MicroBatcher, QueueFullError
from deepdfa_tpu_torch.serve.engine import (OversizeGraphError, ScoringEngine,
                                            ServeBucket, mega_bucket,
                                            serve_buckets)

__all__ = ["MicroBatcher", "QueueFullError", "OversizeGraphError",
           "ScoringEngine", "ServeBucket", "mega_bucket", "serve_buckets"]
