"""The continuous-learning loop: captured traffic → promoted weights, with
every hop fail-closed. A copy of ``deepdfa_tpu/continual``.

::

    /score traffic ──▶ capture.py   sampled, bounded JSONL journal
                        │            (never fails a request)
                        ▼
                       shadow.py    paired A/B replay through the real
                        │            ScoringEngine; per-bucket PSI report
                        ▼
                       retrain.py   delta-extract (cache misses only)
                        │            + fine-tune via fit + ledger/shadow/
                        │            metric gate
                        ▼
                       promote.py   veto check → warm staging → replica-
                                     by-replica roll through the fleet
                                     router → drift watch → complete |
                                     rollback

Configuration rides ``serve.continual.*`` (:class:`~deepdfa_tpu_torch.
config.ContinualConfig`); the fault points ``continual.capture_drop`` /
``continual.rollout_crash`` / ``continual.rollback_trigger`` pin the
failure modes.
"""

from .capture import TrafficCapture, read_capture, record_graph
from .promote import PromotionController, drift_alert_firing, stage_candidate
from .retrain import corpus_delta, no_regression_gate, run_retrain
from .shadow import shadow_gate, shadow_replay

__all__ = [
    "TrafficCapture",
    "read_capture",
    "record_graph",
    "shadow_replay",
    "shadow_gate",
    "corpus_delta",
    "no_regression_gate",
    "run_retrain",
    "PromotionController",
    "stage_candidate",
    "drift_alert_firing",
]
