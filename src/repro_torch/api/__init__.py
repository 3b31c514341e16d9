"""User-facing resiliency API: transactional sessions + checkpoint policies."""

from repro_torch.api.policy import (
    CheckpointPolicy,
    DalyPolicy,
    DrainAwarePolicy,
    FailureHistoryPolicy,
    IntervalPolicy,
    PolicyContext,
)
from repro_torch.api.session import ResilienceSession

__all__ = [
    "CheckpointPolicy",
    "DalyPolicy",
    "DrainAwarePolicy",
    "FailureHistoryPolicy",
    "IntervalPolicy",
    "PolicyContext",
    "ResilienceSession",
]
