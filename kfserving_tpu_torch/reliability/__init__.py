"""Reliability of the port: deadlines, retries, breakers, brownout and
fault injection.

Port of ``kfserving_tpu/reliability``, re-exporting the same names:

- ``Deadline``: a per-request latency budget minted at ingress
  (``x-request-timeout-ms``) and carried through the stack by contextvar.
- ``RetryPolicy``: exponential backoff with jitter around idempotent I/O
  edges (storage pulls, the proxy hop's pre-dispatch connects).
- ``CircuitBreaker``: closed/open/half-open over a rolling failure
  window; the router keeps one per replica.
- ``BrownoutController``: per-model brownout levels that shed the lowest
  priority tiers first with retriable 503s, and deadline-aware
  admission.
- ``faults``: the injection harness (``KFS_FAULTS``).
"""

from kfserving_tpu_torch.reliability.breaker import CircuitBreaker
from kfserving_tpu_torch.reliability.brownout import (
    BrownoutController,
    PRIORITY_HEADER,
    priority_tier,
)
from kfserving_tpu_torch.reliability.deadline import (
    Deadline,
    DeadlineExceeded,
    TIMEOUT_HEADER,
    clear_deadline,
    current_deadline,
    deadline_scope,
)
from kfserving_tpu_torch.reliability.faults import FaultInjected, faults
from kfserving_tpu_torch.reliability.retry import RetryPolicy

__all__ = [
    "BrownoutController", "PRIORITY_HEADER", "priority_tier",
    "CircuitBreaker",
    "Deadline", "DeadlineExceeded", "TIMEOUT_HEADER",
    "clear_deadline", "current_deadline", "deadline_scope",
    "FaultInjected", "faults",
    "RetryPolicy",
]
