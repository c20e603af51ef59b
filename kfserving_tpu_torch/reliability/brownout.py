"""Brownout admission control: shed selectively instead of melting p99.

When predicted demand exceeds what capacity (replicas + pre-armed
standbys) can physically cover in time, blowing the latency SLO for
EVERY request is the worst outcome: the Knative/queue-proxy analysis
the overload bench reproduced shows an unbounded queue turns a
capacity gap into multi-second p99 for all callers.  Brownout is the
graceful-degradation alternative (the InferLine stance that a latency
objective is a constraint, not a wish): the ingress router sheds the
LOWEST-priority traffic first with explicit retriable 503s +
`Retry-After`, keeping the remaining traffic inside the objective.

Mechanics:

- Requests carry a priority tier in the ``x-kfs-priority`` header
  (``batch`` < ``normal`` < ``critical``; absent/unknown = normal).
- Each model has a brownout *level* set by the predictive control
  loop (control/predictive.py): level 0 admits everything; level N
  sheds tiers below N.  Level 3 sheds even critical traffic — the
  last step before the bounded queues would anyway.
- Deadline-aware queueing: while a brownout is active, a request
  whose remaining budget cannot cover the model's observed service
  time is shed immediately — it would occupy a queue slot (and
  device time) it provably cannot finish in, starving a request that
  could (the "least remaining budget never wastes a slot" rule).
- Every shed is explicit and retriable: 503 + ``Retry-After`` + a
  JSON body carrying ``"retriable": true`` and the active level, so
  clients distinguish load management from failure.

Entry and exit are the predictive controller's calls (it owns the
burn-rate signals); this module owns the level state machine, the
admission verdicts, and the metric families.
"""

import threading
from typing import Dict, Optional, Tuple

from kfserving_tpu_torch.observability import metrics as obs

PRIORITY_HEADER = "x-kfs-priority"
# Tier order: shed lowest first.  Unknown spellings map to normal so
# a typo'd header degrades to the default, never to instant shedding.
PRIORITY_TIERS: Dict[str, int] = {"batch": 0, "normal": 1,
                                  "critical": 2}
DEFAULT_TIER = PRIORITY_TIERS["normal"]
MAX_LEVEL = 3


def priority_tier(value: Optional[str]) -> int:
    if not value:
        return DEFAULT_TIER
    return PRIORITY_TIERS.get(value.strip().lower(), DEFAULT_TIER)


class BrownoutController:
    """Per-model brownout levels + admission verdicts.

    Thread-safe: levels are set from the autoscaler's control loop
    and read on the router's request path."""

    def __init__(self, retry_after_s: float = 1.0):
        self.retry_after_s = retry_after_s
        self._levels: Dict[str, int] = {}
        # Observed mean service time per model (seconds), fed by the
        # predictive controller's latency-series estimate — the
        # "can this request finish inside its budget" yardstick.
        self._service_s: Dict[str, float] = {}
        self._lock = threading.Lock()
        self.sheds = 0

    # -- level state machine ------------------------------------------------
    def level(self, model: str) -> int:
        return self._levels.get(model, 0)

    def active(self) -> bool:
        return any(self._levels.values())

    def set_level(self, model: str, level: int) -> Optional[str]:
        """Move a model to `level` (clamped to [0, MAX_LEVEL]).
        Returns the transition direction (enter|escalate|recover|
        exit) when the level changed, None when it was already
        there."""
        level = max(0, min(MAX_LEVEL, int(level)))
        with self._lock:
            prev = self._levels.get(model, 0)
            if level == prev:
                return None
            if level == 0:
                self._levels.pop(model, None)
            else:
                self._levels[model] = level
        if prev == 0:
            direction = "enter"
        elif level == 0:
            direction = "exit"
        elif level > prev:
            direction = "escalate"
        else:
            direction = "recover"
        obs.brownout_level().labels(model=model).set(float(level))
        obs.brownout_transitions_total().labels(
            model=model, direction=direction).inc()
        return direction

    # -- service-time estimate ----------------------------------------------
    def update_estimate(self, model: str, service_s: float) -> None:
        if service_s > 0:
            self._service_s[model] = service_s

    def service_estimate_s(self, model: str) -> Optional[float]:
        return self._service_s.get(model)

    # -- admission ----------------------------------------------------------
    def admit(self, model: str, tier: int,
              remaining_budget_s: Optional[float] = None
              ) -> Tuple[bool, Optional[str]]:
        """(admitted, shed_reason).  Reasons: ``priority`` (tier below
        the active level) and ``deadline`` (budget cannot cover the
        observed service time while a brownout is active)."""
        level = self._levels.get(model, 0)
        if level <= 0:
            return True, None
        if tier < level:
            self._count_shed(model, "priority")
            return False, "priority"
        service_s = self._service_s.get(model)
        if remaining_budget_s is not None and service_s is not None \
                and remaining_budget_s < service_s:
            self._count_shed(model, "deadline")
            return False, "deadline"
        return True, None

    def _count_shed(self, model: str, reason: str) -> None:
        self.sheds += 1
        obs.brownout_shed_total().labels(model=model,
                                         reason=reason).inc()

    def report(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._levels)
