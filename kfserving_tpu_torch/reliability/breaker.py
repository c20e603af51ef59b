"""Circuit breaker: closed / open / half-open over a rolling window.

Protects a caller from hammering a dependency that has stopped
answering (the error-storm amplifier: every failed call costs a full
timeout, and a retrying caller multiplies them).  Semantics:

- CLOSED: calls flow; failures are recorded with timestamps.  When
  `failure_threshold` failures land inside the trailing `window_s`,
  the breaker OPENs.
- OPEN: `allow()` is False — callers skip the dependency outright.
  After `reset_timeout_s` the breaker moves to HALF_OPEN.
- HALF_OPEN: up to `half_open_max` trial calls are allowed through.
  A success closes the breaker (window cleared); a failure re-opens
  it and restarts the reset clock.

`half_open_max=0` disables traffic-driven recovery: the breaker stays
open until an external health check calls `reset()` — the router uses
this so trial *requests* never land on a replica that has not first
answered a cheap liveness probe.

Thread-safety: none.  Each breaker belongs to one event loop (the
router's); cross-thread use needs external locking.

Env knobs (`from_env(prefix)`, `KFS_BREAKER_*` fallback):

    {prefix}_BREAKER_THRESHOLD   failures to open (def 5)
    {prefix}_BREAKER_WINDOW_S    rolling window seconds (def 30)
    {prefix}_BREAKER_RESET_S     open -> half-open seconds (def 5)
"""

import logging
import time
from collections import deque
from typing import Callable, Deque

from kfserving_tpu_torch.observability import metrics as obs
from kfserving_tpu_torch.reliability.envknobs import env_float

logger = logging.getLogger("kfserving_tpu_torch.reliability.breaker")

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# Gauge encoding of breaker state (per-replica breaker visibility on
# /metrics: a router scrape shows which hosts rotation is skipping).
_STATE_VALUE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


def _env_float(name: str, prefix: str, default: float) -> float:
    return env_float(name, prefix, "BREAKER", default)


class CircuitBreaker:
    def __init__(self, failure_threshold: int = 5,
                 window_s: float = 30.0,
                 reset_timeout_s: float = 5.0,
                 half_open_max: int = 1,
                 name: str = "breaker",
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = max(1, int(failure_threshold))
        self.window_s = float(window_s)
        self.reset_timeout_s = float(reset_timeout_s)
        self.half_open_max = max(0, int(half_open_max))
        self.name = name
        self._clock = clock
        self._failures: Deque[float] = deque()
        self._state = CLOSED
        self._opened_at = 0.0
        self._half_open_inflight = 0
        self.opened_count = 0  # telemetry

    @classmethod
    def from_env(cls, prefix: str = "KFS", **overrides
                 ) -> "CircuitBreaker":
        params = dict(
            failure_threshold=int(_env_float("THRESHOLD", prefix, 5)),
            window_s=_env_float("WINDOW_S", prefix, 30.0),
            reset_timeout_s=_env_float("RESET_S", prefix, 5.0),
        )
        params.update(overrides)
        return cls(**params)

    # -- state ---------------------------------------------------------------
    @property
    def state(self) -> str:
        self._maybe_half_open()
        return self._state

    def _maybe_half_open(self) -> None:
        if self._state == OPEN and \
                self._clock() - self._opened_at >= self.reset_timeout_s:
            self._state = HALF_OPEN
            self._half_open_inflight = 0
            self._export_state()

    def _export_state(self) -> None:
        obs.breaker_state().labels(name=self.name).set(
            _STATE_VALUE[self._state])

    def _prune(self, now: float) -> None:
        horizon = now - self.window_s
        while self._failures and self._failures[0] < horizon:
            self._failures.popleft()

    # -- caller API ----------------------------------------------------------
    def allow(self) -> bool:
        """May a call proceed right now?  HALF_OPEN admits at most
        `half_open_max` trials until an outcome is recorded."""
        self._maybe_half_open()
        if self._state == CLOSED:
            return True
        if self._state == HALF_OPEN and \
                self._half_open_inflight < self.half_open_max:
            self._half_open_inflight += 1
            return True
        return False

    def record_success(self) -> None:
        if self._state != CLOSED:
            logger.info("breaker %s closed (probe succeeded)",
                        self.name)
            obs.breaker_transitions().labels(
                name=self.name, to=CLOSED).inc()
        self.reset()

    def record_failure(self) -> None:
        now = self._clock()
        if self._state == HALF_OPEN:
            # Trial failed: straight back to open, clock restarted.
            self._trip(now)
            return
        self._failures.append(now)
        self._prune(now)
        if self._state == CLOSED and \
                len(self._failures) >= self.failure_threshold:
            self._trip(now)

    def _trip(self, now: float) -> None:
        if self._state != OPEN:
            self.opened_count += 1
            logger.warning(
                "breaker %s OPEN (%d failures in %.0fs window)",
                self.name, len(self._failures) or 1, self.window_s)
            obs.breaker_transitions().labels(
                name=self.name, to=OPEN).inc()
        self._state = OPEN
        self._opened_at = now
        self._half_open_inflight = 0
        self._export_state()

    def reset(self) -> None:
        """Force-close (external health probe confirmed recovery)."""
        self._state = CLOSED
        self._failures.clear()
        self._half_open_inflight = 0
        self._export_state()
