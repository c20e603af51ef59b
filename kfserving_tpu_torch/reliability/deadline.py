"""Per-request latency budgets, propagated by contextvar.

Port of ``kfserving_tpu/reliability/deadline.py``.  A `Deadline` is
minted once at the ingress edge (the HTTP ``x-request-timeout-ms``
header) and rides the request's context: through the handler, the data
plane, the batcher queue and into the engine's worker threads (the
engine runs its executor calls in a copy of the caller's context).
Every stage about to spend meaningful time on the request checks it
first, so an over-budget request fails with 504 *before* it takes a
batch slot or a device dispatch, not after.

The budget is wall-clock (``time.monotonic``), not event-loop time: it
must survive executor-thread hops where no loop is running.
"""

import contextlib
import math
import time
from contextvars import ContextVar
from http import HTTPStatus
from typing import Dict, Optional

from kfserving_tpu_torch.protocol.errors import ServingError

TIMEOUT_HEADER = "x-request-timeout-ms"

# Guardrail on client-supplied budgets: a parse of "1e99" must not arm
# a timer in year 10^91, and a sub-millisecond budget is a typo, not a
# latency objective.
MAX_TIMEOUT_MS = 24 * 3600 * 1000.0


class DeadlineExceeded(ServingError):
    """The request's latency budget ran out (maps to HTTP 504).

    Construction IS the shed event (every path that gives up on a
    request builds one of these, whether it raises or sets it on a
    waiter future), so the per-stage shed counter increments here —
    one central point instead of a counter call at every edge."""

    status_code = HTTPStatus.GATEWAY_TIMEOUT

    def __init__(self, where: str = ""):
        reason = "request deadline exceeded"
        if where:
            reason = f"{reason} ({where})"
        super().__init__(reason)
        try:
            from kfserving_tpu_torch.observability import metrics as obs

            obs.deadline_exceeded_total().labels(
                stage=where or "unknown").inc()
        except Exception:  # telemetry must never mask the 504
            pass


class Deadline:
    """An absolute expiry on the monotonic clock."""

    __slots__ = ("expires_at",)

    def __init__(self, budget_s: float):
        self.expires_at = time.monotonic() + budget_s

    def remaining_s(self) -> float:
        """Seconds left; negative once expired."""
        return self.expires_at - time.monotonic()

    @property
    def expired(self) -> bool:
        return time.monotonic() >= self.expires_at

    def raise_if_expired(self, where: str = "") -> None:
        if self.expired:
            raise DeadlineExceeded(where)

    @classmethod
    def from_timeout_ms(cls, timeout_ms: float) -> "Deadline":
        return cls(min(float(timeout_ms), MAX_TIMEOUT_MS) / 1000.0)

    @classmethod
    def from_headers(cls, headers: Dict[str, str]
                     ) -> Optional["Deadline"]:
        """Parse the timeout header; absent/garbage/non-positive
        values mean "no deadline", never a request failure."""
        raw = headers.get(TIMEOUT_HEADER)
        if not raw:
            return None
        try:
            ms = float(raw)
        except ValueError:
            return None
        # isfinite: float() parses "nan"/"inf", and a NaN budget would
        # poison every downstream comparison (nan <= 0 is False, so a
        # plain positivity check lets it through).
        if not math.isfinite(ms) or ms <= 0:
            return None
        return cls.from_timeout_ms(ms)

    def __repr__(self) -> str:
        return f"Deadline(remaining={self.remaining_s() * 1000:.1f}ms)"


_current: ContextVar[Optional[Deadline]] = ContextVar(
    "kfs_request_deadline", default=None)


def current_deadline() -> Optional[Deadline]:
    """The ambient request deadline, or None when unbudgeted."""
    return _current.get()


def clear_deadline() -> None:
    """Detach the ambient deadline in the CURRENT context.

    Batch-shared work (a flushed dynamic batch serves many requests
    with different budgets) must not inherit whichever single
    request's context happened to trigger the flush — per-request
    budgets are enforced at the queue edge instead."""
    _current.set(None)


@contextlib.contextmanager
def deadline_scope(deadline: Optional[Deadline]):
    """Attach `deadline` to the current context for the `with` body.
    None is accepted (no-op scope) so call sites stay unconditional."""
    token = _current.set(deadline)
    try:
        yield deadline
    finally:
        _current.reset(token)


def check_deadline(where: str = "") -> None:
    """Raise DeadlineExceeded if the ambient budget has run out."""
    dl = _current.get()
    if dl is not None and dl.expired:
        raise DeadlineExceeded(where)
