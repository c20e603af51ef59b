"""Exponential-backoff retry with jitter and error classification.

Port of ``kfserving_tpu/reliability/retry.py``: the synchronous
``call()`` for edges that run in executor threads (the storage
download) and the asynchronous ``acall()`` for event-loop edges (the
agent's model pull, the client's connects).  Retries respect the ambient request
``Deadline``: once the budget is gone, the policy re-raises instead of
sleeping toward a response nobody can use.

Classification is allowlist-based: only errors in ``retry_on`` are
retried (default: connection-level ``OSError``s, the "request never
dispatched / transfer torn" family, which is safe to replay against
idempotent edges).  Everything else (bad config, missing SDK, 4xx
semantics surfaced as RuntimeError/ValueError) fails fast.

Env knobs (``from_env(prefix)``, falling back to the bare
``KFS_RETRY_*`` family so one setting tunes every edge):

    {prefix}_RETRY_MAX_ATTEMPTS   total attempts, 1 = no retry (def 3)
    {prefix}_RETRY_BASE_MS        first backoff delay (def 50)
    {prefix}_RETRY_MAX_MS         backoff ceiling (def 2000)
    {prefix}_RETRY_JITTER         +/- fraction of each delay (def 0.2)

Each retry counts ``kfserving_tpu_retry_total{edge, reason}``.
"""

import asyncio
import logging
import os
import random
import time
import urllib.error
from typing import Any, Callable, Iterator, Optional, Tuple, Type

from kfserving_tpu_torch.observability import metrics as obs
from kfserving_tpu_torch.reliability.deadline import current_deadline

logger = logging.getLogger("kfserving_tpu_torch.reliability.retry")

DEFAULT_RETRY_ON: Tuple[Type[BaseException], ...] = (OSError,)
# OSError subclasses that are the environment's final answer, not a
# transient wire condition: replaying a missing path or a permission
# wall can never succeed.
DEFAULT_NEVER_RETRY: Tuple[Type[BaseException], ...] = (
    FileNotFoundError, PermissionError, IsADirectoryError,
    NotADirectoryError)


def _env_float(name: str, prefix: str, default: float) -> float:
    """``{prefix}_RETRY_{name}``, else ``KFS_RETRY_{name}``, else the
    default; a non-numeric value is logged and skipped."""
    for key in (f"{prefix}_RETRY_{name}", f"KFS_RETRY_{name}"):
        raw = os.environ.get(key)
        if raw:
            try:
                return float(raw)
            except ValueError:
                logger.warning("ignoring non-numeric %s=%r", key, raw)
    return default


class RetryPolicy:
    """Attempts, delays, and the transient-vs-terminal judgment."""

    def __init__(self, max_attempts: int = 3,
                 base_delay_s: float = 0.05,
                 max_delay_s: float = 2.0,
                 multiplier: float = 2.0,
                 jitter: float = 0.2,
                 retry_on: Tuple[Type[BaseException], ...]
                 = DEFAULT_RETRY_ON,
                 rng: Optional[random.Random] = None,
                 name: str = "retry"):
        self.max_attempts = max(1, int(max_attempts))
        self.base_delay_s = max(0.0, float(base_delay_s))
        self.max_delay_s = max(self.base_delay_s, float(max_delay_s))
        self.multiplier = max(1.0, float(multiplier))
        self.jitter = min(1.0, max(0.0, float(jitter)))
        self.retry_on = retry_on
        self._rng = rng or random.Random()
        self.name = name
        self.retries = 0  # telemetry: total retries performed

    @classmethod
    def from_env(cls, prefix: str = "KFS",
                 default_max_attempts: int = 3,
                 **overrides) -> "RetryPolicy":
        """``default_max_attempts`` is the value used when no env knob
        is set; ``overrides`` win over env unconditionally."""
        params = dict(
            max_attempts=int(_env_float("MAX_ATTEMPTS", prefix,
                                        default_max_attempts)),
            base_delay_s=_env_float("BASE_MS", prefix, 50.0) / 1000.0,
            max_delay_s=_env_float("MAX_MS", prefix, 2000.0) / 1000.0,
            jitter=_env_float("JITTER", prefix, 0.2),
            name=prefix.lower(),
        )
        params.update(overrides)
        return cls(**params)

    def classify(self, exc: BaseException) -> bool:
        """True when ``exc`` is transient and the call may be replayed.
        Cancellation is never swallowed, and permanent OSError
        subclasses never replay.  urllib's HTTPError subclasses OSError
        but carries the server's verdict: a 4xx is permanent, a 5xx
        stays retryable."""
        if isinstance(exc, asyncio.CancelledError):
            return False
        if isinstance(exc, DEFAULT_NEVER_RETRY):
            return False
        if isinstance(exc, urllib.error.HTTPError):
            return exc.code >= 500 and isinstance(exc, self.retry_on)
        return isinstance(exc, self.retry_on)

    def delays_s(self) -> Iterator[float]:
        """Backoff delay before attempt i+2 (max_attempts-1 values)."""
        delay = self.base_delay_s
        for _ in range(self.max_attempts - 1):
            jittered = delay
            if self.jitter:
                jittered *= 1.0 + self.jitter * self._rng.uniform(-1, 1)
            yield max(0.0, jittered)
            delay = min(delay * self.multiplier, self.max_delay_s)

    def _give_up(self, exc: BaseException, attempt: int) -> bool:
        if not self.classify(exc):
            return True
        dl = current_deadline()
        if dl is not None and dl.expired:
            logger.warning("%s: attempt %d failed and the request "
                           "deadline is spent; not retrying: %s",
                           self.name, attempt, exc)
            return True
        return False

    def _next_delay(self, delays: Iterator[float]) -> Optional[float]:
        """The next backoff delay, or None when sleeping it would
        outlive the ambient budget."""
        delay = next(delays)
        dl = current_deadline()
        if dl is not None and dl.remaining_s() <= delay:
            return None
        return delay

    def call(self, fn: Callable[..., Any], *args, **kwargs) -> Any:
        """Synchronous retry loop (blocking sleeps: executor-thread
        edges only, never the event loop)."""
        delays = self.delays_s()
        for attempt in range(1, self.max_attempts + 1):
            try:
                return fn(*args, **kwargs)
            except BaseException as e:
                delay = None
                if attempt < self.max_attempts and \
                        not self._give_up(e, attempt):
                    delay = self._next_delay(delays)
                if delay is None:
                    raise
                logger.warning(
                    "%s: attempt %d/%d failed (%s: %s); retrying in "
                    "%.0fms", self.name, attempt, self.max_attempts,
                    type(e).__name__, e, delay * 1000)
                self.retries += 1
                obs.retry_total().labels(
                    edge=self.name, reason=type(e).__name__).inc()
                time.sleep(delay)

    async def acall(self, fn: Callable[..., Any], *args, **kwargs
                    ) -> Any:
        """Async retry loop (`fn` returns an awaitable; sleeps yield
        the event loop)."""
        delays = self.delays_s()
        for attempt in range(1, self.max_attempts + 1):
            try:
                return await fn(*args, **kwargs)
            except BaseException as e:
                delay = None
                if attempt < self.max_attempts and \
                        not self._give_up(e, attempt):
                    delay = self._next_delay(delays)
                if delay is None:
                    raise
                logger.warning(
                    "%s: attempt %d/%d failed (%s: %s); retrying in "
                    "%.0fms", self.name, attempt, self.max_attempts,
                    type(e).__name__, e, delay * 1000)
                self.retries += 1
                obs.retry_total().labels(
                    edge=self.name, reason=type(e).__name__).inc()
                await asyncio.sleep(delay)
