"""Monitor bus: a bounded, sampling, never-blocking in-process tee.

Port of ``kfserving_tpu/observability/monitoring/bus.py``, unchanged in
behaviour.  The server tees each served request (model, verb, status,
latency, trace id, raw body) to async consumers (the online monitors)
through a bounded queue; when monitoring cannot keep up, samples are
dropped and counted (``kfserving_tpu_monitor_events_total``), never
requests.

Delivery contract: one published event is one immutable dict handed to
each consumer whole and in order.

Hot-path cost: with no consumers subscribed, ``publish()`` is one
attribute check; with consumers, a sample draw plus a ``put_nowait``.
"""

import asyncio
import logging
import random
from typing import Any, Awaitable, Callable, Dict, List, Optional

from kfserving_tpu_torch.observability import metrics as obs
from kfserving_tpu_torch.observability.monitoring.knobs import env_number

logger = logging.getLogger("kfserving_tpu_torch.monitoring.bus")

DEFAULT_QUEUE_SIZE = 256
DEFAULT_SAMPLE_RATE = 1.0

Consumer = Callable[[Dict[str, Any]], Awaitable[None]]


class MonitorBus:
    """Bounded async fan-out of request events to monitor consumers."""

    def __init__(self, queue_size: int = DEFAULT_QUEUE_SIZE,
                 sample_rate: float = DEFAULT_SAMPLE_RATE,
                 seed: int = 0):
        self.queue_size = max(1, int(queue_size))
        self.sample_rate = min(1.0, max(0.0, float(sample_rate)))
        self.queue: asyncio.Queue = asyncio.Queue(maxsize=self.queue_size)
        self._consumers: List[Consumer] = []
        self._rng = random.Random(seed)
        self._task: Optional[asyncio.Task] = None
        self._warned_drop = False

    @classmethod
    def from_env(cls) -> "MonitorBus":
        return cls(
            queue_size=int(env_number("KFS_MONITOR_QUEUE",
                                      DEFAULT_QUEUE_SIZE)),
            sample_rate=env_number("KFS_MONITOR_SAMPLE",
                                   DEFAULT_SAMPLE_RATE))

    # -- consumers ---------------------------------------------------------
    def subscribe(self, consumer: Consumer) -> None:
        self._consumers.append(consumer)

    @property
    def has_consumers(self) -> bool:
        return bool(self._consumers)

    # -- hot path ----------------------------------------------------------
    def publish(self, event: Dict[str, Any]) -> bool:
        """Offer one event; True when enqueued.  Never blocks and never
        raises: a full queue drops the SAMPLE (counted), not the
        request.  With no consumers the event is discarded for free —
        an unconsumed tee must cost the serving path nothing."""
        if not self._consumers:
            return False
        if self.sample_rate < 1.0 and \
                self._rng.random() >= self.sample_rate:
            obs.monitor_events_total().labels(
                outcome="sampled_out").inc()
            return False
        try:
            self.queue.put_nowait(event)
        except asyncio.QueueFull:
            obs.monitor_events_total().labels(outcome="dropped").inc()
            if not self._warned_drop:
                self._warned_drop = True
                logger.warning(
                    "monitor bus queue full (size %d): dropping "
                    "samples; monitors fell behind the serving rate "
                    "(further drops counted, not logged)",
                    self.queue_size)
            return False
        obs.monitor_events_total().labels(outcome="published").inc()
        return True

    def attach(self, server) -> None:
        """Tee the ModelServer's request hook point onto the bus (the
        same attachment the CloudEvents payload logger uses).  The
        event carries the raw request body — immutable bytes, so the
        consumer-side decode can never observe a half-written
        payload."""
        from kfserving_tpu_torch.tracing import current_request_id

        def hook(name, verb, req, resp, latency_ms):
            if not self._consumers:
                return
            self.publish({
                "model": name,
                "verb": verb,
                "status": resp.status if resp is not None else 200,
                "latency_ms": latency_ms,
                "trace_id": current_request_id.get(),
                "payload": req.body,
            })

        server.request_hooks.append(hook)

    # -- dispatcher --------------------------------------------------------
    async def start(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(
                self._dispatch())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def drain(self) -> None:
        """Wait until every queued event has been dispatched (tests)."""
        await self.queue.join()

    async def _dispatch(self) -> None:
        while True:
            event = await self.queue.get()
            try:
                # Sequential delivery: each consumer gets the whole
                # event before the next consumer (and the next event)
                # runs — ordering and atomicity over throughput, the
                # right trade for windowed statistics.
                for consumer in list(self._consumers):
                    try:
                        await consumer(event)
                    except asyncio.CancelledError:
                        raise
                    except Exception:
                        name = getattr(consumer, "name",
                                       type(consumer).__name__)
                        obs.monitor_consumer_errors_total().labels(
                            consumer=str(name)).inc()
                        logger.exception(
                            "monitor consumer %s failed", name)
            finally:
                self.queue.task_done()
