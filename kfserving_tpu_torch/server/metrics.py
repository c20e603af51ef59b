"""Prometheus-text metrics of the model server.

Port of ``kfserving_tpu/server/metrics.py``.  Request series live on a
PRIVATE per-server registry (two servers in one process must not count
each other's requests), and `render()` appends the process-wide
``REGISTRY`` so the batcher, engine, generator, residency and reliability
series ride the same scrape.  Request latency observations carry
OpenMetrics exemplars linking them to trace ids.
"""

import time
from typing import Dict, Optional

from kfserving_tpu_torch.observability.metrics import (
    REQUEST_LATENCY_SERIES,
    REQUEST_TOTAL_SERIES,
)
from kfserving_tpu_torch.observability.registry import (
    LATENCY_BUCKETS_MS,
    REGISTRY,
    Registry,
)


class Metrics:
    def __init__(self):
        self.registry = Registry()
        self.start_time = time.time()

    def observe_request(self, model: str, verb: str, status: int,
                        latency_ms: float,
                        trace_id: Optional[str] = None) -> None:
        self.registry.counter(
            REQUEST_TOTAL_SERIES,
            "Total requests by model/verb/status").labels(
                model=model, verb=verb, status=str(status)).inc()
        self.registry.histogram(
            REQUEST_LATENCY_SERIES, "Request latency histogram",
            buckets=LATENCY_BUCKETS_MS).labels(
                model=model, verb=verb).observe(latency_ms,
                                                trace_id=trace_id)

    def set_gauge(self, name: str, value: float,
                  labels: Dict[str, str] = None) -> None:
        self.registry.gauge(name).labels(**(labels or {})).set(value)

    def render(self, exemplars: bool = False) -> str:
        """``exemplars=True`` only for the OpenMetrics content type: the
        classic text/plain parser rejects exemplar suffixes and would
        drop the entire scrape."""
        lines = self.registry.render_lines(exemplars=exemplars)
        lines += REGISTRY.render_lines(exemplars=exemplars)
        lines.append(
            f"kfserving_tpu_uptime_seconds {time.time() - self.start_time}")
        return "\n".join(lines) + "\n"
