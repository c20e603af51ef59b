"""Telemetry of the port: the labeled registry, the metric catalog, the
access log and the roofline gauges.

Port of ``kfserving_tpu/observability/`` cut down to what the V1 request
path uses.  Like the JAX package's, it imports nothing from ``server/``,
``engine/`` or ``reliability/``: those layers import it.
"""

from kfserving_tpu_torch.observability.registry import (
    LATENCY_BUCKETS_MS,
    REGISTRY,
    Registry,
)

__all__ = ["LATENCY_BUCKETS_MS", "REGISTRY", "Registry"]
