"""kfslint golden fixture: metric-name must NOT fire (never
executed)."""
from kfserving_tpu_torch.observability.registry import REGISTRY


def declare(registry, name):
    REGISTRY.counter("kfserving_tpu_swaps_total")
    REGISTRY.gauge("kfserving_tpu_pipeline_depth")
    REGISTRY.histogram("kfserving_tpu_swap_ms")
    registry.histogram("kfserving_tpu_goodput_ratio")
    # Dynamic names are the runtime exposition lint's job.
    registry.gauge(name)
    # Non-registry receivers are not family declarations.
    catalog = object()
    catalog.counter("whatever")
