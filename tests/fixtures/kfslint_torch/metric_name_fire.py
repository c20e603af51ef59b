"""kfslint golden fixture: metric-name MUST fire (never executed)."""
from kfserving_tpu_torch.observability.registry import REGISTRY


def declare(registry):
    REGISTRY.counter("kfserving_tpu_swaps")                # FIRE: no _total
    REGISTRY.gauge("kfserving_tpu_depth_total")            # FIRE: gauge _total
    REGISTRY.histogram("kfserving_tpu_swap_time")          # FIRE: no unit
    REGISTRY.counter("swaps_total")                        # FIRE: no prefix
    registry.histogram("kfserving_tpu_wait_milliseconds")  # FIRE: _ms
