"""Defaulting: the mutating-webhook equivalent.

Reference behavior (pkg/apis/serving/v1beta1/
inference_service_defaults.go:31-74): fill resource defaults and call each
component's Default().  TPU defaults additionally bound the batcher to the
engine's bucket ceiling and align mesh axes with the replica's chip count.
"""

from kfserving_tpu_torch.control.spec import (
    BatcherSpec,
    InferenceService,
    ParallelismSpec,
)

DEFAULT_TIMEOUT_SECONDS = 300
DEFAULT_MAX_BATCH_SIZE = 32
DEFAULT_MAX_LATENCY_MS = 5.0


def apply_defaults(isvc: InferenceService) -> InferenceService:
    """Mutates and returns the isvc with defaults filled."""
    for component in isvc.components().values():
        if component.min_replicas < 0:
            component.min_replicas = 0
        if component.max_replicas < component.min_replicas:
            component.max_replicas = max(component.min_replicas, 1)
        if component.timeout_seconds <= 0:
            component.timeout_seconds = DEFAULT_TIMEOUT_SECONDS
        if component.batcher is not None:
            b = component.batcher
            if b.max_batch_size <= 0:
                b.max_batch_size = DEFAULT_MAX_BATCH_SIZE
            if b.max_latency_ms <= 0:
                b.max_latency_ms = DEFAULT_MAX_LATENCY_MS
        if component.rollout is not None and \
                component.canary_traffic_percent is None:
            # Progressive delivery: the rollout manager owns the split.
            # Start at 0% so a brand-new revision's replicas warm up
            # (ready + warmup probes) before the first step grants any
            # traffic.  On a first-ever apply (no previous revision)
            # the reconciler still routes 100% to the only revision.
            component.canary_traffic_percent = 0
    pred = isvc.predictor
    if pred.parallelism is None:
        pred.parallelism = ParallelismSpec()
    if pred.protocol_version not in ("v1", "v2"):
        pred.protocol_version = "v1"
    if pred.multi_model and pred.batcher is None:
        # MMS predictors batch by default: per-model request streams are
        # sparse, so coalescing is what keeps chips busy.
        pred.batcher = BatcherSpec()
    return isvc
