"""Validation: the validating-webhook equivalent.

Reference rules (pkg/apis/serving/v1beta1/
inference_service_validation.go:46-82 + component.go:109-176): DNS-1035
name, exactly one predictor implementation, storage URI prefix whitelist,
replica/concurrency bounds, logger mode enum.  TPU adds mesh-axis and
bucket sanity.
"""

from typing import List

from kfserving_tpu_torch.control.spec import (
    NAME_REGEX,
    PREDICTOR_FRAMEWORKS,
    STORAGE_URI_PREFIXES,
    InferenceService,
    TrainedModel,
)


class ValidationError(ValueError):
    pass


def _rollout_errors(policy) -> List[str]:
    """RolloutPolicy admission checks: the step schedule must be a
    strictly climbing ladder ending at full traffic, and every gate
    threshold must be meaningful (a zero-regression bound would fail
    every canary on noise)."""
    errors: List[str] = []
    steps = list(policy.steps or [])
    if not steps:
        errors.append("steps must be non-empty")
    elif not all(isinstance(s, int) and 0 < s <= 100 for s in steps):
        errors.append(f"steps must be integers in (0, 100], got {steps}")
    elif any(b <= a for a, b in zip(steps, steps[1:])):
        errors.append(f"steps must be strictly increasing, got {steps}")
    elif steps[-1] != 100:
        errors.append(f"steps must end at 100, got {steps}")
    if policy.hold_s < 0:
        errors.append("hold_s must be >= 0")
    if policy.settle_s < 0:
        errors.append("settle_s must be >= 0")
    if not 0.0 <= policy.max_error_ratio <= 1.0:
        errors.append("max_error_ratio must be in [0, 1]")
    if policy.max_latency_regression < 1.0:
        errors.append("max_latency_regression must be >= 1.0")
    if policy.min_requests < 0:
        errors.append("min_requests must be >= 0")
    if policy.warmup_probes < 0:
        errors.append("warmup_probes must be >= 0")
    if policy.warmup_timeout_s < 0:
        errors.append("warmup_timeout_s must be >= 0")
    return errors


def validate(isvc: InferenceService) -> None:
    errors: List[str] = []
    if not NAME_REGEX.match(isvc.name or ""):
        errors.append(
            f"name {isvc.name!r} must match {NAME_REGEX.pattern}")
    pred = isvc.predictor
    if pred.framework not in PREDICTOR_FRAMEWORKS:
        errors.append(
            f"predictor.framework {pred.framework!r} must be one of "
            f"{PREDICTOR_FRAMEWORKS}")
    if pred.framework == "custom":
        if not pred.command:
            errors.append("custom predictor requires command")
    elif not pred.storage_uri and not pred.multi_model:
        errors.append("predictor.storage_uri is required "
                      "(non-multi-model)")
    from kfserving_tpu_torch.control.spec import EXTERNAL_RUNTIME_FRAMEWORKS

    if pred.framework in EXTERNAL_RUNTIME_FRAMEWORKS:
        if not pred.storage_uri:
            errors.append(
                f"{pred.framework} predictor requires storage_uri")
        if pred.framework == "onnx" and pred.storage_uri:
            # Reference rule: .onnx file or a directory
            # (predictor_onnxruntime.go:47-53).
            base = pred.storage_uri.rsplit("/", 1)[-1]
            if "." in base and not base.endswith(".onnx"):
                errors.append(
                    f"onnx storage_uri must point at a .onnx file or "
                    f"a directory, got {pred.storage_uri!r}")
    if pred.storage_uri and not pred.storage_uri.startswith(
            tuple(STORAGE_URI_PREFIXES)):
        errors.append(
            f"storage_uri {pred.storage_uri!r} must start with one of "
            f"{STORAGE_URI_PREFIXES}")
    for cname, comp in isvc.components().items():
        if comp.min_replicas < 0:
            errors.append(f"{cname}.min_replicas must be >= 0")
        if comp.max_replicas < comp.min_replicas:
            errors.append(
                f"{cname}.max_replicas must be >= min_replicas")
        if comp.container_concurrency < 0:
            errors.append(f"{cname}.container_concurrency must be >= 0")
        if comp.canary_traffic_percent is not None and not (
                0 <= comp.canary_traffic_percent <= 100):
            errors.append(
                f"{cname}.canary_traffic_percent must be in [0, 100]")
        if comp.logger is not None and comp.logger.mode not in (
                "all", "request", "response"):
            errors.append(
                f"{cname}.logger.mode must be all|request|response")
        if comp.batcher is not None:
            if comp.batcher.max_batch_size <= 0:
                errors.append(f"{cname}.batcher.max_batch_size must be > 0")
            if comp.batcher.max_latency_ms <= 0:
                errors.append(f"{cname}.batcher.max_latency_ms must be > 0")
        if comp.rollout is not None:
            errors.extend(f"{cname}.rollout.{e}"
                          for e in _rollout_errors(comp.rollout))
    if isvc.explainer is not None:
        # Admission-time type check (the reference's validating webhook
        # catches bad specs at apply, not replica actuation).
        from kfserving_tpu_torch.explainers import (
            ARTIFACT_REQUIRED_TYPES,
            EXPLAINER_TYPES,
        )

        etype = isvc.explainer.explainer_type
        if isvc.explainer.command:
            # An explicit command serves any type (the orchestrator's
            # command-first branch); no in-tree checks apply.
            pass
        elif etype == "custom":
            errors.append("custom explainer requires command")
        elif etype not in EXPLAINER_TYPES:
            errors.append(
                f"explainer.explainer_type {etype!r} must be one of "
                f"{list(EXPLAINER_TYPES)} or 'custom' (with command)")
        elif etype in ARTIFACT_REQUIRED_TYPES and \
                not isvc.explainer.storage_uri:
            errors.append(
                f"{etype} explainer requires storage_uri")
        if isvc.explainer.storage_uri and \
                not isvc.explainer.storage_uri.startswith(
                    tuple(STORAGE_URI_PREFIXES)):
            errors.append(
                f"explainer.storage_uri {isvc.explainer.storage_uri!r} "
                f"must start with one of {STORAGE_URI_PREFIXES}")
    par = pred.parallelism
    if par is not None and (par.dp < 1 or par.tp < 1 or par.sp < 1):
        errors.append("parallelism axes must be >= 1")
    else:
        # The mesh must land on a real slice shape (TPU analogue of the
        # reference's accelerator annotation being resolvable).
        from kfserving_tpu_torch.control.topology import (
            TopologyError,
            select_topology,
        )

        try:
            select_topology(pred, isvc.annotations)
        except TopologyError as e:
            errors.append(str(e))
    if errors:
        raise ValidationError("; ".join(errors))


def validate_trained_model(tm: TrainedModel) -> None:
    errors: List[str] = []
    if not NAME_REGEX.match(tm.name or ""):
        errors.append(f"name {tm.name!r} must match {NAME_REGEX.pattern}")
    if not tm.inference_service:
        errors.append("inference_service is required")
    if not tm.storage_uri.startswith(tuple(STORAGE_URI_PREFIXES)):
        errors.append(
            f"storage_uri {tm.storage_uri!r} must start with one of "
            f"{STORAGE_URI_PREFIXES}")
    if tm.memory_bytes < 0:
        errors.append("memory_bytes must be >= 0")
    if errors:
        raise ValidationError("; ".join(errors))
