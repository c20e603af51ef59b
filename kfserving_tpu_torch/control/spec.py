"""InferenceService / TrainedModel spec schema.

Re-expresses the reference CRD types (reference
pkg/apis/serving/v1beta1/inference_service.go:24-36 — Predictor required,
Transformer/Explainer optional; component extension knobs
component.go:72-95; per-framework one-of predictor.go:33-59) as plain
dataclasses serializable to/from JSON/YAML-shaped dicts.

TPU-first additions, absent in the reference because it never touched
model internals (SURVEY.md §2.3):
- ParallelismSpec (dp/tp/sp mesh axes per replica);
- hbm_budget_bytes on the predictor (multi-model admission);
- batcher.max_latency_ms at millisecond granularity and shape buckets.
"""

import re
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

# Frameworks the predictor one-of accepts (reference predictor.go:33-59
# lists 8 + custom; 'jax' is the TPU-native addition replacing triton/
# tfserving — those artifacts convert offline; 'pytorch' serves the
# reference's pytorchserver contract, on the card in the port).
PREDICTOR_FRAMEWORKS = (
    "jax", "generative", "sklearn", "xgboost", "lightgbm", "pmml",
    "pytorch", "tensorflow", "triton", "onnx", "custom")

# Frameworks served by EXTERNAL server binaries (the reference's
# TFServing/Triton/ONNXRuntime container images, predictor.go:33-59):
# the subprocess orchestrator builds their argv per the runtime's own
# CLI convention from the cluster config's command entry
# (predictor_tfserving.go:84-90, predictor_triton.go:59-67,
# predictor_onnxruntime.go:67-72).  The binaries are deployment
# config — not bundled here.
EXTERNAL_RUNTIME_FRAMEWORKS = ("tensorflow", "triton", "onnx")

NAME_REGEX = re.compile(r"^[a-z]([-a-z0-9]*[a-z0-9])?$")  # k8s DNS-1035
STORAGE_URI_PREFIXES = (
    "gs://", "s3://", "file://", "http://", "https://", "pvc://", "/")


@dataclass
class LoggerSpec:
    """Payload logging (reference inference_service.go:53-64)."""

    url: str = ""
    mode: str = "all"  # all | request | response


@dataclass
class BatcherSpec:
    """Dynamic batching (reference inference_service.go:66-77; TPU adds
    millisecond deadlines — the reference floor was whole seconds)."""

    max_batch_size: int = 32
    max_latency_ms: float = 5.0


@dataclass
class RolloutPolicy:
    """Self-driving canary schedule (TPU-native; the reference keeps the
    two-revision traffic split but leaves stepping to the operator,
    ksvc_reconciler.go:84-118).  When set, the control plane owns
    `canary_traffic_percent`: a new revision starts at 0% (warmup-gated
    until `/v2/health/ready` plus `warmup_probes` probes pass), then
    climbs `steps`, holding `hold_s` at each while the rollout analyzer
    compares the canary's per-revision error rate and latency
    percentile against the stable revision.  A failed gate rolls
    traffic back to stable in one reconcile and quarantines the
    revision's content hash."""

    steps: List[int] = field(default_factory=lambda: [5, 25, 50, 100])
    hold_s: float = 60.0
    # Analysis delay per step: samples observed in the first settle_s
    # seconds after a traffic change are excluded from the gates — a
    # canary's first requests pay cold-start costs (lazy imports,
    # first-predict compile) that must not read as a latency
    # regression against a warmed stable.
    settle_s: float = 1.0
    # Canary 5xx ratio may exceed stable's by at most this much.
    max_error_ratio: float = 0.02
    # Canary p95 may be at most this multiple of stable p95.
    max_latency_regression: float = 1.5
    # Canary requests observed at a step before its gate can pass
    # (0 = a zero-traffic service still promotes on hold_s alone).
    min_requests: int = 0
    # Consecutive ready-probe successes per replica before first traffic.
    warmup_probes: int = 1
    # A revision that never warms is a failed revision, not a pending
    # one: past this budget the rollout rolls back and quarantines
    # like any other failed gate (0 = wait forever).
    warmup_timeout_s: float = 300.0


@dataclass
class ParallelismSpec:
    """Within-replica mesh (TPU-native; reference has no counterpart)."""

    dp: int = 1
    tp: int = 1
    sp: int = 1

    @property
    def chips_per_replica(self) -> int:
        return self.dp * self.tp * self.sp


@dataclass
class ComponentSpec:
    """Shared component knobs (reference component.go:72-95)."""

    min_replicas: int = 1
    max_replicas: int = 1
    container_concurrency: int = 0  # 0 = unlimited
    timeout_seconds: int = 300
    canary_traffic_percent: Optional[int] = None
    logger: Optional[LoggerSpec] = None
    batcher: Optional[BatcherSpec] = None
    # Progressive delivery: when set, canary_traffic_percent is managed
    # by the rollout state machine (control/rollout.py), not operators.
    rollout: Optional[RolloutPolicy] = None
    # Credentials are resolved per service account at replica build
    # (reference pod ServiceAccountName + pkg/credentials package).
    service_account_name: str = "default"


@dataclass
class PredictorSpec(ComponentSpec):
    """Exactly one framework must be set (reference predictor.go:33-59 +
    validation component.go:109-141)."""

    framework: str = "jax"
    storage_uri: str = ""
    runtime_version: str = ""
    protocol_version: str = "v1"
    multi_model: bool = False
    parallelism: ParallelismSpec = field(default_factory=ParallelismSpec)
    hbm_budget_bytes: Optional[int] = None
    # custom framework: explicit command to exec
    command: Optional[List[str]] = None


@dataclass
class TransformerSpec(ComponentSpec):
    command: Optional[List[str]] = None
    storage_uri: str = ""


@dataclass
class ExplainerSpec(ComponentSpec):
    # saliency | anchor_tabular | lime_images | square_attack |
    # fairness | custom (custom needs `command`)
    explainer_type: str = "saliency"
    storage_uri: str = ""
    command: Optional[List[str]] = None


@dataclass
class InferenceService:
    """Top level (reference inference_service.go:24-36)."""

    name: str
    namespace: str = "default"
    predictor: PredictorSpec = field(default_factory=PredictorSpec)
    transformer: Optional[TransformerSpec] = None
    explainer: Optional[ExplainerSpec] = None
    annotations: Dict[str, str] = field(default_factory=dict)
    generation: int = 1

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "InferenceService":
        d = dict(d)
        pred = d.get("predictor") or {}
        if "parallelism" in pred and isinstance(pred["parallelism"], dict):
            pred["parallelism"] = ParallelismSpec(**pred["parallelism"])
        d["predictor"] = PredictorSpec(**_coerce_component(pred))
        if d.get("transformer") and isinstance(d["transformer"], dict):
            d["transformer"] = TransformerSpec(**_coerce_component(
                d["transformer"]))
        if d.get("explainer") and isinstance(d["explainer"], dict):
            d["explainer"] = ExplainerSpec(**_coerce_component(
                d["explainer"]))
        return cls(**d)

    def components(self) -> Dict[str, ComponentSpec]:
        out: Dict[str, ComponentSpec] = {"predictor": self.predictor}
        if self.transformer is not None:
            out["transformer"] = self.transformer
        if self.explainer is not None:
            out["explainer"] = self.explainer
        return out


_COMPONENT_SUBSPECS = {"logger": LoggerSpec, "batcher": BatcherSpec,
                       "rollout": RolloutPolicy}


def _coerce_component(d: Dict[str, Any]) -> Dict[str, Any]:
    d = dict(d)
    for key, cls in _COMPONENT_SUBSPECS.items():
        if d.get(key) and isinstance(d[key], dict):
            d[key] = cls(**d[key])
    return d


@dataclass
class TrainedModel:
    """Per-model CR for multi-model serving (reference
    pkg/apis/serving/v1alpha1/trained_model.go:49-70)."""

    name: str
    inference_service: str
    storage_uri: str
    framework: str = "jax"
    memory_bytes: int = 0  # declared footprint; feeds sharding + HBM
    namespace: str = "default"

    def to_model_spec(self) -> Dict[str, Any]:
        """models.json entry (reference modelconfig/configmap.go:34-51)."""
        return {
            "modelName": self.name,
            "modelSpec": {
                "storageUri": self.storage_uri,
                "framework": self.framework,
                "memory": self.memory_bytes,
            },
        }
