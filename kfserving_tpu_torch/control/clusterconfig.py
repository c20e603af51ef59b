"""Cluster-tier configuration (tier 1 of the three-tier config system).

The reference keeps cluster-wide serving policy in the
``inferenceservice-config`` ConfigMap — per-framework runtime
images/versions, ingress gateways, logger/batcher/agent resource bounds,
and credential file names (reference config/configmap/
inferenceservice.yaml:1-120, parsed at pkg/apis/serving/v1beta1/
configmap.go:121-158 on every reconcile).  The TPU build has no images;
the per-framework entry is the *entrypoint module* the subprocess
orchestrator execs plus default runtime knobs (the port's entry points,
which serve on the orchestrator's device).

Tier 2 is the InferenceService spec (control/spec.py); tier 3 is process
flags (server/app.py parser).  Spec fields override cluster defaults;
flags are per-process only.
"""

import json
import logging
from dataclasses import dataclass, field
from typing import Dict, Optional

logger = logging.getLogger("kfserving_tpu_torch.control.clusterconfig")

# Per-framework runtime registry (reference configmap `predictors` block:
# image/defaultImageVersion/supportedFrameworks per entry).
DEFAULT_PREDICTOR_RUNTIMES = {
    "jax": {
        "module": "kfserving_tpu_torch.predictors.jaxserver",
        "multiModel": True,
        "defaultTimeout": 300,
    },
    "generative": {
        "module": "kfserving_tpu_torch.predictors.llmserver",
        "multiModel": False,
        "defaultTimeout": 300,
    },
    # The tabular predictors (host numpy) and the torchserver (on the
    # card), each with its own server module.
    "sklearn": {
        "module": "kfserving_tpu_torch.predictors.sklearnserver",
        "multiModel": False,
        "defaultTimeout": 60,
    },
    "xgboost": {
        "module": "kfserving_tpu_torch.predictors.xgbserver",
        "multiModel": False,
        "defaultTimeout": 60,
    },
    "lightgbm": {
        "module": "kfserving_tpu_torch.predictors.lgbserver",
        "multiModel": False,
        "defaultTimeout": 60,
    },
    "pmml": {
        "module": "kfserving_tpu_torch.predictors.pmmlserver",
        "multiModel": False,
        "defaultTimeout": 60,
    },
    "pytorch": {
        "module": "kfserving_tpu_torch.predictors.torchserver",
        "multiModel": False,
        "defaultTimeout": 60,
    },
    # External server runtimes (reference TFServing/Triton/ONNX images;
    # SURVEY §2.1 "keep all 9").  `command` is the server binary (a
    # deployment concern — point it at the installed binary or a
    # wrapper); `argStyle` picks the runtime's own CLI convention in
    # subprocess_orchestrator._external_command.
    "tensorflow": {
        "command": ["tensorflow_model_server"],
        "argStyle": "tfserving",
        "defaultImageVersion": "1.14.0",
        "defaultTimeout": 60,
    },
    "triton": {
        "command": ["tritonserver"],
        "argStyle": "triton",
        "defaultImageVersion": "20.03-py3",
        "defaultTimeout": 60,
    },
    "onnx": {
        "command": ["onnx_server"],
        "argStyle": "onnx",
        "defaultImageVersion": "v1.0.0",
        "defaultTimeout": 60,
    },
}


@dataclass
class IngressConfig:
    """Reference `ingress` block (gateway + service); here: bind address."""

    host: str = "127.0.0.1"
    port: int = 8080


@dataclass
class LoggerConfig:
    """Payload logger bounds (reference agent_injector.go:64-113 caps the
    sidecar's resources; here the worker pool / queue are the bound)."""

    workers: int = 5
    max_queue: int = 100


@dataclass
class BatcherConfig:
    """Cluster ceilings for per-isvc batcher requests (the reference caps
    the sidecar's memory; the TPU analogue caps compiled-shape count)."""

    max_batch_size_limit: int = 256
    min_latency_ms: float = 0.5


@dataclass
class AutoscalerConfig:
    target_concurrency: float = 4.0
    tick_seconds: float = 2.0
    # Predictive control loop (control/predictive.py): feed-forward
    # sizing off the router's burn rates + standby pre-arming +
    # brownout admission.  Engages only for models with declared SLO
    # objectives (KFS_SLO_*); `predictive: false` restores the pure
    # reactive loop.
    predictive: bool = True
    # Control-plane burn windows (seconds, short -> long) and alert
    # threshold for the fast-burn trigger.
    predictive_windows_s: list = field(
        default_factory=lambda: [10.0, 60.0])
    burn_alert: float = 2.0
    # Brownout exit hysteresis: short-window burn must sit below
    # burn_exit for exit_ticks consecutive ticks per level step-down.
    burn_exit: float = 1.0
    exit_ticks: int = 3
    # Slope-aware gap sizing (off by default): inflate the
    # observed service time by the history detector's latency trend
    # slope projected `slope_horizon_s` ahead, so the predictive
    # sizing provisions for where p99 is heading.  Off = the sizing
    # math is exactly the pre-history behavior.
    slope_aware: bool = False
    slope_horizon_s: float = 15.0


@dataclass
class CredentialsConfig:
    """Reference `credentials` block (configmap keys
    gcsCredentialFileName / s3AccessKeyIDName / ...)."""

    gcs_credential_file_name: str = "gcloud-application-credentials.json"
    s3_access_key_id_name: str = "awsAccessKeyID"
    s3_secret_access_key_name: str = "awsSecretAccessKey"
    # Path to the secret-store JSON (storage/credentials.py schema);
    # the single-host analogue of K8s Secret objects.
    store_file: Optional[str] = None


@dataclass
class ClusterConfig:
    predictors: Dict[str, dict] = field(
        default_factory=lambda: {
            k: dict(v) for k, v in DEFAULT_PREDICTOR_RUNTIMES.items()})
    ingress: IngressConfig = field(default_factory=IngressConfig)
    logger: LoggerConfig = field(default_factory=LoggerConfig)
    batcher: BatcherConfig = field(default_factory=BatcherConfig)
    autoscaler: AutoscalerConfig = field(default_factory=AutoscalerConfig)
    credentials: CredentialsConfig = field(
        default_factory=CredentialsConfig)
    # Where TrainedModel shard configs (models.json) are written.
    modelconfig_dir: Optional[str] = None

    @classmethod
    def load(cls, path: Optional[str]) -> "ClusterConfig":
        """Parse a JSON config file; absent path/file -> all defaults
        (the reference reads the ConfigMap on every reconcile; a restart
        picks up changes here)."""
        cfg = cls()
        if not path:
            return cfg
        with open(path) as f:
            data = json.load(f)
        return cls.from_dict(data)

    @classmethod
    def from_dict(cls, data: dict) -> "ClusterConfig":
        cfg = cls()
        for name, entry in (data.get("predictors") or {}).items():
            base = cfg.predictors.setdefault(name, {})
            base.update(entry)
        for key, klass in (("ingress", IngressConfig),
                           ("logger", LoggerConfig),
                           ("batcher", BatcherConfig),
                           ("autoscaler", AutoscalerConfig),
                           ("credentials", CredentialsConfig)):
            if isinstance(data.get(key), dict):
                setattr(cfg, key, klass(**data[key]))
        if data.get("modelconfig_dir"):
            cfg.modelconfig_dir = data["modelconfig_dir"]
        return cfg

    def runtime_for(self, framework: str) -> dict:
        entry = self.predictors.get(framework)
        if entry is None:
            raise KeyError(
                f"no predictor runtime configured for framework "
                f"{framework!r} (configured: {sorted(self.predictors)})")
        return entry
