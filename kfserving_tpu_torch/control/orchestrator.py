"""Actuation backends: turn desired replicas into running servers.

The reference delegates actuation to Knative (the reconciler creates a
Knative Service and Knative makes pods, reference
ksvc_reconciler.go:153-187).  Here actuation is an interface with two
backends:

- InProcessOrchestrator: replicas are real ModelServer instances in this
  process on ephemeral ports — the single-host deployment mode and the
  test backend (the envtest analogue, SURVEY.md §4: real serving, no
  cluster).  Every model it builds serves on its ``device`` (the card
  unless the caller asks for the CPU); a replica that cannot reach its
  device fails its create.
- FakeOrchestrator: records desired state for pure reconciler-logic tests
  (golden-object style, reference ingress_reconciler_test.go).

A replica handle is (component_id, revision, host) — the router routes to
hosts and never knows which backend made them.
"""

import asyncio
import functools
import logging
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger("kfserving_tpu_torch.control.orchestrator")


@dataclass
class Replica:
    component_id: str      # "<namespace>/<isvc>/<component>"
    revision: str          # content hash of the component spec
    host: str              # "127.0.0.1:<port>" (in-process backend)
    handle: object = None  # backend-private
    placement: object = None  # SlicePlacement for chip-owning replicas
    # The ComponentSpec the replica was built from (the subprocess
    # backend keeps its copy in _Proc.spec).
    spec: object = None


@dataclass
class _ComponentState:
    replicas: List[Replica] = field(default_factory=list)


class FakeOrchestrator:
    """Records desired replicas; hosts are synthetic."""

    def __init__(self):
        self.state: Dict[str, _ComponentState] = {}
        self._port = 30000

    def replicas(self, component_id: str) -> List[Replica]:
        return list(self.state.get(component_id,
                                   _ComponentState()).replicas)

    async def create_replica(self, component_id: str, revision: str,
                             spec, placement=None) -> Replica:
        self._port += 1
        replica = Replica(component_id, revision,
                          f"fake-host:{self._port}", placement=placement)
        self.state.setdefault(component_id,
                              _ComponentState()).replicas.append(replica)
        return replica

    async def delete_replica(self, replica: Replica) -> None:
        comp = self.state.get(replica.component_id)
        if comp and replica in comp.replicas:
            comp.replicas.remove(replica)


class InProcessOrchestrator:
    """Replicas are ModelServers running in this process.

    model_factory(component_id, spec) -> Model | None builds the served
    model for a replica; the default factory understands the port's
    predictor frameworks (jax, generative, the multi-model repository,
    the tabular predictors and pytorch) and the explainers, and builds
    each device-placing model on ``device``.  Loading runs in a thread
    (compile/IO off the loop).
    """

    def __init__(self, model_factory: Optional[Callable] = None,
                 credentials=None, device: Any = "cuda"):
        self.device = device
        self.model_factory = model_factory or functools.partial(
            default_model_factory, device=device)
        # CredentialStore; in-process replicas share this process, so
        # the per-service-account env lands in os.environ at build time
        # (single-host dev mode — subprocess replicas get isolated env).
        self.credentials = credentials
        # Serializes credentialed builds: env mutation + load must not
        # interleave across service accounts (shared os.environ).
        self._cred_lock = asyncio.Lock()
        self.state: Dict[str, _ComponentState] = {}
        # Warm-standby pool: fully built replicas kept OUT of the
        # serving state, adopted by scale-ups so a predicted traffic
        # step actuates in one tick instead of a model build and load.
        # (cid, revision) -> [Replica, ...]; pool depth per component is
        # _standby_targets (default 0: unlike the subprocess backend
        # there is no crash to fail over, so the pool exists only while
        # the predictive loop pre-arms it).
        self._standbys: Dict[tuple, List[Replica]] = {}
        self._standby_targets: Dict[str, int] = {}
        self._standby_arming: Dict[tuple, int] = {}
        self.standby_adoptions = 0
        # Cluster-local gateway address ("host:port"), published by the
        # ingress router at start.  Explainer/transformer replicas get
        # their predictor_host derived from it — the reference injects
        # the predictor's cluster-local URL into those containers
        # (explainer_alibi.go:79-100 --predictor_host).
        self.cluster_local_url: Optional[str] = None

    def replicas(self, component_id: str) -> List[Replica]:
        return list(self.state.get(component_id,
                                   _ComponentState()).replicas)

    # -- warm-standby pool (predictive pre-arming) --------------------------
    def set_standby_target(self, component_id: str, target: int) -> None:
        """Pre-arm `target` standbys for a component's latest serving
        revision (the predictive autoscaler's actuator).  Arming runs
        as background tasks — the control loop's tick never blocks on
        a model load.  A SHRINKING target reaps the excess at once:
        this backend has no maintenance tick to trim the pool later,
        and an idle armed replica holds a whole model on the card."""
        target = max(0, min(int(target), 8))
        self._standby_targets[component_id] = target
        for key, pool in list(self._standbys.items()):
            if key[0] != component_id:
                continue
            while len(pool) > target:
                standby = pool.pop()
                asyncio.ensure_future(self._stop_server(standby.handle))
            if not pool:
                self._standbys.pop(key, None)
        comp = self.state.get(component_id)
        if target == 0 or comp is None or not comp.replicas:
            return
        latest = comp.replicas[-1]
        key = (component_id, latest.revision)
        have = len(self._standbys.get(key, ())) + \
            self._standby_arming.get(key, 0)
        for _ in range(max(0, target - have)):
            self._standby_arming[key] = \
                self._standby_arming.get(key, 0) + 1
            asyncio.ensure_future(self._arm_standby(
                key, latest.spec, latest.placement))

    def standby_target(self, component_id: str) -> int:
        return self._standby_targets.get(component_id, 0)

    def standby_count(self, component_id: str) -> int:
        return sum(len(pool)
                   for (cid, _rev), pool in self._standbys.items()
                   if cid == component_id)

    async def _arm_standby(self, key: tuple, spec, placement) -> None:
        cid, rev = key
        try:
            standby = await self._build_replica(cid, rev, spec,
                                                placement)
        except Exception:
            logger.exception("arming in-process standby for %s failed",
                             cid)
            return
        finally:
            n = self._standby_arming.get(key, 1) - 1
            if n <= 0:
                self._standby_arming.pop(key, None)
            else:
                self._standby_arming[key] = n
        comp = self.state.get(cid)
        if comp is None or not any(r.revision == rev
                                   for r in comp.replicas):
            await self._stop_server(standby.handle)  # retired meanwhile
            return
        if len(self._standbys.get(key, ())) >= \
                self._standby_targets.get(cid, 0):
            # Target shrank while this one armed: don't overfill.
            await self._stop_server(standby.handle)
            return
        self._standbys.setdefault(key, []).append(standby)
        logger.info("in-process standby armed for %s rev=%s at %s",
                    cid, rev[:8], standby.host)

    async def adopt_standby(self, component_id: str,
                            revision: str) -> Optional[Replica]:
        """Scale-up fast path: enter an armed standby into serving.
        None when the pool is dry (caller cold-builds)."""
        pool = self._standbys.get((component_id, revision))
        if not pool:
            return None
        standby = pool.pop(0)
        if not pool:
            self._standbys.pop((component_id, revision), None)
        self.state.setdefault(component_id,
                              _ComponentState()).replicas.append(standby)
        self.standby_adoptions += 1
        from kfserving_tpu_torch.observability import metrics as obs

        obs.lifecycle_promotions_total().labels(
            trigger="scale_up", outcome="promoted").inc()
        logger.info("scale-up adopted in-process standby %s for %s",
                    standby.host, component_id)
        return standby

    async def reap_standbys(self, component_id: str,
                            revision: Optional[str] = None) -> None:
        for key, pool in list(self._standbys.items()):
            cid, rev = key
            if cid != component_id:
                continue
            if revision is not None and rev != revision:
                continue
            self._standbys.pop(key, None)
            for standby in pool:
                await self._stop_server(standby.handle)

    async def create_replica(self, component_id: str, revision: str,
                             spec, placement=None) -> Replica:
        replica = await self._build_replica(component_id, revision,
                                            spec, placement)
        self.state.setdefault(component_id,
                              _ComponentState()).replicas.append(replica)
        logger.info("replica up: %s rev=%s at %s",
                    component_id, revision[:8], replica.host)
        return replica

    async def _load_or_register(self, model) -> None:
        """Off-loop load (single model) or catalog registration
        (multi-model repository) for a freshly built replica.  Callers
        that inject storage credentials run this inside the credential
        scope — the repository sweep's per-model downloads need them
        exactly like a single model's load does."""
        from kfserving_tpu_torch.model.repository import ModelRepository

        if model is None:
            return
        loop = asyncio.get_running_loop()
        if isinstance(model, ModelRepository):
            register_all = getattr(model, "register_all", None)
            if register_all is not None:
                # Registration of a model set runs off-loop (file I/O
                # per model directory).
                await loop.run_in_executor(None, register_all)
        elif not model.ready:
            await loop.run_in_executor(None, model.load)

    async def _build_replica(self, component_id: str, revision: str,
                             spec, placement=None) -> Replica:
        from kfserving_tpu_torch.model.repository import ModelRepository
        from kfserving_tpu_torch.server.app import ModelServer

        if self.credentials is not None:
            import os

            env = self.credentials.build_env(
                getattr(spec, "service_account_name", "default"))
            # Hold the lock across env-set + load so a concurrent build
            # for another service account can't swap credentials out
            # from under this model's storage download; restore the
            # ambient values afterwards.
            async with self._cred_lock:
                saved = {k: os.environ.get(k) for k in env}
                os.environ.update(env)
                try:
                    model = self.model_factory(component_id, spec)
                    # Registration/load runs INSIDE the credential
                    # scope: a multi-model catalog sweep downloads
                    # per-model artifacts with the same service
                    # account as a single model's load would.
                    await self._load_or_register(model)
                finally:
                    for k, old in saved.items():
                        if old is None:
                            os.environ.pop(k, None)
                        else:
                            os.environ[k] = old
        else:
            model = self.model_factory(component_id, spec)
            await self._load_or_register(model)
        # A factory may return a whole ModelRepository instead of one
        # model: the multi-model replica shape (TrainedModel-style
        # repositories with demand-paged HBM residency) — the server
        # fronts the repository instead of a model list.
        repository = model if isinstance(model, ModelRepository) \
            else None
        if repository is not None:
            model = None
        self._inject_predictor_host(model, spec)
        server = ModelServer(
            http_port=0,
            registered_models=repository,
            container_concurrency=getattr(
                spec, "container_concurrency", 0) or 0)
        # One injector serves every in-process replica: dataplane.infer
        # faults scope to a revision through its key.
        server.dataplane.revision = revision
        await server.start_async([model] if model is not None else [],
                                 host="127.0.0.1")
        return Replica(component_id, revision,
                       f"127.0.0.1:{server.http_port}", handle=server,
                       placement=placement, spec=spec)

    def _inject_predictor_host(self, model, spec) -> None:
        """Point an explainer/transformer replica's model at the isvc's
        predictor through the router's direct lane (the reference's
        cluster-local predictor URL, kfmodel.py:24-27)."""
        from kfserving_tpu_torch.control.spec import (
            ExplainerSpec,
            TransformerSpec,
        )

        if model is None or self.cluster_local_url is None:
            return
        if not isinstance(spec, (ExplainerSpec, TransformerSpec)):
            return
        if getattr(model, "predictor_host", None):
            return  # explicitly configured wins
        model.predictor_host = \
            f"{self.cluster_local_url}/direct/predictor"

    async def delete_replica(self, replica: Replica) -> None:
        comp = self.state.get(replica.component_id)
        if comp and replica in comp.replicas:
            comp.replicas.remove(replica)
        server = replica.handle
        if server is not None:
            await self._stop_server(server)
        logger.info("replica down: %s at %s",
                    replica.component_id, replica.host)

    @staticmethod
    async def _stop_server(server) -> None:
        """Stop a replica's server, then close and unload the models it
        served, so a scale-down returns their device memory at once
        (their engines' threads hold references the garbage collector
        would not drop)."""
        await server.stop_async()
        for model in list(server.repository.get_models()):
            try:
                await model.close()
                model.unload()
            except Exception:
                logger.exception("releasing model %s failed", model.name)

    async def shutdown(self):
        # Armed standbys live outside self.state: stop them first.
        for key, pool in list(self._standbys.items()):
            self._standbys.pop(key, None)
            for standby in pool:
                await self._stop_server(standby.handle)
        for comp in list(self.state.values()):
            for replica in list(comp.replicas):
                await self.delete_replica(replica)


def default_model_factory(component_id: str, spec, device: Any = "cuda"):
    """Build the served model for a component spec, on ``device``.

    component kinds map to the reference's container images (SURVEY.md
    §2.1 per-framework predictor specs); model name is the isvc name so
    routes match /v1/models/<isvc>:predict.
    """
    from kfserving_tpu_torch.control.spec import (
        ExplainerSpec,
        PredictorSpec,
        TransformerSpec,
    )

    isvc_name = component_id.split("/")[1]
    if isinstance(spec, PredictorSpec):
        if spec.multi_model:
            if spec.framework != "jax":
                raise ValueError(
                    f"multi-model predictors serve the jax repository "
                    f"shape, not {spec.framework!r}")
            from kfserving_tpu_torch.engine.hbm import HBMManager
            from kfserving_tpu_torch.predictors.jaxserver.repository import (
                TorchModelRepository,
            )

            # storage_uri is the model CATALOG root (one subdir per
            # TrainedModel); every model registers host-side at boot
            # and HBM residency is demand-paged under the spec's
            # per-replica budget — the TrainedModel CRD + agent-puller
            # economics with millisecond activation.
            return TorchModelRepository(
                models_dir=spec.storage_uri,
                hbm=HBMManager(budget_bytes=spec.hbm_budget_bytes),
                device=device)
        if spec.framework == "jax":
            from kfserving_tpu_torch.predictors.torch_model import (
                TorchModel,
            )

            # The spec's ParallelismSpec decides the within-replica mesh
            # (placement is a deployment concern; the artifact's
            # config.json stays mesh-agnostic — SURVEY.md §5.8).
            par = getattr(spec, "parallelism", None)
            overrides = {}
            if par is not None and par.chips_per_replica > 1:
                overrides["mesh"] = {
                    "dp": par.dp, "tp": par.tp, "sp": par.sp}
            return TorchModel(isvc_name, spec.storage_uri,
                              config_overrides=overrides, device=device)
        if spec.framework == "generative":
            from kfserving_tpu_torch.predictors.llm import GenerativeModel

            par = getattr(spec, "parallelism", None)
            overrides = {}
            if par is not None and par.chips_per_replica > 1:
                overrides["mesh"] = {
                    "dp": par.dp, "tp": par.tp, "sp": par.sp}
            return GenerativeModel(isvc_name, spec.storage_uri,
                                   config_overrides=overrides,
                                   device=device)
        # The tabular predictors compute on the host; the torchserver
        # places its module on the orchestrator's device.
        if spec.framework == "sklearn":
            from kfserving_tpu_torch.predictors.sklearnserver import (
                SKLearnModel,
            )

            return SKLearnModel(isvc_name, spec.storage_uri)
        if spec.framework == "xgboost":
            from kfserving_tpu_torch.predictors.xgbserver import XGBoostModel

            return XGBoostModel(isvc_name, spec.storage_uri)
        if spec.framework == "lightgbm":
            from kfserving_tpu_torch.predictors.lgbserver import (
                LightGBMModel,
            )

            return LightGBMModel(isvc_name, spec.storage_uri)
        if spec.framework == "pmml":
            from kfserving_tpu_torch.predictors.pmmlserver import PMMLModel

            return PMMLModel(isvc_name, spec.storage_uri)
        if spec.framework == "pytorch":
            from kfserving_tpu_torch.predictors.torchserver import (
                PyTorchModel,
            )

            return PyTorchModel(isvc_name, spec.storage_uri, device=device)
        raise ValueError(
            f"in-process orchestrator cannot run framework "
            f"{spec.framework!r}")
    if isinstance(spec, ExplainerSpec):
        from kfserving_tpu_torch.explainers import build_explainer

        return build_explainer(isvc_name, spec.explainer_type,
                               spec.storage_uri, device=device)
    if isinstance(spec, TransformerSpec):
        raise ValueError(
            "transformer replicas need a custom model_factory (their "
            "preprocess code is user-supplied)")
    raise ValueError(f"unknown component spec {type(spec).__name__}")
