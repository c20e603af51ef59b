"""ServingManager: the deployable control-plane process.

The reference's manager binary wires schemes, both reconcilers, and the
webhooks into one controller-runtime manager (reference
cmd/manager/main.go:59-186).  The TPU equivalent wires the controller,
ingress router, autoscaler, and control API into one asyncio process:

    python -m kfserving_tpu_torch.control serve \
        --config cluster.json --control-port 8081 --ingress-port 8080 \
        --orchestrator subprocess --apply isvc.json [--device cuda]

Data-plane traffic enters the ingress router (the Istio VS + activator
role); declarative specs enter the control API (the apiserver role); the
autoscaler ticks in the background (the KPA role); replicas are actuated
in-process or as subprocesses, serving on ``device`` (the card unless
the caller asks for the CPU).

Port of ``kfserving_tpu/control/manager.py``; it wires the port's
controller, router, autoscaler, predictive scaler, rollout manager, API
and credential store.
"""

import asyncio
import json
import logging
import signal
from typing import List, Optional

from kfserving_tpu_torch.control.api import ControlAPI
from kfserving_tpu_torch.control.autoscaler import Autoscaler
from kfserving_tpu_torch.control.clusterconfig import ClusterConfig
from kfserving_tpu_torch.control.controller import Controller
from kfserving_tpu_torch.control.orchestrator import InProcessOrchestrator
from kfserving_tpu_torch.control.predictive import PredictiveScaler
from kfserving_tpu_torch.control.rollout import RolloutManager
from kfserving_tpu_torch.control.router import IngressRouter
from kfserving_tpu_torch.control.spec import InferenceService
from kfserving_tpu_torch.control.subprocess_orchestrator import (
    SubprocessOrchestrator,
)

logger = logging.getLogger("kfserving_tpu_torch.control.manager")


def _load_spec_file(path: str) -> object:
    with open(path) as f:
        return json.load(f)


class ServingManager:
    def __init__(self, cluster_config: Optional[ClusterConfig] = None,
                 orchestrator: str = "inprocess",
                 control_port: int = 8081,
                 ingress_port: Optional[int] = None,
                 host: Optional[str] = None,
                 device: str = "cuda"):
        self.cluster_config = cluster_config or ClusterConfig()
        # Tier precedence: explicit args (tier 3) over the cluster
        # config's ingress block (tier 1).
        if ingress_port is None:
            ingress_port = self.cluster_config.ingress.port
        if host is None:
            host = self.cluster_config.ingress.host
        from kfserving_tpu_torch.storage.credentials import CredentialStore

        credentials = CredentialStore.load(
            self.cluster_config.credentials.store_file,
            gcs_file_name=(
                self.cluster_config.credentials.gcs_credential_file_name))
        if orchestrator == "subprocess":
            self.orchestrator = SubprocessOrchestrator(
                self.cluster_config, host=host, credentials=credentials,
                device=device)
        elif orchestrator == "inprocess":
            self.orchestrator = InProcessOrchestrator(
                credentials=credentials, device=device)
        else:
            raise ValueError(
                f"unknown orchestrator backend {orchestrator!r} "
                f"(inprocess | subprocess)")
        self.controller = Controller(
            self.orchestrator,
            modelconfig_dir=self.cluster_config.modelconfig_dir)
        # Predictive SLO control loop: brownout admission
        # at the router + feed-forward sizing in the autoscaler.
        # Constructed whenever enabled; it stays dormant until a model
        # declares SLO objectives (KFS_SLO_*).
        scaler_cfg = self.cluster_config.autoscaler
        self.brownout = None
        self.predictive = None
        if scaler_cfg.predictive:
            from kfserving_tpu_torch.reliability import BrownoutController

            self.brownout = BrownoutController()
        self.router = IngressRouter(self.controller,
                                    http_port=ingress_port,
                                    brownout=self.brownout)
        if scaler_cfg.predictive:
            self.predictive = PredictiveScaler(
                self.controller, self.router,
                windows_s=tuple(scaler_cfg.predictive_windows_s),
                burn_alert=scaler_cfg.burn_alert,
                burn_exit=scaler_cfg.burn_exit,
                exit_ticks=scaler_cfg.exit_ticks,
                brownout=self.brownout,
                slope_aware=scaler_cfg.slope_aware,
                slope_horizon_s=scaler_cfg.slope_horizon_s)
        self.autoscaler = Autoscaler(
            self.controller, self.router,
            target_concurrency=scaler_cfg.target_concurrency,
            tick_seconds=scaler_cfg.tick_seconds,
            predictive=self.predictive)
        # Progressive delivery: steps canaries up their RolloutPolicy
        # schedule and auto-rolls back failed revisions (no-op for
        # specs without a rollout policy).
        self.rollouts = RolloutManager(self.controller)
        self.api = ControlAPI(
            self.controller, http_port=control_port,
            credentials=credentials,
            credentials_path=self.cluster_config.credentials.store_file)
        self.host = host

    # -- lifecycle ----------------------------------------------------------
    async def start_async(self) -> None:
        # Router first: it publishes cluster_local_url, which the
        # orchestrator bakes into explainer/transformer replicas as
        # predictor_host.  Starting the control API first would open a
        # window where an apply builds replicas with predictor_host
        # None permanently.
        await self.router.start_async(self.host)
        await self.api.start_async(self.host)
        await self.autoscaler.start()
        await self.rollouts.start()
        logger.info("control API on %s:%d, ingress on %s:%d",
                    self.host, self.api.http_port,
                    self.host, self.router.http_port)

    async def stop_async(self) -> None:
        await self.rollouts.stop()
        await self.autoscaler.stop()
        await self.api.stop_async()
        await self.router.stop_async()
        for name in list(self.controller.specs):
            ns, isvc_name = name.split("/", 1)
            await self.controller.remove(isvc_name, ns)
        shutdown = getattr(self.orchestrator, "shutdown", None)
        if shutdown is not None:
            await shutdown()

    async def apply_files(self, paths: List[str]) -> None:
        """Apply spec files at startup (kubectl-apply-at-boot).

        File reads go through an executor (kfslint async-blocking):
        by the time apply_files runs, start_async has the router and
        API serving on this same loop, so a slow spec volume would
        stall live traffic."""
        loop = asyncio.get_running_loop()
        for path in paths:
            data = await loop.run_in_executor(None, _load_spec_file,
                                              path)
            items = data if isinstance(data, list) else [data]
            for item in items:
                isvc = InferenceService.from_dict(item)
                status = await self.controller.apply(isvc)
                logger.info("applied %s/%s (ready=%s)",
                            isvc.namespace, isvc.name, status.ready)

    def run(self, apply: Optional[List[str]] = None) -> None:
        """Blocking entrypoint with graceful signal-driven shutdown."""
        async def _main():
            await self.start_async()
            if apply:
                await self.apply_files(apply)
            stop = asyncio.Event()
            loop = asyncio.get_running_loop()
            for sig in (signal.SIGINT, signal.SIGTERM):
                try:
                    loop.add_signal_handler(sig, stop.set)
                except NotImplementedError:
                    pass
            await stop.wait()
            logger.info("shutting down")
            await self.stop_async()

        asyncio.run(_main())
