"""Controller: the manager that ties store, reconcilers, and sharding.

Reference: cmd/manager/main.go wires the InferenceService and TrainedModel
reconcilers plus webhooks; here `Controller.apply/delete` run the
defaulting/validation/reconcile pipeline synchronously (no informer lag to
model), and TrainedModel handling drives the HBM shard strategy and the
per-shard models.json files the agent watcher consumes
(reference pkg/controller/v1alpha1/trainedmodel/controller.go:67-147).
"""

import asyncio
import logging
import os
from typing import Dict, List, Optional

from kfserving_tpu_torch.control import modelconfig
from kfserving_tpu_torch.control.reconciler import (
    InferenceServiceReconciler,
    IsvcStatus,
)
from kfserving_tpu_torch.control.sharding import HBMShardStrategy
from kfserving_tpu_torch.control.spec import InferenceService, TrainedModel
from kfserving_tpu_torch.control.validation import (
    ValidationError,
    validate_trained_model,
)

logger = logging.getLogger("kfserving_tpu_torch.control.controller")

DEFAULT_SHARD_BUDGET = 12 * 1024**3  # v5e HBM minus headroom


class Controller:
    def __init__(self, orchestrator, modelconfig_dir: Optional[str] = None,
                 shard_budget_bytes: int = DEFAULT_SHARD_BUDGET):
        self.reconciler = InferenceServiceReconciler(orchestrator)
        self.specs: Dict[str, InferenceService] = {}
        self.trained_models: Dict[str, TrainedModel] = {}
        self.shard_strategies: Dict[str, HBMShardStrategy] = {}
        self.modelconfig_dir = modelconfig_dir
        self.shard_budget_bytes = shard_budget_bytes
        self._shardcfg_lock = asyncio.Lock()

    # -- InferenceService lifecycle ---------------------------------------
    async def apply(self, isvc: InferenceService) -> IsvcStatus:
        """Create-or-update (defaulting + validation + reconcile)."""
        key = f"{isvc.namespace}/{isvc.name}"
        status = await self.reconciler.reconcile(isvc)
        self.specs[key] = isvc
        return status

    async def remove(self, name: str, namespace: str = "default") -> None:
        key = f"{namespace}/{name}"
        isvc = self.specs.pop(key, None)
        if isvc is None:
            return
        # Finalizer deletes child TrainedModels (reference
        # controller.go:208-223).
        for tm_key in [k for k, tm in self.trained_models.items()
                       if tm.inference_service == name
                       and tm.namespace == namespace]:
            await self.remove_trained_model(
                self.trained_models[tm_key].name, namespace)
        await self.reconciler.delete(isvc)

    def get(self, name: str, namespace: str = "default"
            ) -> Optional[InferenceService]:
        return self.specs.get(f"{namespace}/{name}")

    def status_of(self, name: str, namespace: str = "default"
                  ) -> Optional[IsvcStatus]:
        return self.reconciler.status.get(f"{namespace}/{name}")

    # -- TrainedModel lifecycle -------------------------------------------
    async def apply_trained_model(self, tm: TrainedModel) -> dict:
        """Validate, check the parent isvc (exists + multi-model), assign a
        shard, and update that shard's models.json."""
        validate_trained_model(tm)
        parent = self.get(tm.inference_service, tm.namespace)
        if parent is None:
            raise ValidationError(
                f"parent inference service {tm.inference_service} "
                f"not found")
        if not parent.predictor.multi_model:
            raise ValidationError(
                f"inference service {tm.inference_service} is not a "
                f"multi-model predictor")
        strategy = self.shard_strategies.setdefault(
            f"{tm.namespace}/{tm.inference_service}",
            HBMShardStrategy(
                parent.predictor.hbm_budget_bytes
                or self.shard_budget_bytes))
        shard = strategy.get_or_assign(tm)
        self.trained_models[f"{tm.namespace}/{tm.name}"] = tm
        await self._write_shard_config(tm.inference_service,
                                       tm.namespace, strategy, shard)
        # Status URL mirrors the reference (trainedmodel/controller.go:
        # 149-179): <isvc-url>/v1/models/<tm>:predict
        return {"shard": shard,
                "url": f"/v1/models/{tm.name}:predict"}

    async def remove_trained_model(self, name: str,
                                   namespace: str = "default") -> None:
        tm = self.trained_models.pop(f"{namespace}/{name}", None)
        if tm is None:
            return
        strategy = self.shard_strategies.get(
            f"{namespace}/{tm.inference_service}")
        if strategy is None:
            return
        shard = strategy.remove(name)
        if shard is not None:
            await self._write_shard_config(tm.inference_service,
                                           namespace, strategy, shard)

    async def _write_shard_config(self, isvc_name: str, namespace: str,
                                  strategy: HBMShardStrategy,
                                  shard: int) -> None:
        """Write one shard's models.json without stalling the loop
        (kfslint async-blocking: the controller shares the manager's
        event loop with the router, and the modelconfig volume can be
        a slow network mount).  Entries are snapshotted on the loop
        BEFORE the first await — they must reflect the state at call
        time — and writes are serialized so an older snapshot can
        never land after a newer one."""
        if self.modelconfig_dir is None:
            return
        entries: List[dict] = []
        for model_name in strategy.models_on(shard):
            tm = self.trained_models[f"{namespace}/{model_name}"]
            entries.append(tm.to_model_spec())
        path = os.path.join(
            self.modelconfig_dir,
            f"{namespace}-{isvc_name}-shard-{shard}.json")
        async with self._shardcfg_lock:
            await asyncio.get_running_loop().run_in_executor(
                None, modelconfig.write_file, path, entries)
        logger.info("wrote shard config %s (%d models)",
                    path, len(entries))
