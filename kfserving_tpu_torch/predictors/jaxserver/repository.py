"""Multi-model repository of the port's predictor.

Port of ``kfserving_tpu/predictors/jaxserver/repository.py``
(``JaxModelRepository``): every model is a directory
``<models_dir>/<name>`` in the jaxserver artifact format, and loads and
evictions go through one shared ``HBMManager``, since on the card
"loaded" means resident in device memory.

With residency (the default, as in the JAX package) the repository is
demand-paged (``engine/residency.py``): ``load``
(``POST /v2/repository/models/{name}/load``) is declarative
registration, a config read with no device memory, and the predict path
faults models onto the card, with admission-aware LRU eviction making
room; an evicted model keeps its warm engine and its mmap host params
and stays READY.  ``residency=False`` keeps the eager mode: a load
builds the model and admits its bytes at once, and an admission that
overflows the budget unloads least-recently-used models, which show
``UNAVAILABLE`` in the index until they are loaded again.
"""

import asyncio
import logging
import os
from typing import Any, List, Optional

from kfserving_tpu_torch.engine.hbm import HBMManager
from kfserving_tpu_torch.engine.residency import ResidencyManager
from kfserving_tpu_torch.model.repository import (
    MODEL_MOUNT_DIRS,
    ModelRepository,
)
from kfserving_tpu_torch.predictors.torch_model import (
    DEFAULT_CONFIG_NAME,
    TorchModel,
)
from kfserving_tpu_torch.storage import Storage

logger = logging.getLogger("kfserving_tpu_torch.jaxserver")


class TorchModelRepository(ModelRepository):
    def __init__(self, models_dir: str = MODEL_MOUNT_DIRS,
                 hbm: Optional[HBMManager] = None,
                 residency: bool = True, device: Any = "cuda"):
        super().__init__(models_dir)
        self.device = device
        self.hbm = hbm or HBMManager()
        if residency:
            # The manager owns eviction end to end: admission-aware
            # victims against the ledger, offloaded to their host mmap
            # params for the warm fault back in.
            self.residency: Optional[ResidencyManager] = \
                ResidencyManager(self.hbm)
        else:
            self.residency = None
            # Eager mode: accounting decides who leaves; the
            # repository's unload frees.
            self.hbm.evict_cb = self._evict

    def _evict(self, name: str) -> None:
        model = self.get_model(name)
        if model is not None:
            model.unload()

    def _catalog_dir(self) -> str:
        """The catalog root as a local directory, resolved once:
        ``models_dir`` may arrive as a storage URI (``file://``, or a
        remote scheme ``Storage.download`` pulls; blocking, and callers
        already run off the event loop)."""
        if not os.path.isdir(self.models_dir):
            self.models_dir = Storage.download(self.models_dir)
        return self.models_dir

    def _model_for(self, name: str) -> Optional[TorchModel]:
        model = self.get_model(name)
        if model is None:
            model_dir = os.path.join(self._catalog_dir(), name)
            if not os.path.isdir(model_dir):
                return None
            model = TorchModel(name, model_dir, device=self.device,
                               hbm=self.hbm, residency=self.residency)
            self.update(model)
        return model

    async def load(self, name: str) -> bool:
        """Make <models_dir>/<name> servable; False when there is no such
        directory.  Under residency this registers it (its first predict
        faults it in); in eager mode it builds and admits it."""
        model = self._model_for(name)
        if model is None:
            return False
        work = model.register if self.residency is not None else model.load
        # Off the serving loop: a config read, or a build with warmup.
        return bool(await asyncio.get_running_loop().run_in_executor(
            None, work))

    def register_all(self) -> List[str]:
        """Register every model directory of the catalog (blocking;
        residency mode): N models become addressable in N config reads,
        with no device work.  One corrupt model stays unregistered and
        the sweep goes on."""
        if self.residency is None:
            raise RuntimeError("register_all requires residency mode")
        names = []
        root = self._catalog_dir()
        for name in sorted(os.listdir(root)):
            if not os.path.exists(os.path.join(root, name,
                                               DEFAULT_CONFIG_NAME)):
                continue
            try:
                model = self._model_for(name)
                if model is not None and model.register():
                    names.append(name)
            except Exception:
                logger.exception("registration of model %r failed; "
                                 "continuing the catalog sweep", name)
                self.models.pop(name, None)
        return names
