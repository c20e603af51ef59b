"""Multi-model repository of the port's predictor.

Port of the eager mode of ``kfserving_tpu/predictors/jaxserver/
repository.py`` (``JaxModelRepository(residency=False)``): every model is a
directory ``<models_dir>/<name>`` in the jaxserver artifact format, a load
(``POST /v2/repository/models/{name}/load``) builds the model and admits
its bytes to one shared ``HBMManager`` at once, and an admission that
overflows the budget unloads the least-recently-used models through the
ledger's ``evict_cb``.  An evicted model stays registered but not ready
(``UNAVAILABLE`` in the repository index) until it is loaded again.

The JAX package's default, demand paging (``residency=True``: a load
only registers the model and the predict path faults it in), waits for
the residency and param-cache slice (ROADMAP Queue 1, slice 1 item c).
"""

import asyncio
import os
from typing import Any, Optional

from kfserving_tpu_torch.engine.hbm import HBMManager
from kfserving_tpu_torch.model.repository import (
    MODEL_MOUNT_DIRS,
    ModelRepository,
)
from kfserving_tpu_torch.predictors.torch_model import (
    TorchModel,
    local_model_dir,
)


class TorchModelRepository(ModelRepository):
    def __init__(self, models_dir: str = MODEL_MOUNT_DIRS,
                 hbm: Optional[HBMManager] = None,
                 residency: bool = False, device: Any = "cuda"):
        if residency:
            raise NotImplementedError(
                "demand-paged residency is not ported yet (ROADMAP Queue "
                "1, slice 1 item c); use residency=False (eager loads)")
        super().__init__(models_dir)
        self.device = device
        self.hbm = hbm or HBMManager()
        # Accounting decides who leaves; the repository's unload frees.
        self.hbm.evict_cb = self._evict

    def _evict(self, name: str) -> None:
        model = self.get_model(name)
        if model is not None:
            model.unload()

    def _model_for(self, name: str) -> Optional[TorchModel]:
        model = self.get_model(name)
        if model is None:
            model_dir = os.path.join(local_model_dir(self.models_dir), name)
            if not os.path.isdir(model_dir):
                return None
            model = TorchModel(name, model_dir, device=self.device,
                               hbm=self.hbm)
            self.update(model)
        return model

    async def load(self, name: str) -> bool:
        """Build <models_dir>/<name> and make it resident; False when
        there is no such directory."""
        model = self._model_for(name)
        if model is None:
            return False
        # Loading builds and warms the model: off the serving loop.
        return bool(await asyncio.get_running_loop().run_in_executor(
            None, model.load))
