"""Model repository: name -> Model registry with load/unload.

Port of ``kfserving_tpu/model/repository.py``.  ``load`` and ``unload``
are async so a repository that builds models from artifacts on disk
(``predictors/jaxserver/repository.py``) keeps the serving loop free.
"""

import inspect
from typing import Dict, List, Optional

from kfserving_tpu_torch.model.model import Model

MODEL_MOUNT_DIRS = "/mnt/models"


class ModelRepository:
    def __init__(self, models_dir: str = MODEL_MOUNT_DIRS):
        self.models: Dict[str, Model] = {}
        self.models_dir = models_dir

    def set_models_dir(self, models_dir: str) -> None:
        self.models_dir = models_dir

    def get_model(self, name: str) -> Optional[Model]:
        return self.models.get(name)

    def get_models(self) -> List[Model]:
        return list(self.models.values())

    def is_model_ready(self, name: str) -> bool:
        model = self.get_model(name)
        return bool(model and model.ready)

    def update(self, model: Model) -> None:
        self.models[model.name] = model

    async def load(self, name: str) -> bool:
        """(Re)load a registered model; False when there is none.
        Repositories that build models from artifacts override this."""
        model = self.get_model(name)
        if model is None:
            return False
        return bool(await maybe_await(model.load()))

    async def unload(self, name: str) -> None:
        if name not in self.models:
            raise KeyError(f"model {name} does not exist")
        model = self.models.pop(name)
        await maybe_await(model.unload())


async def maybe_await(value):
    if inspect.isawaitable(value):
        return await value
    return value
