"""Model repository: name -> Model registry with load/unload.

Port of ``kfserving_tpu/model/repository.py``.
"""

import inspect
from typing import Dict, List, Optional

from kfserving_tpu_torch.model.model import Model


class ModelRepository:
    def __init__(self):
        self.models: Dict[str, Model] = {}

    def get_model(self, name: str) -> Optional[Model]:
        return self.models.get(name)

    def get_models(self) -> List[Model]:
        return list(self.models.values())

    def is_model_ready(self, name: str) -> bool:
        model = self.get_model(name)
        return bool(model and model.ready)

    def update(self, model: Model) -> None:
        self.models[model.name] = model


async def maybe_await(value):
    if inspect.isawaitable(value):
        return await value
    return value
