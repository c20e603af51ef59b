"""sklearn predictor of the port.

Port of ``kfserving_tpu/predictors/sklearnserver/model.py``: a joblib or
pickle artifact, ``np.asarray(instances)`` -> ``model.predict``, on the
host.  ``SKLearnModelRepository`` builds one model per subdirectory of
its models directory on ``load(name)``.
"""

import os
import pickle

from kfserving_tpu_torch.model.repository import (
    MODEL_MOUNT_DIRS,
    ModelRepository,
)
from kfserving_tpu_torch.predictors.tabular import TabularModel


class SKLearnModel(TabularModel):
    ARTIFACT_EXTENSIONS = (".joblib", ".pkl", ".pickle")

    def _load_artifact(self, path: str):
        if path.endswith(".joblib"):
            import joblib

            return joblib.load(path)
        with open(path, "rb") as f:
            return pickle.load(f)  # noqa: S301 - trusted model artifact

    def _predict_batch(self, batch):
        return self._model.predict(batch)


class SKLearnModelRepository(ModelRepository):
    def __init__(self, models_dir: str = MODEL_MOUNT_DIRS):
        super().__init__(models_dir)

    async def load(self, name: str) -> bool:
        model = self.get_model(name)
        if model is None:
            model_dir = os.path.join(self.models_dir, name)
            if not os.path.isdir(model_dir):
                return False
            model = SKLearnModel(name, model_dir)
            self.update(model)
        return bool(model.load())
