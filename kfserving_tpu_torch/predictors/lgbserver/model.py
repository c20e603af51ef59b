"""lightgbm predictor of the port.

Port of ``kfserving_tpu/predictors/lgbserver/model.py``: the library's
``Booster`` when lightgbm imports, else the native evaluator
(``predictors/trees.py``) over LightGBM's documented text format.  Both
compute on the host.
"""

from kfserving_tpu_torch.predictors.tabular import TabularModel


class LightGBMModel(TabularModel):
    ARTIFACT_EXTENSIONS = (".txt", ".lgb")

    def __init__(self, name: str, model_dir: str, nthread: int = 1):
        super().__init__(name, model_dir)
        self.nthread = nthread
        self._native = None

    def _load_artifact(self, path: str):
        try:
            import lightgbm as lgb
        except ImportError:
            from kfserving_tpu_torch.predictors.trees import LightGBMEnsemble

            self._native = LightGBMEnsemble.from_file(path)
            return self._native
        return lgb.Booster(params={"num_threads": self.nthread},
                           model_file=path)

    def _predict_batch(self, batch):
        if self._native is not None:
            return self._native.predict(batch)
        return self._model.predict(batch)
