"""xgboost predictor of the port.

Port of ``kfserving_tpu/predictors/xgbserver/model.py``.  Two paths, as
in the JAX package:
- with the xgboost library installed: ``Booster`` and ``DMatrix``, for
  any artifact format;
- without it: the native evaluator (``predictors/trees.py``) reads the
  documented JSON model format with numpy.
Both compute on the host.
"""

from kfserving_tpu_torch.predictors.tabular import TabularModel


class XGBoostModel(TabularModel):
    # .bst/.ubj are binary formats only the library reads; model JSON is
    # matched by name (model directories often carry other JSON files,
    # such as config.json, that would trip the one-artifact check).
    ARTIFACT_EXTENSIONS = (".bst", ".ubj", "model.json")

    def __init__(self, name: str, model_dir: str, nthread: int = 1):
        super().__init__(name, model_dir)
        self.nthread = nthread
        self._native = None

    def _load_artifact(self, path: str):
        try:
            import xgboost as xgb
        except ImportError:
            if not path.endswith(".json"):
                raise ImportError(
                    "xgboost is not installed and the native evaluator "
                    "reads only the JSON model format; save with "
                    "booster.save_model('model.json')")
            from kfserving_tpu_torch.predictors.trees import XGBoostEnsemble

            self._native = XGBoostEnsemble.from_file(path)
            return self._native
        return xgb.Booster(params={"nthread": self.nthread},
                           model_file=path)

    def _predict_batch(self, batch):
        if self._native is not None:
            return self._native.predict(batch)
        import xgboost as xgb

        dmatrix = xgb.DMatrix(batch, nthread=self.nthread)
        return self._model.predict(dmatrix)
