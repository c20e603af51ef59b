"""PMML predictor of the port.

Port of ``kfserving_tpu/predictors/pmmlserver/model.py``: pypmml's
``Model.load`` when it imports, else the native evaluator
(``predictors/pmml_eval.py``) for TreeModel and RegressionModel.  Either
way each row evaluates on the host to ``list(outputs.values())``: the
predicted value, then the class probabilities.
"""

from kfserving_tpu_torch.predictors.tabular import TabularModel


class PMMLModel(TabularModel):
    ARTIFACT_EXTENSIONS = (".pmml", ".xml")

    def __init__(self, name: str, model_dir: str):
        super().__init__(name, model_dir)
        self._native = None

    def _load_artifact(self, path: str):
        try:
            from pypmml import Model as PyPmmlModel
        except ImportError:
            from kfserving_tpu_torch.predictors.pmml_eval import (
                PMMLModel as Native,
            )

            self._native = Native(path)
            return self._native
        return PyPmmlModel.load(path)

    def _predict_batch(self, batch):
        if self._native is not None:
            return [list(out.values())
                    for out in self._native.predict(batch)]
        return [list(self._model.predict(list(row)).values())
                for row in batch]
