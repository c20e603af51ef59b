"""Shared base of the tabular predictors (host numpy, per batch).

Port of ``kfserving_tpu/predictors/tabular.py``.  The sklearn, xgboost,
lightgbm and pmml servers differ only in how they find and load their
artifact and how they predict a batch; this base holds the rest: pull
``model_dir`` through ``Storage.download``, find exactly one artifact by
extension, serve V1 instances and V2 tensors (the JSON and the binary
wire both reach ``_predict_v2``) through the batch-predict hook.

They compute on the host, as the JAX package's do: a tree walk or an
sklearn ``predict`` over a few rows moves no tensor to the card.
"""

import glob
import logging
import os
from typing import Any, List, Sequence

import numpy as np

from kfserving_tpu_torch.model.model import Model
from kfserving_tpu_torch.protocol import v1
from kfserving_tpu_torch.protocol.errors import InferenceError, InvalidInput
from kfserving_tpu_torch.protocol.v2 import InferRequest
from kfserving_tpu_torch.protocol.v2 import make_response as v2_make_response
from kfserving_tpu_torch.storage import Storage

logger = logging.getLogger("kfserving_tpu_torch.predictors.tabular")


class TabularModel(Model):
    """Base: download model_dir, find the artifact by extension, load it
    with the framework (or a native evaluator), serve batch predict."""

    ARTIFACT_EXTENSIONS: Sequence[str] = ()

    def __init__(self, name: str, model_dir: str):
        super().__init__(name)
        self.model_dir = model_dir
        self._model = None

    # -- framework hooks ---------------------------------------------------
    def _load_artifact(self, path: str):
        raise NotImplementedError

    def _predict_batch(self, batch: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    # -- lifecycle ---------------------------------------------------------
    def find_artifact(self, local_dir: str) -> str:
        paths: List[str] = []
        for ext in self.ARTIFACT_EXTENSIONS:
            paths += glob.glob(os.path.join(local_dir, f"*{ext}"))
        if len(paths) == 0:
            raise InvalidInput(
                f"no model artifact matching {list(self.ARTIFACT_EXTENSIONS)}"
                f" under {local_dir}")
        if len(paths) > 1:
            # Exactly one model file per server directory.
            raise InvalidInput(
                f"multiple model artifacts found: {sorted(paths)}")
        return paths[0]

    def load(self) -> bool:
        local_dir = Storage.download(self.model_dir)
        artifact = self.find_artifact(local_dir)
        self._model = self._load_artifact(artifact)
        logger.info("loaded %s from %s", self.name, artifact)
        self.ready = True
        return True

    def unload(self) -> None:
        self._model = None
        self.ready = False

    # -- inference ---------------------------------------------------------
    async def predict(self, request: Any) -> Any:
        if self.predictor_host:
            return await super().predict(request)
        if self._model is None:
            raise InferenceError(f"model {self.name} not loaded")
        if isinstance(request, InferRequest) or (
                isinstance(request, dict)
                and isinstance(request.get("inputs"), list)
                and request["inputs"]
                and isinstance(request["inputs"][0], dict)
                and "datatype" in request["inputs"][0]):
            # V2, the binary tensor extension included: one input tensor
            # maps straight onto the batch-predict hook.
            return self._predict_v2(request)
        instances = v1.get_instances(request)
        try:
            batch = np.asarray(instances)
        except Exception as e:
            raise InvalidInput(f"failed to build batch array: {e}")
        result = self._run(batch)
        if isinstance(result, np.ndarray):
            payload = result.tolist()
        else:
            # Mixed-type rows (PMML's [label, prob, ...]) must not go
            # through np.asarray: it would turn the numbers into strings.
            payload = [r.tolist() if isinstance(r, np.ndarray) else r
                       for r in result]
        return v1.make_response(payload)

    def _predict_v2(self, request: Any) -> Any:
        req = (request if isinstance(request, InferRequest)
               else InferRequest.from_dict(request))
        named = req.named_numpy()
        if len(named) != 1:
            raise InvalidInput(
                f"tabular predictor takes one input tensor, got "
                f"{sorted(named)}")
        batch = next(iter(named.values()))
        result = self._run(batch)
        outputs = (result if isinstance(result, np.ndarray)
                   else np.asarray(result))
        return v2_make_response(self.name, {"output_0": outputs},
                                id=req.id)

    def _run(self, batch: np.ndarray) -> Any:
        try:
            return self._predict_batch(batch)
        except Exception as e:
            raise InferenceError(f"Failed to predict: {e}")
