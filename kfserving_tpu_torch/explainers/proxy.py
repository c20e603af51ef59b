"""Shared predictor-proxy base for black-box explainers.

Port of ``kfserving_tpu/explainers/proxy.py``.

Every reference explainer deployment (alibi/aix/art) wraps the same
shape: a Model on `:explain` whose inner model calls proxy to the
predictor over HTTP (reference alibiexplainer/explainer.py:66-76,
aixserver/model.py:44-50, artserver/model.py:43-50).  The proxy hands
`Model.predict` an ndarray payload so dense perturbation batches take
the V2 binary wire to the predictor when it speaks it (model.py
_dense_instances) instead of JSON-encoding megabytes of floats per
batch.
"""

import inspect
import json
import os
from typing import Any, Callable, Dict, Optional

import numpy as np

from kfserving_tpu_torch.model.model import Model
from kfserving_tpu_torch.protocol.errors import InvalidInput


class PredictorProxyModel(Model):
    """Model base with a `_proxied_predict(batch)` that calls either an
    injected predict_fn (in-process tests) or the predictor_host."""

    def __init__(self, name: str,
                 predictor_host: Optional[str] = None,
                 predict_fn: Optional[Callable] = None):
        super().__init__(name)
        self.predictor_host = predictor_host
        self._predict_fn = predict_fn

    def _load_artifact_dir(self, model_dir: str, config_filename: str):
        """Download the explainer artifact dir (when configured) and
        read its optional JSON config.  Returns (local_dir | None,
        config dict)."""
        if not model_dir:
            return None, {}
        from kfserving_tpu_torch.storage import Storage

        local = Storage.download(model_dir)
        path = os.path.join(local, config_filename)
        if not os.path.exists(path):
            return local, {}
        with open(path) as f:
            try:
                return local, json.load(f)
            except ValueError as e:
                raise InvalidInput(
                    f"malformed explainer config {config_filename}: {e}")

    async def _proxied_predict(self, batch: np.ndarray) -> np.ndarray:
        if self._predict_fn is not None:
            out = self._predict_fn(batch)
            if inspect.isawaitable(out):
                out = await out
            return np.asarray(out)
        if not self.predictor_host:
            raise InvalidInput(
                f"explainer {self.name} has no predictor_host")
        resp = await super().predict(
            {"instances": np.asarray(batch)})
        if "predictions" not in resp:
            raise InvalidInput(
                "predictor response has no 'predictions' key")
        return np.asarray(resp["predictions"])
