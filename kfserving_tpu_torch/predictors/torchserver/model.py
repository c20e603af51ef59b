"""PyTorch predictor of the port, on the card.

Port of ``kfserving_tpu/predictors/torchserver/model.py``: one
user-supplied ``.py`` file in the model directory defines the model
class (name from ``model_class_name``, default "PyTorchModel"), and a
``model.pt`` state dict restores its weights, loaded strictly and with
``weights_only=True``; V1 instances predict as one float32 batch in
``eval()`` mode.

Where the JAX package runs this module on the host CPU, the port places
it on ``device`` (default "cuda"): the state dict loads with
``map_location=device``, each batch goes to the device and the outputs
come back with ``.cpu()``.  Asking for "cuda" without a card raises at
``load``; there is no fallback to the CPU.
"""

import hashlib
import importlib.util
import logging
import os
import sys
from typing import Any

import numpy as np
import torch

from kfserving_tpu_torch.engine.torch_engine import resolve_device
from kfserving_tpu_torch.model.model import Model
from kfserving_tpu_torch.protocol import v1
from kfserving_tpu_torch.protocol.errors import InferenceError, InvalidInput
from kfserving_tpu_torch.storage import Storage

logger = logging.getLogger("kfserving_tpu_torch.predictors.torchserver")

PYTORCH_FILE = "model.pt"
# User class files load as modules under the port's own namespace.
USER_MODULE_PREFIX = "kfserving_tpu_torch._torch_user_"


class PyTorchModel(Model):
    def __init__(self, name: str, model_dir: str,
                 model_class_name: str = "PyTorchModel",
                 device: str = "cuda"):
        super().__init__(name)
        self.model_dir = model_dir
        self.model_class_name = model_class_name
        self.device = device
        self._model = None

    def load(self) -> bool:
        device = resolve_device(self.device)
        local_dir = Storage.download(self.model_dir)
        model_file = os.path.join(local_dir, PYTORCH_FILE)
        if not os.path.exists(model_file):
            raise InvalidInput(f"missing {PYTORCH_FILE} under {local_dir}")
        py_files = [f for f in os.listdir(local_dir) if f.endswith(".py")]
        if len(py_files) == 0:
            raise InvalidInput("Missing PyTorch Model Class File.")
        if len(py_files) > 1:
            # Exactly one Python file per model directory.
            raise InvalidInput(
                f"More than one Python file is detected: {sorted(py_files)}")
        # A module name per class file: two models whose class files share
        # a filename (net.py) must not share a cached module.
        class_file = os.path.join(local_dir, py_files[0])
        module_name = (USER_MODULE_PREFIX
                       + hashlib.sha1(class_file.encode()).hexdigest()[:12])
        spec = importlib.util.spec_from_file_location(
            module_name, class_file)
        module = importlib.util.module_from_spec(spec)
        sys.modules[module_name] = module
        spec.loader.exec_module(module)
        model_class = getattr(module, self.model_class_name)
        model = model_class()
        model.load_state_dict(
            torch.load(model_file, map_location=device, weights_only=True))
        self._model = model.to(device).eval()
        logger.info("loaded torch model %s (%s) from %s on %s",
                    self.name, self.model_class_name, local_dir, device)
        self.ready = True
        return True

    def unload(self) -> None:
        self._model = None
        self.ready = False

    async def predict(self, request: Any) -> Any:
        if self.predictor_host:
            return await super().predict(request)
        if self._model is None:
            raise InferenceError(f"model {self.name} not loaded")
        instances = v1.get_instances(request)
        try:
            batch = torch.as_tensor(np.asarray(instances,
                                               dtype=np.float32))
        except Exception as e:
            raise InvalidInput(
                f"Failed to initialize Torch Tensor from inputs: {e}")
        try:
            with torch.no_grad():
                out = self._model(batch.to(self.device)).cpu()
        except Exception as e:
            raise InferenceError(f"Failed to predict: {e}")
        return v1.make_response(out.numpy().tolist())
