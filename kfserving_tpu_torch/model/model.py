"""The serving model contract.

Port of ``kfserving_tpu/model/model.py`` without its proxy hop: a model is
a named object with ``load / preprocess / predict / postprocess`` and
V2 metadata, all awaited so a device-backed model yields the event loop
while its batch runs.
"""

from typing import Any, Dict


class Model:
    """Base model.  Subclass and override load/predict (and optionally
    preprocess/postprocess/metadata)."""

    def __init__(self, name: str):
        self.name = name
        self.ready = False

    # -- lifecycle ---------------------------------------------------------
    def load(self) -> bool:
        """Load the model and flip ready.  Override in subclasses."""
        self.ready = True
        return self.ready

    def unload(self) -> None:
        """Release resources (device memory, threads)."""
        self.ready = False

    # -- request path ------------------------------------------------------
    async def preprocess(self, request: Any) -> Any:
        return request

    async def postprocess(self, response: Any) -> Any:
        return response

    async def predict(self, request: Any) -> Any:
        raise NotImplementedError

    # -- metadata ----------------------------------------------------------
    def metadata(self) -> Dict[str, Any]:
        """V2 model-metadata response object; subclasses with known
        signatures fill inputs/outputs."""
        return {
            "name": self.name,
            "platform": "kfserving_tpu_torch",
            "inputs": [],
            "outputs": [],
        }
