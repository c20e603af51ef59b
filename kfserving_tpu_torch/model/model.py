"""The serving model contract.

Port of ``kfserving_tpu/model/model.py`` without its proxy hop: a model is
a named object with ``load / preprocess / predict / postprocess`` and
V2 metadata, all awaited so a device-backed model yields the event loop
while its batch runs.  ``preprocess`` unwraps CloudEvents.
"""

import json
from typing import Any, Dict

from kfserving_tpu_torch.protocol import cloudevents
from kfserving_tpu_torch.protocol.errors import InvalidInput


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
        """Unwrap CloudEvents payloads, else pass through.

        A binary CloudEvent's data is JSON-decoded when possible; if the
        event declares a JSON content type but the body does not parse,
        that is a client error (400); otherwise the raw bytes pass
        through for the model to decode.  A structured CloudEvent dict
        is unwrapped to its "data" member.
        """
        if isinstance(request, cloudevents.CloudEvent):
            data = request.data
            if isinstance(data, (bytes, bytearray)):
                try:
                    return json.loads(data.decode("utf-8"))
                except (ValueError, UnicodeDecodeError) as e:
                    ctype = request.attributes.get(
                        "content-type",
                        request.attributes.get("datacontenttype", ""))
                    # Media type only: "application/json; charset=utf-8"
                    # must still take the 400 path.
                    if ctype.split(";")[0].strip() in (
                            "application/json",
                            "application/cloudevents+json"):
                        raise InvalidInput(
                            f"Unrecognized request format: {e}")
                    return data
            return data
        if isinstance(request, dict):
            if all(k in request for k in
                   ("time", "type", "source", "id", "specversion", "data")):
                return request["data"]
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
