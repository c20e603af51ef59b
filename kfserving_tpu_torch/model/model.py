"""The serving model contract.

Port of ``kfserving_tpu/model/model.py``: a model is a named object with
``load / preprocess / predict / postprocess / explain`` and V2 metadata,
all awaited so a device-backed model yields the event loop while its
batch runs.  ``preprocess`` unwraps CloudEvents.  When
``predictor_host`` is set, ``predict`` proxies over HTTP to a downstream
predictor (how transformers and explainers chain to predictors), and
``explain`` proxies to ``explainer_host``.

The hop's client is the port's asyncio HTTP/1.1 client
(``server/client.py``, keep-alive per host, ``timeout`` seconds per
call) where the JAX package uses an aiohttp session.  Dense numeric V1
instance batches take the V2 binary wire to the predictor (raw tensor
bytes behind a JSON header) and the V2 response is translated back to
the V1 shape; a predictor that answers the binary hop with 404, 405 or
501 (a V1-only server) gets the V1 JSON route from then on, and every
other error propagates.
"""

import json
from typing import Any, Dict, Optional

from kfserving_tpu_torch.protocol import cloudevents
from kfserving_tpu_torch.protocol.errors import InferenceError, InvalidInput

# URL formats, as the JAX package's.
PREDICTOR_URL_FORMAT = "http://{0}/v1/models/{1}:predict"
EXPLAINER_URL_FORMAT = "http://{0}/v1/models/{1}:explain"
PREDICTOR_V2_URL_FORMAT = "http://{0}/v2/models/{1}/infer"
EXPLAINER_V2_URL_FORMAT = "http://{0}/v2/models/{1}/explain"


class _BinaryHopUnsupported(Exception):
    """The downstream has no V2 infer route (V1-only server)."""


def _np_json_default(obj):
    import numpy as np

    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    raise TypeError(
        f"Object of type {type(obj).__name__} is not JSON serializable")


def _dense_instances(request: Any):
    """The request's instances as one dense numeric ndarray, or None when
    the payload is not eligible for the binary hop."""
    import numpy as np

    if not isinstance(request, dict) or set(request) != {"instances"}:
        return None
    inst = request["instances"]
    if isinstance(inst, np.ndarray) and inst.dtype.kind in "fiub":
        return inst
    if (isinstance(inst, list) and inst
            and all(isinstance(i, np.ndarray) for i in inst)
            and inst[0].dtype.kind in "fiub"):
        try:
            return np.stack(inst)
        except ValueError:
            return None
    return None


def _v2_response_to_v1(resp: Dict[str, Any]) -> Dict[str, Any]:
    """Translate a V2 infer response to the V1 predictions shape so the
    binary hop stays invisible to V1 callers."""
    import numpy as np

    outputs = resp.get("outputs") or []
    if not outputs:
        return {"predictions": []}
    arrays = {o["name"]: np.asarray(o["data"]).reshape(o["shape"])
              for o in outputs}
    if len(arrays) == 1:
        return {"predictions": next(iter(arrays.values())).tolist()}
    n = next(iter(arrays.values())).shape[0]
    return {"predictions": [
        {k: v[i].tolist() for k, v in arrays.items()} for i in range(n)]}


class Model:
    """Base model.  Subclass and override load/predict (and optionally
    preprocess/postprocess/explain/metadata).

    ``predictor_host`` / ``explainer_host`` ("host:port[/prefix]") turn
    predict / explain into proxy calls; ``timeout`` bounds each (the
    outer system owns request-level timeouts, so it is generous)."""

    def __init__(self, name: str):
        self.name = name
        self.ready = False
        self.protocol = "v1"
        self.predictor_host: Optional[str] = None
        self.explainer_host: Optional[str] = None
        self.timeout = 600
        self._http_client = None
        # Dense V1 payloads upgrade the proxy hop to the V2 binary wire;
        # flips off for good after a downstream rejects it.
        self._binary_hop = True

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
        """Proxy to ``predictor_host`` (subclasses serving a model
        override this)."""
        if not self.predictor_host:
            raise NotImplementedError
        if self.protocol != "v2" and self._binary_hop:
            arr = _dense_instances(request)
            if arr is not None:
                try:
                    return await self._predict_binary(arr)
                except _BinaryHopUnsupported:
                    # A V1-only predictor: the V1 route from now on.  Any
                    # other error (4xx/5xx from a V2-capable server)
                    # propagates: replaying it over V1 would run the
                    # inference twice and hide the error.
                    self._binary_hop = False
        if self.protocol == "v2":
            url = PREDICTOR_V2_URL_FORMAT.format(self.predictor_host,
                                                 self.name)
        else:
            url = PREDICTOR_URL_FORMAT.format(self.predictor_host, self.name)
        return await self._proxy(url, request)

    async def explain(self, request: Any) -> Any:
        if not self.explainer_host:
            raise NotImplementedError
        if self.protocol == "v2":
            url = EXPLAINER_V2_URL_FORMAT.format(self.explainer_host,
                                                 self.name)
        else:
            url = EXPLAINER_URL_FORMAT.format(self.explainer_host, self.name)
        return await self._proxy(url, request)

    # -- proxy hop ---------------------------------------------------------
    @property
    def http_client(self):
        if self._http_client is None:
            from kfserving_tpu_torch.server.client import HTTPClient

            self._http_client = HTTPClient(timeout=self.timeout)
        return self._http_client

    async def _proxy(self, url: str, request: Any) -> Any:
        # numpy-aware: preprocess may hand back arrays, and every JSON
        # route (ineligible stacks, protocol v2, explain chains) must
        # still carry them.
        payload = json.dumps(request, default=_np_json_default).encode()
        status, _, body = await self.http_client.request(
            "POST", url, payload, {"Content-Type": "application/json"})
        if status != 200:
            raise InferenceError(body.decode("utf-8", "replace"))
        return json.loads(body)

    async def _predict_binary(self, arr) -> Any:
        from kfserving_tpu_torch.protocol.v2 import make_binary_request

        body, hlen = make_binary_request({"input_0": arr})
        url = PREDICTOR_V2_URL_FORMAT.format(self.predictor_host, self.name)
        status, _, payload = await self.http_client.request(
            "POST", url, body,
            {"Inference-Header-Content-Length": str(hlen),
             "Content-Type": "application/octet-stream"})
        if status in (404, 405, 501):
            raise _BinaryHopUnsupported(payload.decode("utf-8", "replace"))
        if status != 200:
            raise InferenceError(payload.decode("utf-8", "replace"))
        return _v2_response_to_v1(json.loads(payload))

    async def close(self) -> None:
        if self._http_client is not None:
            await self._http_client.close()
            self._http_client = None

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
