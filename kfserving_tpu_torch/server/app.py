"""ModelServer: the V1/V2 inference routes on the stdlib HTTP server.

Port of the inference surface of ``kfserving_tpu/server/app.py``:

    GET  /                                  liveness ("Alive")
    GET  /v2/health/live                    V2 server live
    GET  /v2/health/ready                   V2 server ready (all models)
    GET  /v2                                V2 server metadata
    GET  /v1/models  /v2/models             list models
    GET  /v1/models/{name}                  model health
    GET  /v2/models/{name}/status           model health
    GET  /v2/models/{name}/ready            V2 model ready
    GET  /v2/models/{name}                  V2 model metadata
    POST /v1/models/{name}:predict          V1 predict
    POST /v2/models/{name}/infer            V2 infer
    POST /v1/models/{name}:generate         generate (``"stream": true``
    POST /v2/models/{name}/generate           hands off to the stream)
    POST /v2/models/{name}/generate_stream  token stream, SSE
                                            ``data: {...}\n\n`` events
    POST /v2/repository/models/{name}/load    (re)load a model
    POST /v2/repository/models/{name}/unload  unload a model
    GET  /v2/repository/index               models and their states
    GET  /debug/cache                       device-memory ledger and
                                            residency states

A V2 infer request may use the binary data extension
(``Inference-Header-Content-Length``); one that asks for
``binary_data_output`` gets a binary response.  One asyncio process
serves; batched device execution runs on the engines' worker threads.
"""

import argparse
import asyncio
import json
import logging
import signal
from typing import Any, Dict, List, Optional

from kfserving_tpu_torch.model.model import Model
from kfserving_tpu_torch.model.repository import ModelRepository
from kfserving_tpu_torch.protocol.errors import ServingError
from kfserving_tpu_torch.protocol.v2 import (
    INFERENCE_HEADER_CONTENT_LENGTH,
    InferRequest,
    encode_binary_response,
)
from kfserving_tpu_torch.server.dataplane import DataPlane
from kfserving_tpu_torch.server.http import (
    HTTPServer,
    Request,
    Response,
    Router,
    StreamingResponse,
)
from kfserving_tpu_torch.streams import GuardedStream, aclose_quietly

logger = logging.getLogger("kfserving_tpu_torch.server")

DEFAULT_HTTP_PORT = 8080

parser = argparse.ArgumentParser(add_help=False)
parser.add_argument("--http_port", default=DEFAULT_HTTP_PORT, type=int,
                    help="The HTTP port listened to by the model server.")


def _np_default(obj):
    tolist = getattr(obj, "tolist", None)
    if tolist is not None:
        return tolist()
    raise TypeError(
        f"Object of type {type(obj).__name__} is not JSON serializable")


def _json(data: Any, status: int = 200) -> Response:
    return Response(json.dumps(data, default=_np_default).encode("utf-8"),
                    status=status)


def _error(e: ServingError) -> Response:
    return _json({"error": e.reason}, status=e.status_code)


def _encode_response(body: Any, response: Any) -> Response:
    """A binary-extension response when the V2 request asked for
    ``binary_data_output``, else JSON."""
    if (isinstance(body, InferRequest)
            and body.parameters.get("binary_data_output")
            and isinstance(response, dict) and response.get("outputs")):
        payload, hlen = encode_binary_response(response)
        return Response(payload, headers={
            "content-type": "application/octet-stream",
            INFERENCE_HEADER_CONTENT_LENGTH: str(hlen)})
    return _json(response)


class ModelServer:
    def __init__(self, http_port: int = DEFAULT_HTTP_PORT,
                 registered_models: Optional[ModelRepository] = None):
        self.repository = registered_models or ModelRepository()
        self.dataplane = DataPlane(self.repository)
        self.http_port = http_port
        self.router = Router()
        self._register_routes()
        self.http_server = HTTPServer(self.router)

    def _register_routes(self):
        r = self.router
        r.add("GET", "/", self._live)
        r.add("GET", "/v2/health/live", self._live)
        r.add("GET", "/v2/health/ready", self._server_ready)
        r.add("GET", "/v2", self._server_metadata)
        r.add("GET", "/v1/models", self._list_models)
        r.add("GET", "/v2/models", self._list_models)
        r.add("GET", "/v1/models/{name}", self._model_health)
        r.add("GET", "/v2/models/{name}/status", self._model_health)
        r.add("GET", "/v2/models/{name}/ready", self._model_ready)
        r.add("GET", "/v2/models/{name}", self._model_metadata)
        r.add("POST", "/v1/models/{name}:predict", self._inference)
        r.add("POST", "/v2/models/{name}/infer", self._inference)
        r.add("POST", "/v1/models/{name}:generate", self._generate)
        r.add("POST", "/v2/models/{name}/generate", self._generate)
        r.add("POST", "/v2/models/{name}/generate_stream",
              self._generate_stream)
        r.add("POST", "/v2/repository/models/{name}/load", self._load)
        r.add("POST", "/v2/repository/models/{name}/unload", self._unload)
        r.add("GET", "/v2/repository/index", self._repository_index)
        r.add("GET", "/debug/cache", self._cache)

    # -- handlers ----------------------------------------------------------
    async def _live(self, req: Request) -> Response:
        return Response(b"Alive", content_type="text/plain")

    async def _server_ready(self, req: Request) -> Response:
        ready = self.dataplane.server_ready()
        return _json({"ready": ready}, status=200 if ready else 503)

    async def _server_metadata(self, req: Request) -> Response:
        return _json(self.dataplane.server_metadata())

    async def _list_models(self, req: Request) -> Response:
        return _json(self.dataplane.list_models())

    async def _model_health(self, req: Request) -> Response:
        try:
            model = self.dataplane.model_ready(req.path_params["name"])
        except ServingError as e:
            return _error(e)
        return _json({"name": model.name, "ready": model.ready})

    async def _model_ready(self, req: Request) -> Response:
        try:
            self.dataplane.model_ready(req.path_params["name"])
        except ServingError as e:
            return _error(e)
        return Response(b"", status=200)

    async def _model_metadata(self, req: Request) -> Response:
        try:
            return _json(self.dataplane.model_metadata(
                req.path_params["name"]))
        except ServingError as e:
            return _error(e)

    async def _inference(self, req: Request, call=None) -> Response:
        name = req.path_params["name"]
        call = call or self.dataplane.infer
        try:
            body = self.dataplane.decode_body(req.headers, req.body)
            return _encode_response(body, await call(name, body))
        except ServingError as e:
            return _error(e)
        except Exception as e:
            logger.exception("inference failed for model %s", name)
            return _json({"error": str(e)}, status=500)

    async def _generate(self, req: Request) -> Response:
        # {"stream": true} hands the request to the token stream.
        if b'"stream"' in req.body:
            try:
                body = self.dataplane.decode_body(req.headers, req.body)
            except ServingError as e:
                return _error(e)
            if isinstance(body, dict) and body.get("stream"):
                return await self._generate_stream(req, body=body)
        return await self._inference(req, self.dataplane.generate)

    async def _generate_stream(self, req: Request,
                               body: Any = None) -> Response:
        name = req.path_params["name"]
        try:
            if body is None:
                body = self.dataplane.decode_body(req.headers, req.body)
            # Validation and submission happen here, before headers
            # are committed: errors are plain 4xx/5xx responses.
            events = await self.dataplane.generate_stream(name, body)
        except ServingError as e:
            return _error(e)

        async def sse():
            try:
                async for event in events:
                    payload = json.dumps(event, default=_np_default)
                    yield f"data: {payload}\n\n".encode("utf-8")
            except Exception:
                logger.exception("generate stream for %s failed", name)
                raise

        async def on_close():
            # Runs once on every exit path, a client that went away
            # before the first event included: closing the model's
            # event stream frees its engine slot.
            await aclose_quietly(events, "model event stream")

        return StreamingResponse(GuardedStream(sse(), on_close))

    async def _load(self, req: Request) -> Response:
        name = req.path_params["name"]
        try:
            await self.dataplane.load(name)
        except ServingError as e:
            return _error(e)
        return _json({"name": name, "load": True})

    async def _unload(self, req: Request) -> Response:
        name = req.path_params["name"]
        try:
            await self.dataplane.unload(name)
        except ServingError as e:
            return _error(e)
        return _json({"name": name, "unload": True})

    async def _repository_index(self, req: Request) -> Response:
        return _json(self.dataplane.repository_index())

    async def _cache(self, req: Request) -> Response:
        return _json(self.cache_snapshot())

    def cache_snapshot(self) -> Dict[str, Any]:
        """The ``/debug/cache`` body: the device-memory ledger (``hbm``)
        and the demand-paged residency states (``residency``), under the
        JAX package's keys; each is null when the repository has none.
        The generative blocks are not ported yet."""
        hbm = getattr(self.repository, "hbm", None)
        residency = getattr(self.repository, "residency", None)
        return {"hbm": hbm.debug() if hbm is not None else None,
                "residency": (residency.debug() if residency is not None
                              else None)}

    # -- lifecycle ---------------------------------------------------------
    def register_model(self, model: Model) -> None:
        if not model.name:
            raise ValueError(
                "Failed to register model, model.name must be provided.")
        self.repository.update(model)
        logger.info("Registering model: %s", model.name)

    async def start_async(self, models: List[Model],
                          host: str = "0.0.0.0") -> None:
        """Register `models` and listen; http_port=0 picks a free port,
        which `self.http_port` then holds."""
        for model in models:
            self.register_model(model)
        await self.http_server.start(host, self.http_port)
        self.http_port = self.http_server.port

    async def stop_async(self) -> None:
        await self.http_server.stop()
        residency = getattr(self.repository, "residency", None)
        if residency is not None:
            residency.close()

    def start(self, models: List[Model]) -> None:
        """Blocking entry point: serve until SIGINT or SIGTERM."""
        async def _main():
            await self.start_async(models)
            stop = asyncio.Event()
            loop = asyncio.get_running_loop()
            for sig in (signal.SIGINT, signal.SIGTERM):
                loop.add_signal_handler(sig, stop.set)
            await stop.wait()
            await self.stop_async()

        logging.basicConfig(level=logging.INFO)
        asyncio.run(_main())
