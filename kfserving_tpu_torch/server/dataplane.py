"""Protocol-agnostic data-plane operations over a ModelRepository.

Port of ``kfserving_tpu/server/dataplane.py``: liveness, readiness, model
listing and metadata, inference (JSON bodies, V1 or V2, CloudEvents in
binary or structured mode, dense V1 bodies through the native codec, and
the V2 binary data extension), explanation (``explain``, with its own
deadline stages), the generate extension (``generate``,
``generate_stream``) and the repository extension (``load``,
``unload``, ``repository_index``).  Inference checks the request's
deadline at each stage boundary, records the ``dataplane.*`` spans and
calls the ``dataplane.infer`` fault site.
"""

import json
from typing import Any, Dict, List, Mapping, Optional

from kfserving_tpu_torch import __version__ as SERVER_VERSION
from kfserving_tpu_torch.model.model import Model
from kfserving_tpu_torch.model.repository import ModelRepository, maybe_await
from kfserving_tpu_torch.protocol import cloudevents, native, v1, v2
from kfserving_tpu_torch.protocol.errors import (
    InvalidInput,
    ModelNotFound,
    ModelNotReady,
)
from kfserving_tpu_torch.reliability import fault_sites
from kfserving_tpu_torch.reliability.deadline import (
    check_deadline,
    deadline_scope,
)
from kfserving_tpu_torch.reliability.faults import faults
from kfserving_tpu_torch.tracing import tracer

SERVER_NAME = "kfserving-tpu-torch"


def is_v2_request(request: Any) -> bool:
    """A V2 tensor request: {"inputs": [{"name", "datatype", ...}]}."""
    return (isinstance(request, dict)
            and isinstance(request.get("inputs"), list)
            and bool(request["inputs"])
            and isinstance(request["inputs"][0], dict)
            and "datatype" in request["inputs"][0])


class DataPlane:
    def __init__(self, repository: ModelRepository):
        self.repository = repository
        # The revision this replica serves, set by the in-process
        # orchestrator: its replicas share one fault injector, so the
        # dataplane.infer key carries " revision:<hash>" and a match can
        # scope a fault to one revision (a replica process reads its own
        # KFS_FAULTS instead).
        self.revision: Optional[str] = None

    # -- health / metadata -------------------------------------------------
    def live(self) -> bool:
        return True

    def server_ready(self) -> bool:
        """V2 "server ready": all registered models ready."""
        return all(m.ready for m in self.repository.get_models())

    def model_ready(self, name: str) -> Model:
        model = self.repository.get_model(name)
        if model is None:
            raise ModelNotFound(name)
        if not model.ready:
            raise ModelNotReady(name)
        return model

    def list_models(self) -> List[str]:
        return [m.name for m in self.repository.get_models()]

    def server_metadata(self) -> Dict[str, Any]:
        return {"name": SERVER_NAME, "version": SERVER_VERSION,
                "extensions": ["model_repository"]}

    def model_metadata(self, name: str) -> Dict[str, Any]:
        model = self.repository.get_model(name)
        if model is None:
            raise ModelNotFound(name)
        return model.metadata()

    # -- inference ---------------------------------------------------------
    async def get_model(self, name: str) -> Model:
        """Fetch a model, loading it on first use.  The load runs outside
        the request's deadline scope: it is shared work for every later
        request, so one short-budget client must not abort it; the
        caller checks the request's own budget right after."""
        model = self.repository.get_model(name)
        if model is None:
            raise ModelNotFound(name)
        if not model.ready:
            with deadline_scope(None):
                await maybe_await(model.load())
        return model

    def wire_dtype_hint(self, name: str) -> Optional[str]:
        """The served model's preferred wire dtype ("u1" for uint8 image
        models), handed to the native parser so integer bodies land in
        the model's dtype directly."""
        return getattr(self.repository.get_model(name), "wire_dtype", None)

    @staticmethod
    def decode_body(headers: Mapping[str, str], body: bytes,
                    dtype_hint: Optional[str] = None) -> Any:
        """Decode a request body (header names arrive lower-cased): a
        CloudEvent (binary or structured), a V2 binary-extension request
        when ``Inference-Header-Content-Length`` is set, else JSON.

        Dense numeric V1 bodies take the native codec
        (``protocol/native.py``): one C pass straight into a contiguous
        array, uint8 when ``dtype_hint`` says the model takes uint8 and
        the values fit, else int32/float32.  Everything else (V2 tensor
        objects, dict instances, strings) goes through json.loads."""
        if cloudevents.has_ce_headers(headers) or \
                cloudevents.is_structured(headers):
            try:
                return cloudevents.from_http(headers, body)
            except ValueError as e:
                raise InvalidInput(f"Cloud Event Exceptions: {e}")
        header_len = headers.get(v2.INFERENCE_HEADER_CONTENT_LENGTH)
        if header_len is not None:
            try:
                return v2.InferRequest.from_binary(body, int(header_len))
            except ValueError as e:
                raise InvalidInput(str(e))
        if body[:1] == b"{" and b'"datatype"' not in body:
            fast = native.parse_v1(body, hint=dtype_hint)
            if fast is not None:
                arr, key = fast
                return {key: arr}
        try:
            return json.loads(body) if body else {}
        except ValueError as e:
            raise InvalidInput(f"Unrecognized request format: {e}")

    async def infer(self, name: str, body: Any) -> Any:
        # Stage-boundary deadline checks: a request already over budget
        # after a lazy load or a slow preprocess fails 504 here, before
        # the batcher spends a slot on it.
        model = await self.get_model(name)
        if faults.configured(fault_sites.DATAPLANE_INFER):
            key = (name if self.revision is None
                   else f"{name} revision:{self.revision}")
            await faults.inject(fault_sites.DATAPLANE_INFER, key=key)
        check_deadline("dataplane.infer")
        with tracer.span("dataplane.preprocess", model=name):
            request = await model.preprocess(body)
        request = self.validate(request)
        check_deadline("dataplane.infer preprocess")
        with tracer.span("dataplane.predict", model=name):
            response = await maybe_await(model.predict(request))
        with tracer.span("dataplane.postprocess", model=name):
            return await model.postprocess(response)

    async def explain(self, name: str, body: Any) -> Any:
        model = await self.get_model(name)
        check_deadline("dataplane.explain")
        request = await model.preprocess(body)
        request = self.validate(request)
        check_deadline("dataplane.explain preprocess")
        response = await maybe_await(model.explain(request))
        return await model.postprocess(response)

    async def generate(self, name: str, body: Any) -> Any:
        model = await self.get_model(name)
        check_deadline("dataplane.generate")
        generate = getattr(model, "generate", None)
        if generate is None:
            raise InvalidInput(f"model {name} does not support :generate")
        return await maybe_await(generate(body))

    async def generate_stream(self, name: str, body: Any):
        model = await self.get_model(name)
        stream = getattr(model, "generate_stream", None)
        if stream is None:
            raise InvalidInput(
                f"model {name} does not support streaming generation")
        # Awaiting runs validation and submission now: a bad request is
        # a 4xx before any streaming headers are committed.
        return await maybe_await(stream(body))

    # -- repository --------------------------------------------------------
    async def load(self, name: str) -> None:
        try:
            ok = await self.repository.load(name)
        except Exception as e:
            raise ModelNotReady(name, f"Error type: {type(e)} error msg: {e}")
        if not ok or not self.repository.is_model_ready(name):
            raise ModelNotReady(name)

    async def unload(self, name: str) -> None:
        try:
            await self.repository.unload(name)
        except KeyError:
            raise ModelNotFound(name)

    def repository_index(self) -> List[Dict[str, Any]]:
        """V2 repository index extension (Triton-style)."""
        return [
            {"name": m.name, "state": "READY" if m.ready else "UNAVAILABLE"}
            for m in self.repository.get_models()
        ]

    @staticmethod
    def validate(request: Any) -> Any:
        if is_v2_request(request):
            # Structural validation happens in InferRequest.from_dict.
            return request
        if isinstance(request, dict):
            return v1.validate_request(request)
        return request
