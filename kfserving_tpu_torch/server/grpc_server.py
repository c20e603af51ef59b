"""V2 gRPC server sharing the HTTP server's DataPlane.

Port of ``kfserving_tpu/server/grpc_server.py``.  The reference
mandates the V2 gRPC API (reference
docs/predict-api/v2/grpc_predict_v2.proto); here it fronts the same
``server/dataplane.py`` operations as the HTTP routes: two codecs over
one engine path.  ``ModelInfer`` over BERT runs the flash-attention
kernel; ``Generate`` and ``GenerateStream`` over the paged generator run
it in the prefill and the paged decode kernel in every wave.

Handlers are registered through ``grpc.method_handlers_generic_handler``
against the protoc-generated message classes
(``protocol/grpc/``), so no ``_pb2_grpc`` module is needed.  The app
imports this module only when ``--grpc_port`` is given: ``grpc`` and
``google.protobuf`` load with it.

Tensor payloads accept both typed ``InferTensorContents`` fields and
``raw_input_contents`` (required for FP16/BF16); responses mirror the
request's form: raw in -> raw out, typed in -> typed out.  numpy has no
bfloat16, so a raw BF16 tensor decodes to a ``torch.bfloat16`` tensor of
its bit patterns, as the port's binary HTTP wire does.
"""

import asyncio
import logging
import time
from typing import Any, Dict, List, Optional

import numpy as np

from kfserving_tpu_torch.protocol import v2
from kfserving_tpu_torch.protocol.errors import ServingError
from kfserving_tpu_torch.protocol.grpc import kfs_generate_pb2 as gpb
from kfserving_tpu_torch.protocol.grpc import pb2
from kfserving_tpu_torch.protocol.v2 import (
    InferInput,
    InferRequest,
    decode_raw_bytes as _decode_raw_bytes,
    frame_raw_bytes as _encode_raw_bytes,
)
from kfserving_tpu_torch.reliability.deadline import (
    Deadline,
    deadline_scope,
)
from kfserving_tpu_torch.server.dataplane import DataPlane
from kfserving_tpu_torch.streams import aclose_quietly
from kfserving_tpu_torch.tracing import ensure_trace_context

logger = logging.getLogger("kfserving_tpu_torch.grpc")

# datatype -> InferTensorContents field (reference proto comments:
# 8/16/32-bit ints share int_contents / uint_contents).
_CONTENTS_FIELD = {
    "BOOL": "bool_contents",
    "INT8": "int_contents", "INT16": "int_contents",
    "INT32": "int_contents",
    "INT64": "int64_contents",
    "UINT8": "uint_contents", "UINT16": "uint_contents",
    "UINT32": "uint_contents",
    "UINT64": "uint64_contents",
    "FP32": "fp32_contents",
    "FP64": "fp64_contents",
    "BYTES": "bytes_contents",
}

_RAW_DTYPE = {
    "BOOL": np.bool_, "INT8": np.int8, "INT16": np.int16,
    "INT32": np.int32, "INT64": np.int64, "UINT8": np.uint8,
    "UINT16": np.uint16, "UINT32": np.uint32, "UINT64": np.uint64,
    "FP16": np.float16, "FP32": np.float32, "FP64": np.float64,
}


def _tensor_to_numpy(tensor, raw: Optional[bytes]) -> np.ndarray:
    shape = list(tensor.shape)
    if raw is not None:
        if tensor.datatype == "BYTES":
            return np.array(_decode_raw_bytes(raw),
                            dtype=np.object_).reshape(shape)
        if tensor.datatype == "BF16":
            return v2.bf16_tensor(
                np.frombuffer(raw, dtype=np.uint16).reshape(shape))
        dtype = np.dtype(_RAW_DTYPE[tensor.datatype])
        return np.frombuffer(raw, dtype=dtype).reshape(shape)
    field = _CONTENTS_FIELD.get(tensor.datatype)
    if field is None:
        raise ValueError(
            f"datatype {tensor.datatype} requires raw_input_contents")
    values = getattr(tensor.contents, field)
    if tensor.datatype == "BYTES":
        return np.array(list(values), dtype=np.object_).reshape(shape)
    return np.asarray(values, dtype=_RAW_DTYPE[tensor.datatype]) \
        .reshape(shape)


def _request_to_infer(req) -> InferRequest:
    raws: List[Optional[bytes]] = list(req.raw_input_contents) or \
        [None] * len(req.inputs)
    if len(raws) != len(req.inputs):
        raise ValueError(
            "raw_input_contents must carry one buffer per input")
    inputs = []
    for tensor, raw in zip(req.inputs, raws):
        arr = _tensor_to_numpy(tensor, raw)
        inputs.append(InferInput(tensor.name, list(tensor.shape),
                                 tensor.datatype, arr))
    return InferRequest(inputs, id=req.id or None)


def _output_to_tensor(out: Dict[str, Any], response, use_raw: bool
                      ) -> None:
    tensor = response.outputs.add()
    tensor.name = out["name"]
    tensor.datatype = out["datatype"]
    tensor.shape.extend(int(s) for s in out["shape"])
    data = out["data"]
    if use_raw:
        if out["datatype"] == "BYTES":
            values = data if isinstance(data, list) else \
                np.asarray(data).ravel().tolist()
            response.raw_output_contents.append(
                _encode_raw_bytes(values))
            return
        if out["datatype"] == "BF16":
            response.raw_output_contents.append(
                v2.bf16_bits(data).tobytes())
            return
        arr = np.asarray(data, dtype=_RAW_DTYPE.get(out["datatype"]))
        response.raw_output_contents.append(arr.tobytes())
        return
    field = _CONTENTS_FIELD.get(out["datatype"])
    if field is None:  # FP16/BF16 must go raw regardless
        arr = np.asarray(data, dtype=np.float32)
        tensor.datatype = "FP32"
        tensor.ClearField("shape")
        tensor.shape.extend(int(s) for s in out["shape"])
        getattr(tensor.contents, "fp32_contents").extend(
            arr.ravel().tolist())
        return
    values = data if isinstance(data, list) else \
        np.asarray(data).ravel().tolist()
    if out["datatype"] == "BYTES":
        values = [v.encode() if isinstance(v, str) else bytes(v)
                  for v in values]
    getattr(tensor.contents, field).extend(values)


_STATUS_BY_CODE = {404: "NOT_FOUND", 400: "INVALID_ARGUMENT",
                   503: "UNAVAILABLE", 504: "DEADLINE_EXCEEDED"}


def _deadline_from(context):
    """The caller's gRPC deadline as a reliability Deadline, carried
    through the same contextvar channel the HTTP header uses: one
    budget discipline, two wire protocols."""
    remaining = context.time_remaining()
    if remaining is None:
        return None
    return Deadline(remaining)


def _http_status(e: Exception) -> int:
    """The HTTP-equivalent status of a handler failure, so gRPC and
    HTTP requests land in the SAME request counter/latency series
    (the recycling watchdog's max_requests trigger scrapes it; a
    gRPC-only deployment must not undercount)."""
    if isinstance(e, ServingError):
        return int(e.status_code)
    if isinstance(e, (ValueError, KeyError)):
        return 400
    return 500


class GRPCServer:
    """Async V2 gRPC front end over a DataPlane."""

    def __init__(self, dataplane: DataPlane, port: int = 0,
                 host: str = "127.0.0.1", metrics=None,
                 monitoring=None):
        self.dataplane = dataplane
        self.port = port
        self.host = host
        self.metrics = metrics  # shared with the HTTP app
        # The HTTP app's Monitoring loop: gRPC requests flight-record
        # (and pin on shed/error) exactly like HTTP ones.  The monitor
        # BUS is not teed here: bus consumers parse JSON V1 payloads,
        # which a proto tensor request doesn't carry.
        self.monitoring = monitoring
        self._server = None

    def _join_trace(self, context) -> Optional[str]:
        """Join the caller's trace from gRPC metadata (`traceparent`
        wins, `x-request-id` fallback) — the gRPC hop's analogue of
        the HTTP header join, so engine spans reached through either
        protocol carry the upstream trace id."""
        try:
            md = {str(k).lower(): str(v) for k, v in
                  (context.invocation_metadata() or ())}
        except Exception:
            md = {}
        return ensure_trace_context(md).trace_id

    def _observe(self, model: str, verb: str, status: int,
                 start: float, trace_id: Optional[str]) -> None:
        latency_ms = (time.perf_counter() - start) * 1000.0
        if self.metrics is not None:
            self.metrics.observe_request(model, verb, status,
                                         latency_ms,
                                         trace_id=trace_id)
        if self.monitoring is not None:
            self.monitoring.record_request(model, verb, status,
                                           latency_ms,
                                           trace_id=trace_id)

    # -- handlers -----------------------------------------------------------
    async def _abort(self, context, e: Exception):
        import grpc

        if isinstance(e, ServingError):
            name = _STATUS_BY_CODE.get(e.status_code, "INTERNAL")
            code = getattr(grpc.StatusCode, name)
            await context.abort(code, e.reason)
        if isinstance(e, (ValueError, KeyError)):
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        logger.exception("grpc handler failed")
        await context.abort(grpc.StatusCode.INTERNAL, str(e))

    async def ServerLive(self, request, context):
        return pb2.ServerLiveResponse(live=self.dataplane.live())

    async def ServerReady(self, request, context):
        return pb2.ServerReadyResponse(ready=self.dataplane.server_ready())

    async def ModelReady(self, request, context):
        try:
            self.dataplane.model_ready(request.name)
            return pb2.ModelReadyResponse(ready=True)
        except ServingError:
            return pb2.ModelReadyResponse(ready=False)

    async def ServerMetadata(self, request, context):
        meta = self.dataplane.server_metadata()
        return pb2.ServerMetadataResponse(
            name=meta["name"], version=meta["version"],
            extensions=meta["extensions"])

    async def ModelMetadata(self, request, context):
        try:
            meta = self.dataplane.model_metadata(request.name)
        except ServingError as e:
            await self._abort(context, e)
        resp = pb2.ModelMetadataResponse(
            name=meta.get("name", request.name),
            platform=meta.get("platform", ""))
        for io_key, target in (("inputs", resp.inputs),
                               ("outputs", resp.outputs)):
            for t in meta.get(io_key, []) or []:
                tm = target.add()
                tm.name = t.get("name", "")
                tm.datatype = t.get("datatype", "")
                tm.shape.extend(int(s) for s in t.get("shape", []))
        return resp

    async def ModelInfer(self, request, context):
        start = time.perf_counter()
        trace_id = self._join_trace(context)
        try:
            infer_req = _request_to_infer(request)
            with deadline_scope(_deadline_from(context)):
                result = await self.dataplane.infer(
                    request.model_name, infer_req)
        except Exception as e:
            self._observe(request.model_name, "infer",
                          _http_status(e), start, trace_id)
            await self._abort(context, e)
        self._observe(request.model_name, "infer", 200, start,
                      trace_id)
        response = pb2.ModelInferResponse(
            model_name=result.get("model_name", request.model_name),
            model_version=result.get("model_version", ""),
            id=result.get("id", "") or request.id)
        use_raw = bool(request.raw_input_contents)
        for out in result.get("outputs", []):
            _output_to_tensor(out, response, use_raw)
        return response

    # -- generation service (kfs_generate.proto — framework extension,
    # kept separate from the faithful V2 surface) ------------------------
    @staticmethod
    def _generate_body(request) -> Dict[str, Any]:
        """Proto -> the HTTP generate body shape; `optional` fields
        only override the model's config defaults when present."""
        params: Dict[str, Any] = {}
        for field in ("max_tokens", "temperature", "top_k", "top_p",
                      "seed", "logprobs"):
            if request.HasField(field):
                params[field] = getattr(request, field)
        if request.stop:
            params["stop"] = list(request.stop)
        return {"text_input": request.text_input,
                "parameters": params}

    async def Generate(self, request, context):
        start = time.perf_counter()
        trace_id = self._join_trace(context)
        try:
            with deadline_scope(_deadline_from(context)):
                result = await self.dataplane.generate(
                    request.model_name, self._generate_body(request))
        except Exception as e:
            self._observe(request.model_name, "generate",
                          _http_status(e), start, trace_id)
            await self._abort(context, e)
        self._observe(request.model_name, "generate", 200, start,
                      trace_id)
        details = result.get("details", {})
        resp = gpb.GenerateResponse(
            model_name=result.get("model_name", request.model_name),
            text_output=result.get("text_output", ""),
            finish_reason=details.get("finish_reason", ""),
            token_count=details.get("token_count", 0))
        for rec in details.get("logprobs", []) or []:
            resp.chosen_logprobs.add(id=rec["id"],
                                     logprob=rec["logprob"])
            # Full logprob parity with the HTTP generate surface: the
            # top-N alternatives ride a Token per generated token
            # (text stays empty — text_output carries the aggregate).
            tok = resp.tokens.add(id=rec["id"],
                                  logprob=rec["logprob"])
            for top in rec.get("top", []) or []:
                tok.top_logprobs.add(id=top["id"],
                                     logprob=top["logprob"])
        return resp

    async def GenerateStream(self, request, context):
        """Server-streaming tokens over HTTP/2 framing: each yielded
        message is one SSE-event equivalent.  The request validates
        before the first message (gRPC has no committed-headers
        problem, but a clean INVALID_ARGUMENT beats an error mid-
        stream); consumer cancellation propagates to the engine via
        the event stream's close hook."""
        start = time.perf_counter()
        trace_id = self._join_trace(context)
        try:
            # The deadline covers validation + submission and rides
            # into the engine request: an over-budget stream finishes
            # with reason "timeout" at the next decode-wave boundary.
            with deadline_scope(_deadline_from(context)):
                events = await self.dataplane.generate_stream(
                    request.model_name, self._generate_body(request))
        except Exception as e:
            self._observe(request.model_name, "generate_stream",
                          _http_status(e), start, trace_id)
            await self._abort(context, e)
        status = 200
        try:
            async for event in events:
                msg = gpb.GenerateStreamResponse()
                tok = event.get("token")
                if tok is not None:
                    msg.token.id = (-1 if tok.get("id") is None
                                    else int(tok["id"]))
                    msg.token.text = tok.get("text", "")
                    if "logprob" in tok:
                        msg.token.logprob = float(tok["logprob"])
                    for rec in tok.get("top_logprobs", []):
                        msg.token.top_logprobs.add(
                            id=rec["id"], logprob=rec["logprob"])
                if event.get("finish_reason"):
                    msg.finish_reason = event["finish_reason"]
                    msg.generated_text = event.get(
                        "generated_text", "")
                    msg.token_count = event.get(
                        "details", {}).get("token_count", 0)
                yield msg
        except (GeneratorExit, asyncio.CancelledError):
            # Client cancellation is routine, not a server error:
            # record the nginx-style 499 so disconnect storms never
            # read as a 5xx spike in the request counter.
            status = 499
            raise
        except BaseException:
            status = 500
            raise
        finally:
            # gRPC cancellation (client went away) lands here as a
            # GeneratorExit — close the event stream so the engine
            # frees the decode slot.
            await aclose_quietly(events, "grpc generate stream")
            self._observe(request.model_name, "generate_stream",
                          status, start, trace_id)

    async def RepositoryIndex(self, request, context):
        resp = pb2.RepositoryIndexResponse()
        for entry in self.dataplane.repository_index():
            if request.ready and entry["state"] != "READY":
                continue
            m = resp.models.add()
            m.name = entry["name"]
            m.state = entry["state"]
        return resp

    async def RepositoryModelLoad(self, request, context):
        try:
            await self.dataplane.load(request.model_name)
        except Exception as e:
            await self._abort(context, e)
        return pb2.RepositoryModelLoadResponse()

    async def RepositoryModelUnload(self, request, context):
        try:
            await self.dataplane.unload(request.model_name)
        except Exception as e:
            await self._abort(context, e)
        return pb2.RepositoryModelUnloadResponse()

    # -- lifecycle ----------------------------------------------------------
    def _handlers(self):
        import grpc

        def unary(fn, req_cls, resp_cls):
            return grpc.unary_unary_rpc_method_handler(
                fn,
                request_deserializer=req_cls.FromString,
                response_serializer=resp_cls.SerializeToString)

        inference = grpc.method_handlers_generic_handler(
            "inference.GRPCInferenceService", {
                "ServerLive": unary(self.ServerLive,
                                    pb2.ServerLiveRequest,
                                    pb2.ServerLiveResponse),
                "ServerReady": unary(self.ServerReady,
                                     pb2.ServerReadyRequest,
                                     pb2.ServerReadyResponse),
                "ModelReady": unary(self.ModelReady,
                                    pb2.ModelReadyRequest,
                                    pb2.ModelReadyResponse),
                "ServerMetadata": unary(self.ServerMetadata,
                                        pb2.ServerMetadataRequest,
                                        pb2.ServerMetadataResponse),
                "ModelMetadata": unary(self.ModelMetadata,
                                       pb2.ModelMetadataRequest,
                                       pb2.ModelMetadataResponse),
                "ModelInfer": unary(self.ModelInfer,
                                    pb2.ModelInferRequest,
                                    pb2.ModelInferResponse),
            })
        generation = grpc.method_handlers_generic_handler(
            "kfserving.generate.GenerationService", {
                "Generate": unary(self.Generate,
                                  gpb.GenerateRequest,
                                  gpb.GenerateResponse),
                "GenerateStream":
                    grpc.unary_stream_rpc_method_handler(
                        self.GenerateStream,
                        request_deserializer=(
                            gpb.GenerateRequest.FromString),
                        response_serializer=(
                            gpb.GenerateStreamResponse
                            .SerializeToString)),
            })
        repository = grpc.method_handlers_generic_handler(
            "inference.ModelRepositoryService", {
                "RepositoryIndex": unary(
                    self.RepositoryIndex,
                    pb2.RepositoryIndexRequest,
                    pb2.RepositoryIndexResponse),
                "RepositoryModelLoad": unary(
                    self.RepositoryModelLoad,
                    pb2.RepositoryModelLoadRequest,
                    pb2.RepositoryModelLoadResponse),
                "RepositoryModelUnload": unary(
                    self.RepositoryModelUnload,
                    pb2.RepositoryModelUnloadRequest,
                    pb2.RepositoryModelUnloadResponse),
            })
        return [inference, generation, repository]

    async def start(self) -> None:
        import grpc.aio

        self._server = grpc.aio.server()
        self._server.add_generic_rpc_handlers(tuple(self._handlers()))
        bound = self._server.add_insecure_port(
            f"{self.host}:{self.port}")
        if bound == 0:
            # grpc reports bind failure as port 0, not an exception —
            # indistinguishable from the ephemeral-port request, so
            # surface it loudly instead of "starting" with no listener.
            raise RuntimeError(
                f"gRPC failed to bind {self.host}:{self.port}")
        self.port = bound
        await self._server.start()
        logger.info("V2 gRPC server on %s:%d", self.host, self.port)

    async def stop(self, grace: float = 5.0) -> None:
        if self._server is not None:
            await self._server.stop(grace)
            self._server = None
