"""The port's V2 gRPC front end (``kfserving_tpu_torch/server/grpc_server.py``)
against the JAX package's, on the CPU.

The inference and repository services: one ``mlp`` artifact (config plus
a Flax checkpoint, as ``tests/test_grpc.py`` writes it) and an echo model
served by a JAX ModelServer and by the port's, both with ``grpc_port=0``;
the same requests go to both over a real ``grpc.aio`` channel and the
responses must be equal field by field (fp32 model outputs within
``FP32_ATOL``), errors with the same status codes and details.

The generation service: the port's ``Generate`` and ``GenerateStream``
on ``decoder_tiny`` (``device="cpu"``) against the port's own HTTP
``generate`` and SSE stream on the same prompts (those routes are held
against the JAX decoder in ``test_torch_llm_server.py``).
"""

import asyncio
import json
import os
import re
import struct
from contextlib import asynccontextmanager

import numpy as np
import pytest

grpc = pytest.importorskip("grpc")

from flax import serialization  # noqa: E402
from torch_serving import arequest  # noqa: E402

import kfserving_tpu.protocol.v2 as jax_v2  # noqa: E402
import kfserving_tpu_torch  # noqa: E402
import kfserving_tpu_torch.protocol.v2 as port_v2  # noqa: E402
from kfserving_tpu.model.model import Model as JaxBaseModel  # noqa: E402
from kfserving_tpu.models import create_model, init_params  # noqa: E402
from kfserving_tpu.observability import REGISTRY as JAX_REGISTRY  # noqa: E402
from kfserving_tpu.predictors.jax_model import JaxModel  # noqa: E402
from kfserving_tpu.predictors.jaxserver import JaxModelRepository  # noqa: E402
from kfserving_tpu.server.app import ModelServer as JaxModelServer  # noqa: E402
from kfserving_tpu_torch.model.model import Model as PortBaseModel  # noqa: E402
from kfserving_tpu_torch.observability import REGISTRY  # noqa: E402
from kfserving_tpu_torch.predictors.jaxserver.repository import (  # noqa: E402
    TorchModelRepository,
)
from kfserving_tpu_torch.predictors.llm import GenerativeModel  # noqa: E402
from kfserving_tpu_torch.predictors.torch_model import TorchModel  # noqa: E402
from kfserving_tpu_torch.protocol.grpc import kfs_generate_pb2 as gpb  # noqa: E402
from kfserving_tpu_torch.protocol.grpc import pb2  # noqa: E402
from kfserving_tpu_torch.server import grpc_server as port_grpc  # noqa: E402
from kfserving_tpu_torch.server.app import ModelServer  # noqa: E402

# fp32 MLP outputs: XLA's CPU GEMM against torch's, four inputs wide.
FP32_ATOL = 1e-6
# A logprob of the same greedy token from two runs of one engine.
LOGPROB_ATOL = 1e-4
MLP_KWARGS = {"input_dim": 4, "features": [8], "num_classes": 3}
INFER = "inference.GRPCInferenceService"
REPO = "inference.ModelRepositoryService"
GEN = "kfserving.generate.GenerationService"
GEN_CONFIG = {"architecture": "decoder_tiny",
              "arch_kwargs": dict(num_layers=2, hidden_size=64,
                                  num_heads=2, intermediate_size=128,
                                  max_seq=128),
              "max_slots": 4, "max_seq": 128, "prefill_buckets": [32, 128],
              "block_size": 16, "cache_blocks": 32, "steps_per_call": 2,
              "max_new_tokens": 12, "tokenizer": "byte"}


def _write_mlp_dir(root, name="m"):
    model_dir = os.path.join(str(root), name)
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump({"architecture": "mlp", "arch_kwargs": MLP_KWARGS,
                   "max_latency_ms": 5, "warmup": False}, f)
    spec = create_model("mlp", **MLP_KWARGS)
    with open(os.path.join(model_dir, "checkpoint.msgpack"), "wb") as f:
        f.write(serialization.to_bytes(init_params(spec, seed=0)))
    return model_dir


def _echo_class(base, v2):
    class Echo(base):
        """Returns each input tensor as "<name>_out", as decoded."""

        def load(self):
            self.ready = True
            return True

        async def predict(self, request):
            return v2.make_response(self.name, {
                f"{t.name}_out": t.as_numpy() for t in request.inputs})
    return Echo


ECHO = {"jax": _echo_class(JaxBaseModel, jax_v2),
        "torch": _echo_class(PortBaseModel, port_v2)}


def _models(kind, mlp_dir):
    mlp = (JaxModel("m", mlp_dir) if kind == "jax"
           else TorchModel("m", mlp_dir, device="cpu"))
    mlp.load()
    echo = ECHO[kind]("echo")
    echo.load()
    return [mlp, echo]


@asynccontextmanager
async def grpc_server(kind, models, **kwargs):
    cls = JaxModelServer if kind == "jax" else ModelServer
    server = cls(http_port=0, grpc_port=0, **kwargs)
    await server.start_async(models, host="127.0.0.1")
    channel = grpc.aio.insecure_channel(f"127.0.0.1:{server.grpc_port}")
    try:
        yield server, channel
    finally:
        await channel.close()
        await server.stop_async()
        for model in models:
            model.unload()


def _unary(channel, service, name, req_cls, resp_cls):
    return channel.unary_unary(
        f"/{service}/{name}", request_serializer=req_cls.SerializeToString,
        response_deserializer=resp_cls.FromString)


def _status(error: grpc.aio.AioRpcError):
    return error.code(), error.details()


async def _call(method, request):
    """(response, None) or (None, (status code, details))."""
    try:
        return await method(request), None
    except grpc.aio.AioRpcError as e:
        return None, _status(e)


def _both(drive, models_of):
    """``drive(server, channel)`` on a JAX server and on the port's."""
    async def run(kind):
        async with grpc_server(kind, models_of(kind)) as (server, channel):
            return await drive(server, channel)
    return {kind: asyncio.run(run(kind)) for kind in ("jax", "torch")}


# -- typed and raw tensors, every datatype -----------------------------------
TYPED = {
    "BOOL": np.array([True, False, True]),
    "INT8": np.array([-128, 0, 127], np.int8),
    "INT16": np.array([-32768, 5, 32767], np.int16),
    "INT32": np.array([-(2 ** 31), 7, 2 ** 31 - 1], np.int32),
    "INT64": np.array([-(2 ** 63), 9, 2 ** 63 - 1], np.int64),
    "UINT8": np.array([0, 128, 255], np.uint8),
    "UINT16": np.array([0, 40000, 65535], np.uint16),
    "UINT32": np.array([0, 3_000_000_000, 2 ** 32 - 1], np.uint32),
    "UINT64": np.array([0, 2 ** 40, 2 ** 64 - 1], np.uint64),
    "FP32": np.array([-1.5, 0.0, 3.25], np.float32),
    "FP64": np.array([-1e300, 0.1, 2.5], np.float64),
    "BYTES": np.array([b"hello", b"", "wörld".encode()], object),
}
RAW_ONLY = {"FP16": np.array([0.5, -2.0, 65504.0], np.float16),
            "BF16": np.array([0x3f80, 0xc000, 0x4049], np.uint16)}


def _typed_request(model="echo"):
    req = pb2.ModelInferRequest(model_name=model, id="typed-1")
    for dtype, values in TYPED.items():
        t = req.inputs.add(name=dtype.lower(), datatype=dtype, shape=[3])
        field = port_grpc._CONTENTS_FIELD[dtype]
        getattr(t.contents, field).extend(values.tolist())
    return req


def _raw_request(model="echo"):
    req = pb2.ModelInferRequest(model_name=model, id="raw-1")
    for dtype, values in {**TYPED, **RAW_ONLY}.items():
        req.inputs.add(name=dtype.lower(), datatype=dtype, shape=[3])
        req.raw_input_contents.append(
            b"".join(struct.pack("<I", len(v)) + v for v in values)
            if dtype == "BYTES" else values.tobytes())
    return req


def _mlp_request(raw: bool):
    x = np.random.default_rng(3).standard_normal((2, 4)).astype(np.float32)
    req = pb2.ModelInferRequest(model_name="m")
    t = req.inputs.add(name="input_0", datatype="FP32", shape=[2, 4])
    if raw:
        req.raw_input_contents.append(x.tobytes())
    else:
        t.contents.fp32_contents.extend(x.ravel().tolist())
    return req


def _bad_requests():
    ghost = pb2.ModelInferRequest(model_name="ghost")
    t = ghost.inputs.add(name="input_0", datatype="FP32", shape=[1, 4])
    t.contents.fp32_contents.extend([1, 2, 3, 4])
    short = pb2.ModelInferRequest(model_name="m")
    t = short.inputs.add(name="input_0", datatype="FP32", shape=[2, 4])
    t.contents.fp32_contents.extend([1.0])          # 1 value for 2 x 4
    fp16 = pb2.ModelInferRequest(model_name="echo")  # FP16 must go raw
    fp16.inputs.add(name="h", datatype="FP16", shape=[1])
    uneven = pb2.ModelInferRequest(model_name="echo")
    uneven.inputs.add(name="a", datatype="FP32", shape=[1])
    uneven.inputs.add(name="b", datatype="FP32", shape=[1])
    uneven.raw_input_contents.append(np.float32(1).tobytes())
    torn = pb2.ModelInferRequest(model_name="echo")  # a cut BYTES frame
    torn.inputs.add(name="s", datatype="BYTES", shape=[1])
    torn.raw_input_contents.append(struct.pack("<I", 9) + b"abc")
    return {"ghost": ghost, "short": short, "fp16": fp16,
            "uneven": uneven, "torn": torn}


@pytest.fixture(scope="module")
def exchanges(tmp_path_factory):
    """Every inference-service exchange on each server (module scope:
    the loads happen once per package)."""
    mlp_dir = _write_mlp_dir(tmp_path_factory.mktemp("grpc"))

    async def drive(server, channel):
        def infer_method(name, req_cls, resp_cls):
            return _unary(channel, INFER, name, req_cls, resp_cls)

        out = {}
        for name, req in (
                ("live", pb2.ServerLiveRequest()),
                ("ready", pb2.ServerReadyRequest()),
                ("model_ready", pb2.ModelReadyRequest(name="m")),
                ("ghost_ready", pb2.ModelReadyRequest(name="ghost")),
                ("server_metadata", pb2.ServerMetadataRequest()),
                ("model_metadata", pb2.ModelMetadataRequest(name="m")),
                ("ghost_metadata", pb2.ModelMetadataRequest(name="ghost"))):
            method = {"live": "ServerLive", "ready": "ServerReady",
                      "model_ready": "ModelReady",
                      "ghost_ready": "ModelReady",
                      "server_metadata": "ServerMetadata"}.get(
                name, "ModelMetadata")
            resp_cls = getattr(pb2, type(req).__name__.replace(
                "Request", "Response"))
            out[name] = await _call(infer_method(
                method, type(req), resp_cls), req)
        infer = infer_method("ModelInfer", pb2.ModelInferRequest,
                             pb2.ModelInferResponse)
        out["typed"] = await _call(infer, _typed_request())
        out["raw"] = await _call(infer, _raw_request())
        out["mlp_typed"] = await _call(infer, _mlp_request(raw=False))
        out["mlp_raw"] = await _call(infer, _mlp_request(raw=True))
        for name, req in _bad_requests().items():
            out[f"bad_{name}"] = await _call(infer, req)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KFS_PARAM_CACHE", str(tmp_path_factory.mktemp("params")))
        out = _both(drive, lambda kind: _models(kind, mlp_dir))
    # A module fixture runs outside tests/conftest.py's per-test reset.
    JAX_REGISTRY.reset()
    REGISTRY.reset()
    return out


def test_health_and_metadata_equal_jax(exchanges):
    jax, port = exchanges["jax"], exchanges["torch"]
    for name in ("live", "ready", "model_ready", "ghost_ready"):
        assert port[name] == jax[name], name
    assert port["live"][0].live and port["ready"][0].ready
    assert port["model_ready"][0].ready
    assert not port["ghost_ready"][0].ready
    # The server's own name and version; every other field the JAX one's.
    meta, want = port["server_metadata"][0], jax["server_metadata"][0]
    assert (meta.name, meta.version) == ("kfserving-tpu-torch",
                                         kfserving_tpu_torch.__version__)
    assert list(meta.extensions) == list(want.extensions)
    meta, want = port["model_metadata"][0], jax["model_metadata"][0]
    assert (meta.platform, want.platform) == ("pytorch", "jax")
    meta.platform = want.platform
    assert meta == want
    assert port["ghost_metadata"][1][0] == grpc.StatusCode.NOT_FOUND
    assert port["ghost_metadata"] == jax["ghost_metadata"]


@pytest.mark.parametrize("form", ["typed", "raw"])
def test_every_datatype_round_trips_as_jax(exchanges, form):
    got, err = exchanges["torch"][form]
    want, want_err = exchanges["jax"][form]
    assert err is None and want_err is None, (err, want_err)
    assert got == want
    names = [o.name for o in got.outputs]
    kinds = TYPED if form == "typed" else {**TYPED, **RAW_ONLY}
    assert names == [f"{k.lower()}_out" for k in kinds]
    if form == "raw":
        by_name = dict(zip(names, got.raw_output_contents))
        assert by_name["bf16_out"] == RAW_ONLY["BF16"].tobytes()
        assert by_name["fp16_out"] == RAW_ONLY["FP16"].tobytes()
        assert by_name["bytes_out"] == b"".join(
            struct.pack("<I", len(v)) + v for v in TYPED["BYTES"])
    else:
        for dtype, out in zip(TYPED, got.outputs):
            field = port_grpc._CONTENTS_FIELD[dtype]
            assert list(getattr(out.contents, field)) == \
                TYPED[dtype].tolist(), dtype


@pytest.mark.parametrize("form", ["mlp_typed", "mlp_raw"])
def test_model_infer_equals_jax(exchanges, form):
    got, err = exchanges["torch"][form]
    want, _ = exchanges["jax"][form]
    assert err is None
    if form == "mlp_raw":
        values = [np.frombuffer(r, np.float32)
                  for r in got.raw_output_contents]
        expect = [np.frombuffer(r, np.float32)
                  for r in want.raw_output_contents]
        got.ClearField("raw_output_contents")
        want.ClearField("raw_output_contents")
    else:
        values = [np.array(o.contents.fp32_contents) for o in got.outputs]
        expect = [np.array(o.contents.fp32_contents) for o in want.outputs]
        for msg in (got, want):
            for o in msg.outputs:
                o.contents.ClearField("fp32_contents")
    assert got == want
    assert [list(o.shape) for o in got.outputs] == [[2, 3]]
    for v, e in zip(values, expect):
        np.testing.assert_allclose(v, e, atol=FP32_ATOL, rtol=0)


@pytest.mark.parametrize("name", sorted(_bad_requests()))
def test_errors_carry_the_jax_codes_and_details(exchanges, name):
    got = exchanges["torch"][f"bad_{name}"]
    want = exchanges["jax"][f"bad_{name}"]
    assert got[0] is None and got[1] is not None
    assert got == want
    assert got[1][0] == (grpc.StatusCode.NOT_FOUND if name == "ghost"
                         else grpc.StatusCode.INVALID_ARGUMENT)


def test_repository_extension_equals_jax(tmp_path):
    _write_mlp_dir(tmp_path, name="alpha")
    _write_mlp_dir(tmp_path, name="beta")
    repos = {"jax": lambda: JaxModelRepository(models_dir=str(tmp_path)),
             "torch": lambda: TorchModelRepository(
                 models_dir=str(tmp_path), device="cpu")}

    async def run(kind):
        async with grpc_server(kind, [], registered_models=repos[kind]()
                               ) as (server, channel):
            def repo(name, req_cls, resp_cls):
                return _unary(channel, REPO, name, req_cls, resp_cls)

            load = repo("RepositoryModelLoad",
                        pb2.RepositoryModelLoadRequest,
                        pb2.RepositoryModelLoadResponse)
            unload = repo("RepositoryModelUnload",
                          pb2.RepositoryModelUnloadRequest,
                          pb2.RepositoryModelUnloadResponse)
            index = repo("RepositoryIndex", pb2.RepositoryIndexRequest,
                         pb2.RepositoryIndexResponse)
            out = [await _call(load, pb2.RepositoryModelLoadRequest(
                model_name=n)) for n in ("alpha", "beta")]
            out.append(await _call(index, pb2.RepositoryIndexRequest()))
            req = _mlp_request(raw=False)
            req.model_name = "alpha"
            resp, err = await _call(_unary(
                channel, INFER, "ModelInfer", pb2.ModelInferRequest,
                pb2.ModelInferResponse), req)
            out.append([list(o.shape) for o in resp.outputs])
            out.append(await _call(unload, pb2.RepositoryModelUnloadRequest(
                model_name="beta")))
            out.append(await _call(index, pb2.RepositoryIndexRequest(
                ready=True)))
            out.append(await _call(unload, pb2.RepositoryModelUnloadRequest(
                model_name="ghost")))
            out.append(await _call(load, pb2.RepositoryModelLoadRequest(
                model_name="ghost")))
            return out

    got, want = (asyncio.run(run(k)) for k in ("torch", "jax"))
    assert got == want
    assert [m.name for m in got[2][0].models] == ["alpha", "beta"]
    assert got[3] == [[2, 3]]
    assert [m.name for m in got[5][0].models] == ["alpha"]
    assert got[6][1][0] == grpc.StatusCode.NOT_FOUND


def _request_counts(text: str):
    """``kfserving_tpu_request_total`` of a scrape: {(model, verb,
    status): count}."""
    out = {}
    for line in text.splitlines():
        if line.startswith("kfserving_tpu_request_total{"):
            labels = dict(re.findall(r'(\w+)="([^"]*)"', line))
            out[labels["model"], labels["verb"], labels["status"]] = \
                float(line.rsplit(" ", 1)[1])
    return out


def _families(text: str):
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE ")}


def test_metrics_after_grpc_requests_equal_jax(tmp_path, monkeypatch):
    """One ModelInfer, one error and one health call: the /metrics
    families and the request series by verb and status are the JAX
    server's.  The history sampler is off on both (its tick-timed
    families are held in test_torch_observability.py)."""
    monkeypatch.setenv("KFS_HISTORY", "0")
    mlp_dir = _write_mlp_dir(tmp_path)

    async def drive(server, channel):
        infer = _unary(channel, INFER, "ModelInfer", pb2.ModelInferRequest,
                       pb2.ModelInferResponse)
        await _call(infer, _mlp_request(raw=True))
        await _call(infer, _bad_requests()["short"])
        await _call(_unary(channel, INFER, "ServerLive",
                           pb2.ServerLiveRequest, pb2.ServerLiveResponse),
                    pb2.ServerLiveRequest())
        status, _, body = await arequest(server.http_port, "GET",
                                         "/metrics")
        assert status == 200
        return body.decode()

    scrapes = {}
    for kind in ("jax", "torch"):
        JAX_REGISTRY.reset()
        REGISTRY.reset()
        models = _models(kind, mlp_dir)[:1]

        async def run():
            async with grpc_server(kind, models) as (server, channel):
                return await drive(server, channel)
        scrapes[kind] = asyncio.run(run())
    JAX_REGISTRY.reset()
    REGISTRY.reset()
    assert _families(scrapes["torch"]) == _families(scrapes["jax"])
    for text in scrapes.values():
        assert _request_counts(text) == {("m", "infer", "200"): 1,
                                         ("m", "infer", "400"): 1}


# -- the generation service --------------------------------------------------
@pytest.fixture(scope="module")
def generator(tmp_path_factory):
    model_dir = str(tmp_path_factory.mktemp("gen") / "gen")
    os.makedirs(model_dir)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(GEN_CONFIG, f)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KFS_PARAM_CACHE", str(tmp_path_factory.mktemp("params")))
        model = GenerativeModel("gen", model_dir, device="cpu")
        model.load()
    yield model
    model.unload()


@asynccontextmanager
async def gen_server(model):
    server = ModelServer(http_port=0, grpc_port=0)
    await server.start_async([model], host="127.0.0.1")
    channel = grpc.aio.insecure_channel(f"127.0.0.1:{server.grpc_port}")
    try:
        yield server, channel
    finally:
        await channel.close()
        await server.stop_async()


def _stream(channel):
    return channel.unary_stream(
        f"/{GEN}/GenerateStream",
        request_serializer=gpb.GenerateRequest.SerializeToString,
        response_deserializer=gpb.GenerateStreamResponse.FromString)


def _sse(payload: bytes):
    return [json.loads(line[len(b"data: "):])
            for line in payload.split(b"\n\n") if line.startswith(b"data: ")]


PROMPTS = [("abc", 5, 2), ("hello there", 9, 0), ("été ☃", 12, 3)]


async def test_generate_equals_http_generate(generator):
    async with gen_server(generator) as (server, channel):
        call = _unary(channel, GEN, "Generate", gpb.GenerateRequest,
                      gpb.GenerateResponse)
        for text, max_tokens, logprobs in PROMPTS:
            resp = await call(gpb.GenerateRequest(
                model_name="gen", text_input=text, max_tokens=max_tokens,
                logprobs=logprobs))
            status, _, body = await arequest(
                server.http_port, "POST", "/v2/models/gen/generate",
                {"text_input": text, "parameters": {
                    "max_tokens": max_tokens, "logprobs": logprobs}})
            assert status == 200
            want = json.loads(body)
            details = want["details"]
            assert resp.model_name == want["model_name"] == "gen"
            assert resp.text_output == want["text_output"]
            assert resp.finish_reason == details["finish_reason"]
            assert resp.token_count == details["token_count"] > 0
            records = details.get("logprobs", [])
            assert len(resp.tokens) == len(records) == (
                resp.token_count if logprobs else 0)
            for tok, chosen, rec in zip(resp.tokens, resp.chosen_logprobs,
                                        records):
                assert tok.id == chosen.id == rec["id"]
                assert abs(tok.logprob - rec["logprob"]) <= LOGPROB_ATOL
                assert [t.id for t in tok.top_logprobs] == \
                    [t["id"] for t in rec["top"]]
                np.testing.assert_allclose(
                    [t.logprob for t in tok.top_logprobs],
                    [t["logprob"] for t in rec["top"]], atol=LOGPROB_ATOL)


async def test_generate_stream_equals_sse(generator):
    async with gen_server(generator) as (server, channel):
        for text, max_tokens, logprobs in PROMPTS:
            messages = [m async for m in _stream(channel)(
                gpb.GenerateRequest(model_name="gen", text_input=text,
                                    max_tokens=max_tokens,
                                    logprobs=logprobs))]
            status, _, body = await arequest(
                server.http_port, "POST", "/v2/models/gen/generate_stream",
                {"text_input": text, "max_tokens": max_tokens,
                 "logprobs": logprobs})
            assert status == 200
            events = _sse(body)
            assert len(messages) == len(events) >= 2
            for msg, ev in zip(messages, events):
                tok = ev.get("token")
                assert msg.HasField("token") == (tok is not None)
                if tok is not None:
                    want_id = -1 if tok.get("id") is None else tok["id"]
                    assert (msg.token.id, msg.token.text) == \
                        (want_id, tok.get("text", ""))
                    assert msg.token.HasField("logprob") == \
                        ("logprob" in tok)
                    if "logprob" in tok:
                        assert abs(msg.token.logprob - tok["logprob"]) \
                            <= LOGPROB_ATOL
                    assert [t.id for t in msg.token.top_logprobs] == \
                        [t["id"] for t in tok.get("top_logprobs", [])]
                assert msg.finish_reason == (ev.get("finish_reason") or "")
            final, last = messages[-1], events[-1]
            assert final.finish_reason in ("eos", "length")
            assert final.generated_text == last["generated_text"]
            assert final.token_count == last["details"]["token_count"]
            assert "".join(m.token.text for m in messages
                           if m.HasField("token")) == final.generated_text


async def test_invalid_stream_fails_before_its_first_message(generator):
    async with gen_server(generator) as (server, channel):
        for req, code in (
                (gpb.GenerateRequest(model_name="gen", text_input="x",
                                     top_p=5.0),
                 grpc.StatusCode.INVALID_ARGUMENT),
                (gpb.GenerateRequest(model_name="nope", text_input="x"),
                 grpc.StatusCode.NOT_FOUND)):
            received = []
            with pytest.raises(grpc.aio.AioRpcError) as err:
                async for msg in _stream(channel)(req):
                    received.append(msg)
            assert err.value.code() == code and received == []
            status, _, _ = await arequest(
                server.http_port, "POST", "/v2/models/gen/generate_stream",
                {"text_input": "x", "top_p": 5.0})
            assert status == 400


async def test_cancelled_stream_frees_its_slot_and_counts_499(generator):
    engine = generator.engine
    async with gen_server(generator) as (server, channel):
        finished0 = engine.requests_finished
        tokens0 = engine.tokens_generated
        call = _stream(channel)(gpb.GenerateRequest(
            model_name="gen", text_input="cancel me", max_tokens=100))
        first = await call.read()
        assert first.HasField("token")
        call.cancel()
        pool = engine.stats()["paged"]
        for _ in range(250):
            await asyncio.sleep(0.02)
            pool = engine.stats()["paged"]
            counted = _request_counts(server.metrics.render())
            if (all(s is None for s in engine._slots)
                    and pool["free_blocks"] + pool["reclaimable_blocks"]
                    == pool["pool_blocks"] and counted):
                break
        assert all(s is None for s in engine._slots)
        assert (pool["free_blocks"] + pool["reclaimable_blocks"]
                == pool["pool_blocks"])
        assert engine.requests_finished == finished0 + 1
        assert engine.tokens_generated - tokens0 < 100
        assert counted == {("gen", "generate_stream", "499"): 1}
