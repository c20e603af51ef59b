"""The port's wire leftovers against the JAX package's, on the CPU: the
Avro codec (``kfserving_tpu_torch/protocol/avro.py``) with avro-encoded
CloudEvents served by the port, and BF16 tensors of the V2 codec
(``kfserving_tpu_torch/protocol/v2.py``).

Every schema case of ``tests/test_avro.py`` encodes to the same bytes in
both codecs and each decodes the other's bytes to the same value; the
codecs refuse the same payloads with the same errors.  The avro
CloudEvent requests of ``tests/test_avro.py`` go to a JAX package
ModelServer and to the port's: the same statuses, bodies and CloudEvent
framing.  BF16 (as ``tests/test_protocol.py`` holds the JAX codec): the
port carries the values as ``torch.bfloat16`` (uint16 bit patterns);
its JSON numbers and binary bytes equal the JAX codec's for the same
values, both ways; BF16 V2 requests, JSON and binary, to a served mlp
answer as the JAX ModelServer's (within ``LOGIT_ATOL``) and exactly as
the port's own FP32 request of the same bf16-rounded values.
"""

import asyncio
import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization
from test_avro import USER_SCHEMA
from torch_serving import arequest, load_models, serve, write_artifact

import kfserving_tpu
from kfserving_tpu.models import create_model as jax_create_model
from kfserving_tpu.models import init_params
from kfserving_tpu.observability import REGISTRY as JAX_REGISTRY
from kfserving_tpu.protocol import avro as jax_avro
from kfserving_tpu.protocol import v2 as jax_v2
from kfserving_tpu_torch.model.model import Model
from kfserving_tpu_torch.observability import REGISTRY
from kfserving_tpu_torch.protocol import avro, v2

BLOB_SCHEMA = {
    "type": "record", "name": "Blob", "fields": [
        {"name": "xs", "type": {"type": "array", "items": "long"}},
        {"name": "kv", "type": {"type": "map", "values": "string"}},
        {"name": "mood", "type": {"type": "enum", "name": "Mood",
                                  "symbols": ["HAPPY", "SAD"]}},
        {"name": "mac", "type": {"type": "fixed", "name": "Mac",
                                 "size": 4}}]}
NESTED_SCHEMA = {
    "type": "record", "name": "Outer", "fields": [
        {"name": "child", "type": {
            "type": "record", "name": "Inner", "namespace": "ns",
            "fields": [{"name": "v", "type": "long"}]}},
        {"name": "other", "type": "Inner"},
        {"name": "full", "type": "ns.Inner"}]}
EMPTY_SCHEMA = {"type": "record", "name": "E", "fields": [
    {"name": "xs", "type": {"type": "array", "items": "int"}},
    {"name": "kv", "type": {"type": "map", "values": "int"}}]}

CASES = {
    "user": ({"name": "foo", "favorite_number": 1,
              "favorite_color": "pink"}, USER_SCHEMA),
    "user_nulls": ({"name": "bar", "favorite_number": None,
                    "favorite_color": None}, USER_SCHEMA),
    "user_bytes_schema": ({"name": "z", "favorite_number": -7,
                           "favorite_color": None},
                          USER_SCHEMA.encode()),
    "true": (True, "boolean"),
    "false": (False, "boolean"),
    "long": (-1234567890123, "long"),
    "long_max": (2 ** 63 - 1, "long"),
    "long_min": (-2 ** 63, "long"),
    "int": (0, "int"),
    "double": (1.5, "double"),
    "float": (0.25, "float"),
    "bytes": (b"\x00\xff", "bytes"),
    "string": ("ünicode", "string"),
    "null": (None, "null"),
    "array_map_enum_fixed": ({"xs": [1, -2, 300], "kv": {"a": "x",
                                                         "b": "y"},
                              "mood": "SAD", "mac": b"\x01\x02\x03\x04"},
                             BLOB_SCHEMA),
    "nested_named": ({"child": {"v": 7}, "other": {"v": -9},
                      "full": {"v": 2 ** 40}}, NESTED_SCHEMA),
    "empty_array_map": ({"xs": [], "kv": {}}, EMPTY_SCHEMA),
    "union_list": ([1.5, "x", None, 3, True, {"a": 1}],
                   {"type": "array", "items": [
                       "null", "boolean", "long", "double", "string",
                       {"type": "map", "values": "int"}]}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_bytes_as_the_jax_codec(case):
    value, schema = CASES[case]
    payload = avro.encode(value, schema)
    assert payload == jax_avro.encode(value, schema)
    assert avro.decode(payload, schema) == jax_avro.decode(payload, schema)
    assert avro.decode(payload, schema) == value


def test_known_wire_bytes():
    value, schema = CASES["user"]
    assert avro.encode(value, schema) == b"\x06foo\x00\x02\x00\x08pink"


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # compared across the packages
        return ("raised", type(e).__name__, str(e))


def test_refusals_match_the_jax_codec():
    good = avro.encode(*CASES["user"])
    blob = avro.encode(*CASES["array_map_enum_fixed"])
    decodes = [(good[:-2], USER_SCHEMA), (b"\x06fo", USER_SCHEMA),
               (b"\x00\x06", USER_SCHEMA), (b"\x0a", "bytes"),
               (b"\x80", "long"), (b"\xff" * 11, "long"),
               (b"\x04", {"type": "enum", "name": "E",
                          "symbols": ["A"]}),
               (b"\x02\x00", ["null"]), (blob[:-1], BLOB_SCHEMA),
               (b"", "double"), (b"\x00", {"type": "nope"})]
    encodes = [({"name": "x", "favorite_number": 1.5,
                 "favorite_color": None}, USER_SCHEMA),
               (b"\x01", {"type": "fixed", "name": "F", "size": 2}),
               ("C", {"type": "enum", "name": "E", "symbols": ["A"]}),
               (1, {"type": "nope"})]
    for payload, schema in decodes:
        got = _outcome(lambda: avro.decode(payload, schema))
        assert got == _outcome(lambda: jax_avro.decode(payload, schema))
        assert got[0] == "raised", (payload, schema)
    for value, schema in encodes:
        got = _outcome(lambda: avro.encode(value, schema))
        assert got == _outcome(lambda: jax_avro.encode(value, schema))
        assert got[0] == "raised", (value, schema)


def _answer(request, decode):
    if isinstance(request, (bytes, bytearray)):
        record = decode(request, USER_SCHEMA)
        return {"predictions": [[record["name"], record["favorite_number"],
                                 record["favorite_color"]]]}
    return {"predictions": request["instances"]}


class _AvroPort(Model):
    def load(self):
        self.ready = True
        return True

    async def predict(self, request):
        return _answer(request, avro.decode)


class _AvroJax(kfserving_tpu.Model):
    def load(self):
        self.ready = True
        return True

    async def predict(self, request):
        return _answer(request, jax_avro.decode)


def _ce_headers(content_type=None):
    headers = {"ce-specversion": "1.0",
               "ce-id": "36077800-0c23-4f38-a0b4-01f4369f670a",
               "ce-source": "https://example.com/event-producer",
               "ce-type": "com.example.sampletype1"}
    if content_type:
        headers["content-type"] = content_type
    return headers


SERVED = {
    "avro_form_urlencoded": (avro.encode(*CASES["user"]),
                             _ce_headers("application/x-www-form-urlencoded")),
    "avro_no_content_type": (avro.encode(*CASES["user_nulls"]),
                             _ce_headers()),
    "avro_octet_stream": (avro.encode(*CASES["user"]),
                          _ce_headers("application/octet-stream")),
    "bad_json_400": (b"{", _ce_headers("application/json")),
    "bad_hex_400": (b"0\x80\x80\x06World!\x00\x00",
                    _ce_headers("application/json")),
    "json_ce": (json.dumps({"instances": [[1, 2]]}).encode(),
                _ce_headers("application/json")),
    "avro_truncated_500": (avro.encode(*CASES["user"])[:-2],
                           _ce_headers("application/octet-stream")),
}


@pytest.fixture(scope="module")
def served():
    out = {}
    for pkg, cls in (("jax", _AvroJax), ("torch", _AvroPort)):
        model = cls("TestModel")
        model.load()

        async def drive(server):
            return {name: await arequest(
                server.http_port, "POST", "/v1/models/TestModel:predict",
                body, headers) for name, (body, headers) in SERVED.items()}

        out[pkg] = asyncio.run(serve(pkg, [model], drive))
    JAX_REGISTRY.reset()
    REGISTRY.reset()
    return out


def _framing(headers):
    return {k: v for k, v in headers.items()
            if (k.startswith("ce-") and k != "ce-time")
            or k == "content-type"}


@pytest.mark.parametrize("name", sorted(SERVED))
def test_avro_cloudevents_served_as_the_jax_server(served, name):
    jax_status, jax_headers, jax_body = served["jax"][name]
    status, headers, body = served["torch"][name]
    assert status == jax_status
    assert _framing(headers) == _framing(jax_headers)
    if name.endswith("_500"):
        assert json.loads(body).keys() == json.loads(jax_body).keys()
    else:
        assert json.loads(body) == json.loads(jax_body)
    want = {"avro_form_urlencoded": 200, "avro_no_content_type": 200,
            "avro_octet_stream": 200, "bad_json_400": 400,
            "bad_hex_400": 400, "json_ce": 200,
            "avro_truncated_500": 500}[name]
    assert status == want
    if name == "avro_form_urlencoded":
        assert json.loads(body)["predictions"] == [["foo", 1, "pink"]]
        assert headers["ce-id"] == "36077800-0c23-4f38-a0b4-01f4369f670a"
        assert headers["ce-datacontenttype"] == headers["content-type"] \
            == "application/x-www-form-urlencoded"
    if name.startswith("bad"):
        assert b"Unrecognized request format" in body


# ---------------------------------------------------------------- BF16 --
def _bf16_values(seed=0, n=64):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(size=n) * 10.0 ** rng.integers(-8, 8, n),
                        [0.0, -0.0, 1.5, 2.5, 3.4e38, -1e-40, np.inf]])
    return x.reshape(-1, 1)


def _pair(seed=0):
    """The same values as an ml_dtypes array (the JAX codec's) and a
    torch.bfloat16 tensor (the port's)."""
    ref = _bf16_values(seed).astype(ml_dtypes.bfloat16)
    port = torch.from_numpy(ref.view(np.int16).copy()).view(torch.bfloat16)
    return ref, port


def _bits(t):
    return t.view(torch.int16).numpy().view(np.uint16)


def test_bf16_encoding_as_test_protocol():
    arr = torch.tensor([1.5, 2.5], dtype=torch.bfloat16)
    out = v2.tensor_to_output("y", arr)
    assert out["datatype"] == "BF16" and out["shape"] == [2]
    assert out["data"] == [1.5, 2.5]
    back = v2.InferInput("y", out["shape"], "BF16", out["data"]).as_numpy()
    assert back.dtype == torch.bfloat16
    assert torch.equal(back, arr)
    assert v2.datatype_of(arr) == "BF16"


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_json_equals_the_jax_codec(seed):
    ref, port = _pair(seed)
    out = v2.tensor_to_output("y", port)
    assert out == jax_v2.tensor_to_output("y", ref)
    assert v2.make_response("m", {"y": port}, id="i") == \
        jax_v2.make_response("m", {"y": ref}, id="i")
    # Both decode the JSON numbers to the same bits, from float32
    # outputs and from arbitrary float64 inputs alike.
    floats = _bf16_values(seed + 10).ravel().tolist()
    for data in (out["data"], floats):
        shape = [len(data)]
        got = v2.InferInput("y", shape, "BF16", data).as_numpy()
        want = jax_v2.InferInput("y", shape, "BF16", data).as_numpy()
        assert np.array_equal(_bits(got), want.view(np.uint16))


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_binary_equals_the_jax_codec(seed):
    ref, port = _pair(seed)
    body, hlen = v2.make_binary_request({"y": port}, id="b",
                                        binary_output=True)
    assert (body, hlen) == jax_v2.make_binary_request(
        {"y": ref}, id="b", binary_output=True)
    # Each side decodes the other's request to the same bits; the
    # port's predictors get them widened exactly to float32.
    req = v2.InferRequest.from_binary(body, hlen)
    got = req.inputs[0].as_numpy()
    want = jax_v2.InferRequest.from_binary(body, hlen).named_numpy()["y"]
    assert got.dtype == torch.bfloat16 and list(got.shape) == \
        list(want.shape)
    assert np.array_equal(_bits(got), want.view(np.uint16))
    widened = req.named_numpy()["y"]
    assert widened.dtype == np.float32
    assert np.array_equal(widened, want.astype(np.float32))
    # The binary response of a BF16 output: same bytes, same decode.
    resp = v2.make_response("m", {"y": port})
    body, hlen = v2.encode_binary_response(resp)
    assert (body, hlen) == jax_v2.encode_binary_response(
        jax_v2.make_response("m", {"y": ref}))
    got = v2.decode_binary_response(body, hlen)["outputs"][0]["data"]
    want = jax_v2.decode_binary_response(body, hlen)["outputs"][0]["data"]
    assert np.array_equal(_bits(got), want.view(np.uint16))


def test_bf16_refusals():
    odd = v2.InferInput("y", [1], "BF16", None, {"binary_data_size": 3},
                        raw=b"\x00\x00\x00")
    with pytest.raises(v2.InvalidInput, match="does not fit datatype BF16"):
        odd.as_numpy()
    with pytest.raises(v2.InvalidInput, match="does not match shape"):
        v2.InferInput("y", [4], "BF16", [1.0, 2.0]).as_numpy()
    with pytest.raises(v2.InvalidInput, match="no binary body"):
        v2.InferInput("y", [1], "BF16", None,
                      {"binary_data_size": 2}).as_numpy()


# The served mlp computes its hidden layer in bf16 on both sides (the
# JAX registry's mlp has no dtype argument): its output is rounded to
# bf16 (8 mantissa bits) at different places; logits are O(1), as
# tests/test_torch_repository.py's BF16_ATOL.
LOGIT_ATOL = 0.02
MLP_KWARGS = {"input_dim": 8, "features": [16], "num_classes": 4}


def _mlp_artifact(root):
    model_dir = write_artifact(root, "mlp", {
        "architecture": "mlp", "arch_kwargs": MLP_KWARGS,
        "output": "logits", "batch_buckets": [1, 4], "max_batch_size": 4,
        "max_latency_ms": 2, "warmup": False})
    spec = jax_create_model("mlp", **MLP_KWARGS)
    with open(os.path.join(model_dir, "checkpoint.msgpack"), "wb") as f:
        f.write(serialization.to_bytes(init_params(spec, seed=1)))
    return model_dir


def _mlp_requests():
    """{case: (body, headers)}: the same bf16-rounded rows as BF16 JSON,
    BF16 binary and FP32 JSON."""
    normal = np.random.default_rng(3).normal(size=(3, 8))
    rows_bf16 = torch.from_numpy(normal).to(torch.bfloat16)
    rows = rows_bf16.float().numpy()
    json_headers = {"content-type": "application/json"}
    out = {}
    for case, datatype in (("bf16_json", "BF16"), ("fp32_json", "FP32")):
        out[case] = ({"id": case, "inputs": [{
            "name": "input_0", "datatype": datatype, "shape": [3, 8],
            "data": rows.ravel().tolist()}]}, json_headers)
    body, hlen = v2.make_binary_request({"input_0": rows_bf16},
                                        id="bf16_binary")
    out["bf16_binary"] = (body, {
        "content-type": "application/octet-stream",
        "inference-header-content-length": str(hlen)})
    return out


def test_bf16_requests_to_a_served_model_as_the_jax_server(tmp_path):
    artifacts = {"mlp": _mlp_artifact(str(tmp_path))}
    requests = _mlp_requests()
    got = {}
    for pkg in ("jax", "torch"):
        async def drive(server):
            return {case: await arequest(
                server.http_port, "POST", "/v2/models/mlp/infer", body,
                headers) for case, (body, headers) in requests.items()}

        got[pkg] = asyncio.run(serve(pkg, load_models(pkg, artifacts),
                                     drive))
    JAX_REGISTRY.reset()
    REGISTRY.reset()
    logits = {}
    for pkg, answers in got.items():
        for case, (status, _, body) in answers.items():
            assert status == 200, (pkg, case, body)
            out = json.loads(body)
            assert out["id"] == case and out["model_name"] == "mlp"
            (output,) = out["outputs"]
            assert output["shape"] == [3, 4]
            logits[(pkg, case)] = np.reshape(output["data"], [3, 4])
    for case in requests:
        np.testing.assert_allclose(logits[("torch", case)],
                                   logits[("jax", case)],
                                   atol=LOGIT_ATOL, rtol=0)
        assert np.array_equal(logits[("torch", case)],
                              logits[("torch", "fp32_json")])
