"""The V2 binary data extension of the port (``kfserving_tpu_torch/protocol/
v2.py``, ``server/dataplane.py``, ``server/app.py``) on the CPU, held
against the JAX package's (``kfserving_tpu/protocol/v2.py``): each side
decodes the other's bodies, the error texts agree, the binary wire
through the port's server answers as its JSON wire does, and a
``binary_data_output`` response decodes with the JAX package's
``decode_binary_response``.  Also ``GET /debug/cache``.

Mirrors ``tests/test_protocol.py``'s binary cases and
``tests/test_jaxserver.py``'s binary server cases.  Tolerance: tensors
and answers are compared exactly (the same bytes on either wire).
"""

import asyncio
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

from kfserving_tpu.protocol import v2 as jax_v2
from kfserving_tpu.protocol.errors import InvalidInput as JaxInvalidInput
from kfserving_tpu_torch.engine.hbm import HBMManager
from kfserving_tpu_torch.predictors.jaxserver.repository import (
    TorchModelRepository,
)
from kfserving_tpu_torch.predictors.torch_model import TorchModel
from kfserving_tpu_torch.protocol import v2
from kfserving_tpu_torch.protocol.errors import InvalidInput
from kfserving_tpu_torch.server.app import ModelServer
from kfserving_tpu_torch.server.dataplane import DataPlane

MLP_KWARGS = {"input_dim": 8, "features": [16], "num_classes": 4}
TENSORS = {
    "images": np.arange(2 * 3 * 4, dtype=np.uint8).reshape(2, 3, 4),
    "x": np.linspace(-1, 1, 6, dtype=np.float32).reshape(3, 2),
    "ids": np.array([[7, -8, 9]], np.int32),
    "flags": np.array([True, False]),
    "half": np.array([0.5, -2.0], np.float16),
}


@pytest.mark.parametrize("name", sorted(TENSORS))
def test_port_decodes_jax_binary_requests(name):
    arr = TENSORS[name]
    body, hlen = jax_v2.make_binary_request({name: arr}, id="q")
    req = v2.InferRequest.from_binary(body, hlen)
    assert req.id == "q" and req.inputs[0].binary_data_size == arr.nbytes
    out = req.named_numpy()[name]
    assert out.dtype == arr.dtype
    np.testing.assert_array_equal(out, arr)


@pytest.mark.parametrize("name", sorted(TENSORS))
def test_jax_decodes_port_binary_requests(name):
    arr = TENSORS[name]
    body, hlen = v2.make_binary_request({name: arr}, binary_output=True)
    assert (body, hlen) == jax_v2.make_binary_request(
        {name: arr}, binary_output=True)
    req = jax_v2.InferRequest.from_binary(body, hlen)
    assert req.parameters == {"binary_data_output": True}
    np.testing.assert_array_equal(req.named_numpy()[name], arr)


def test_bytes_tensors_and_mixed_json_inputs():
    words = np.array([b"alpha", b"", "b\xc3\xa9ta".encode()], np.object_)
    body, hlen = jax_v2.make_binary_request({"w": words})
    got = v2.InferRequest.from_binary(body, hlen).named_numpy()["w"]
    assert got.tolist() == words.tolist()
    assert v2.decode_raw_bytes(v2.frame_raw_bytes(["a", b"bc"])) == \
        [b"a", b"bc"]
    assert v2.frame_raw_bytes(["a", b"bc"]) == \
        jax_v2.frame_raw_bytes(["a", b"bc"])
    raw = np.ones((2, 2), np.float32)
    header = json.dumps({"inputs": [
        {"name": "a", "shape": [2, 2], "datatype": "FP32",
         "parameters": {"binary_data_size": raw.nbytes}},
        {"name": "b", "shape": [2], "datatype": "INT32", "data": [7, 8]},
    ]}).encode()
    for mod in (v2, jax_v2):
        named = mod.InferRequest.from_binary(
            header + raw.tobytes(), len(header)).named_numpy()
        np.testing.assert_array_equal(named["a"], raw)
        np.testing.assert_array_equal(named["b"], [7, 8])


def _error(mod, fn):
    with pytest.raises((InvalidInput, JaxInvalidInput)) as err:
        fn(mod)
    return str(err.value)


@pytest.mark.parametrize("case", ["header_too_long", "header_zero",
                                  "short_body", "trailing", "bad_json",
                                  "misfit", "no_binary_body",
                                  "short_bytes", "response_overrun"])
def test_error_texts_match_the_jax_package(case):
    arr = np.arange(6, dtype=np.float32)
    body, hlen = jax_v2.make_binary_request({"x": arr})
    misfit = json.dumps({"inputs": [
        {"name": "x", "shape": [3], "datatype": "FP32",
         "parameters": {"binary_data_size": 5}}]}).encode()
    cases = {
        "header_too_long": lambda m: m.InferRequest.from_binary(
            body, len(body) + 1),
        "header_zero": lambda m: m.InferRequest.from_binary(body, 0),
        "short_body": lambda m: m.InferRequest.from_binary(body[:-4], hlen),
        "trailing": lambda m: m.InferRequest.from_binary(body + b"xx", hlen),
        "bad_json": lambda m: m.InferRequest.from_binary(b"{nope" + body, 5),
        "misfit": lambda m: m.InferRequest.from_binary(
            misfit + b"12345", len(misfit)).named_numpy(),
        "no_binary_body": lambda m: m.InferRequest.from_dict(json.loads(
            body[:hlen])).named_numpy(),
        "short_bytes": lambda m: m.decode_raw_bytes(b"\x05\x00\x00\x00ab"),
        "response_overrun": lambda m: m.decode_binary_response(
            _binary_response()[0][:-3], _binary_response()[1]),
    }
    assert _error(v2, cases[case]) == _error(jax_v2, cases[case])


def _response():
    return {"model_name": "m", "id": "7", "outputs": [
        jax_v2.tensor_to_output("values", np.array([[0.5, 0.25]],
                                                   np.float32)),
        jax_v2.tensor_to_output("indices", np.array([[3, 1]], np.int32)),
        jax_v2.tensor_to_output("words", np.array(["hi", "there"]))]}


def _binary_response():
    return jax_v2.encode_binary_response(_response())


def test_binary_responses_match_the_jax_package():
    resp = _response()
    assert v2.encode_binary_response(resp) == \
        jax_v2.encode_binary_response(resp)
    assert v2.make_response("m", {"w": np.array(["hi", "there"])}) == \
        jax_v2.make_response("m", {"w": np.array(["hi", "there"])})
    body, hlen = v2.encode_binary_response(resp)
    for mod in (v2, jax_v2):
        out = {o["name"]: o for o in
               mod.decode_binary_response(body, hlen)["outputs"]}
        np.testing.assert_array_equal(out["values"]["data"],
                                      [[0.5, 0.25]])
        assert out["indices"]["data"].dtype == np.int32
        assert out["words"]["data"] == [b"hi", b"there"]


def test_decode_body_takes_the_binary_branch():
    body, hlen = jax_v2.make_binary_request({"x": TENSORS["x"]})
    req = DataPlane.decode_body(
        {v2.INFERENCE_HEADER_CONTENT_LENGTH: str(hlen)}, body)
    assert isinstance(req, v2.InferRequest)
    assert DataPlane.decode_body({}, b'{"instances": [1]}') == \
        {"instances": [1]}
    with pytest.raises(InvalidInput, match="out of range"):
        DataPlane.decode_body(
            {v2.INFERENCE_HEADER_CONTENT_LENGTH: "0"}, body)
    with pytest.raises(InvalidInput, match="invalid literal"):
        DataPlane.decode_body(
            {v2.INFERENCE_HEADER_CONTENT_LENGTH: "ten"}, body)


def _post(port, path, body, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, method="POST",
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as resp:
        return json.loads(resp.read())


def _model_dir(root, output, extra=None):
    d = os.path.join(str(root), f"m-{output}")
    os.makedirs(d, exist_ok=True)
    cfg = {"architecture": "mlp", "arch_kwargs": MLP_KWARGS,
           "max_latency_ms": 2, "warmup": False, "output": output,
           "topk": 2}
    cfg.update(extra or {})
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f)
    return d


@pytest.mark.parametrize("output", ["argmax", "topk", "logits"])
async def test_binary_wire_answers_as_the_json_wire(tmp_path, output):
    """The same rows as V2 JSON and as V2 binary through the port's
    server: the same answer, the binary one as raw bytes when asked."""
    model = TorchModel("m", _model_dir(tmp_path, output), device="cpu")
    model.load()
    server = ModelServer(http_port=0)
    await server.start_async([model], host="127.0.0.1")
    port = server.http_port
    x = np.random.default_rng(0).normal(size=(3, 8)).astype(np.float32)
    try:
        json_body = json.dumps({"id": "j", "inputs": [{
            "name": "input_0", "shape": [3, 8], "datatype": "FP32",
            "data": x.ravel().tolist()}]}).encode()
        status, _, raw = await asyncio.to_thread(
            _post, port, "/v2/models/m/infer", json_body)
        assert status == 200, raw
        expect = json.loads(raw)
        body, hlen = jax_v2.make_binary_request({"input_0": x}, id="j")
        status, headers, raw = await asyncio.to_thread(
            _post, port, "/v2/models/m/infer", body,
            {"Inference-Header-Content-Length": str(hlen),
             "Content-Type": "application/octet-stream"})
        assert status == 200, raw
        assert json.loads(raw) == expect                 # JSON answer
        body, hlen = jax_v2.make_binary_request({"input_0": x}, id="j",
                                                binary_output=True)
        status, headers, raw = await asyncio.to_thread(
            _post, port, "/v2/models/m/infer", body,
            {"Inference-Header-Content-Length": str(hlen)})
        assert status == 200, raw
        headers = {k.lower(): v for k, v in headers.items()}
        assert headers["content-type"] == "application/octet-stream"
        resp = jax_v2.decode_binary_response(
            raw, int(headers["inference-header-content-length"]))
        assert resp["id"] == "j" and resp["model_name"] == "m"
        got = {o["name"]: o for o in resp["outputs"]}
        for out in expect["outputs"]:
            assert got[out["name"]]["datatype"] == out["datatype"]
            np.testing.assert_array_equal(
                got[out["name"]]["data"],
                np.reshape(out["data"], out["shape"]))
        status, _, raw = await asyncio.to_thread(
            _post, port, "/v2/models/m/infer", body[:-4],
            {"Inference-Header-Content-Length": str(hlen)})
        assert status == 400 and b"overruns" in raw
    finally:
        await server.stop_async()
        model.unload()


async def test_uint8_binary_images_answer_as_v1(tmp_path):
    """The image wire: UINT8 rows as raw bytes answer as the same rows
    as V1 JSON numbers."""
    model = TorchModel("img", _model_dir(
        tmp_path, "argmax", {"input_dtype": "uint8", "scale": 1 / 255.0}),
        device="cpu")
    model.load()
    server = ModelServer(http_port=0)
    await server.start_async([model], host="127.0.0.1")
    port = server.http_port
    rows = np.random.default_rng(3).integers(0, 256, (5, 8)).astype(np.uint8)
    try:
        status, _, raw = await asyncio.to_thread(
            _post, port, "/v1/models/img:predict",
            json.dumps({"instances": rows.tolist()}).encode())
        assert status == 200, raw
        v1_answer = json.loads(raw)["predictions"]
        body, hlen = v2.make_binary_request({"images": rows})
        status, _, raw = await asyncio.to_thread(
            _post, port, "/v2/models/img/infer", body,
            {"Inference-Header-Content-Length": str(hlen)})
        assert status == 200, raw
        out = json.loads(raw)["outputs"][0]
        assert out["shape"] == [5] and out["data"] == v1_answer
    finally:
        await server.stop_async()
        model.unload()


async def test_debug_cache_shows_ledger_and_residency(tmp_path):
    for name in ("a", "b"):
        os.makedirs(os.path.join(str(tmp_path), name))
        with open(os.path.join(str(tmp_path), name, "config.json"),
                  "w") as f:
            json.dump({"architecture": "mlp", "arch_kwargs": MLP_KWARGS,
                       "max_latency_ms": 2, "warmup": False}, f)
    repo = TorchModelRepository(models_dir=str(tmp_path),
                                hbm=HBMManager(budget_bytes=10 ** 6),
                                device="cpu")
    server = ModelServer(http_port=0, registered_models=repo)
    await server.start_async([], host="127.0.0.1")
    port = server.http_port
    try:
        for name in ("a", "b"):
            status, _, _ = await asyncio.to_thread(
                _post, port, f"/v2/repository/models/{name}/load", b"")
            assert status == 200
        status, _, _ = await asyncio.to_thread(
            _post, port, "/v1/models/a:predict",
            json.dumps({"instances": [[0.0] * 8]}).encode())
        assert status == 200
        cache = await asyncio.to_thread(_get, port, "/debug/cache")
        assert set(cache) == {"models", "hbm", "residency", "host_tier"}
        assert cache["models"] == {} and cache["host_tier"] is None
        assert set(cache["hbm"]) == {"budget_bytes", "used_bytes",
                                     "resident", "evictions",
                                     "eviction_skips"}
        assert [r["model"] for r in cache["hbm"]["resident"]] == ["a"]
        res = cache["residency"]
        assert res["registered"] == 2 and res["resident"] == 1
        assert res["models"]["a"]["state"] == "resident"
        assert res["models"]["b"]["state"] == "registered"
        assert res["fault_in_ms"]["cold_count"] == 1
        assert {"evictions_total", "eviction_skips_total",
                "eviction_storms"} <= set(res)
    finally:
        await server.stop_async()
        for model in repo.get_models():
            model.unload()
    bare = ModelServer(http_port=0)
    assert bare.cache_snapshot() == {"models": {}, "hbm": None,
                                     "residency": None, "host_tier": None}
