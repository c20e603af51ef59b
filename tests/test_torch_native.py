"""The port's native V1 JSON codec (``kfserving_tpu_torch/protocol/
native.py`` and ``csrc/tensorjson.c``) against the JAX package's, on the
CPU.

Each codec path is held against its counterpart: the port's compiled
module (built here by its own ``csrc/build.py::build_extension``) against
the JAX package's compiled module, and the port's pure-Python fallback
against the JAX package's ``_parse_v1_py``.  Results must be equal, not
close: the same key, dtype, shape and values, and byte-equal dumps.
"""

import asyncio
import json
import os

import numpy as np
import pytest
import torch

from kfserving_tpu.protocol import native as jax_native
from kfserving_tpu_torch.models import registry as port_registry
from kfserving_tpu_torch.models.resnet import ResNet
from kfserving_tpu_torch.predictors.torch_model import TorchModel
from kfserving_tpu_torch.protocol import native
from kfserving_tpu_torch.server.app import ModelServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def built():
    # The JAX package's own tests build its extension the same way.
    jax_native.build()
    assert jax_native.available()
    assert native.available(), "the port's tensorjson.c did not build"


@pytest.fixture(params=["native", "python"])
def codecs(request, monkeypatch):
    """(port parse_v1, reference parse_v1) for one codec path."""
    if request.param == "python":
        monkeypatch.setattr(native, "_native", False)
        return native.parse_v1, jax_native._parse_v1_py
    return native.parse_v1, jax_native.parse_v1


def _bodies():
    rng = np.random.default_rng(0)
    bodies = {
        "f32_2d": ({"instances": rng.standard_normal((3, 5)).astype(
            np.float32).tolist()}, None),
        "f32_3d": ({"inputs": rng.standard_normal((2, 3, 4)).tolist()},
                   None),
        "i32_2d": ({"instances": rng.integers(-1000, 1000, (4, 6))
                    .tolist()}, None),
        "i32_3d": ({"instances": rng.integers(0, 2 ** 20, (2, 2, 5))
                    .tolist()}, "u1"),
        "u1_image": ({"instances": rng.integers(0, 256, (2, 8, 8, 3))
                      .tolist()}, "u1"),
        "u1_out_of_range": ({"instances": rng.integers(0, 300, (3, 7))
                             .tolist()}, "u1"),
        "u1_negative": ({"instances": [[0, 5, -1], [255, 4, 3]]}, "u1"),
        "u1_floats": ({"instances": [[0.5, 5.0], [255.0, 1.0]]}, "u1"),
        "u1_without_hint": ({"instances": [[0, 5], [255, 4]]}, None),
        "beyond_int32": ({"instances": [[1, 2 ** 31], [3, -2 ** 40]]},
                         None),
        "int32_edge": ({"instances": [[2 ** 31 - 1, -2 ** 31]]}, None),
        "mixed_int_float": ({"instances": [[1, 2.5], [3, 4]]}, None),
        "exponents": ({"instances": [[1e-3, 2.5e20, -7e-30]]}, None),
        "empty": ({"instances": []}, None),
        "extra_keys": ({"instances": [[1, 2]], "parameters": {"a": 1}},
                       None),
        "extra_keys_first": ({"signature_name": "s",
                              "inputs": [[1.0, 2.0]]}, None),
        "ragged": ({"instances": [[1, 2], [3]]}, None),
        "ragged_depth": ({"instances": [[1, 2], 3]}, None),
        "strings": ({"instances": ["a", "b"]}, None),
        "dict_instances": ({"instances": [{"a": 1}]}, None),
        "v2": ({"inputs": [{"name": "x", "datatype": "FP32",
                            "shape": [1, 2], "data": [1, 2]}]}, None),
        "no_tensor_key": ({"data": [1, 2]}, None),
        "scalar": ({"instances": 3}, None),
    }
    out = {name: (json.dumps(body).encode(), hint)
           for name, (body, hint) in bodies.items()}
    out["indented"] = (json.dumps({"instances": [[1, 2], [3, 4]]},
                                  indent=2).encode(), None)
    out["not_json"] = (b'{"instances": [[1, 2]', None)
    out["top_level_list"] = (b"[[1, 2]]", None)
    return out


BODIES = _bodies()


@pytest.mark.parametrize("name", sorted(BODIES))
def test_parse_v1_equals_reference(name, codecs):
    port_parse, ref_parse = codecs
    body, hint = BODIES[name]
    got, want = port_parse(body, hint), ref_parse(body, hint)
    if want is None:
        assert got is None
        return
    (arr, key), (ref_arr, ref_key) = got, want
    assert key == ref_key
    assert arr.dtype == ref_arr.dtype and arr.shape == ref_arr.shape
    np.testing.assert_array_equal(arr, ref_arr)


def test_parse_counts_follow_the_codec(monkeypatch):
    body = json.dumps({"instances": [[1, 2, 3]]}).encode()
    before = dict(native.parse_counts)
    native.parse_v1(body, "u1")
    native.parse_v1(b'{"instances": ["x"]}')          # ineligible
    monkeypatch.setattr(native, "_native", False)
    native.parse_v1(body)
    assert {k: native.parse_counts[k] - before[k] for k in before} == \
        {"native": 1, "python": 1}


def _dump_arrays():
    rng = np.random.default_rng(1)
    special = np.array([[np.nan, np.inf, -np.inf], [1.0, -2.0, 0.0],
                        [1e20, 1e-30, 3.5]], np.float32)
    return {
        "2d": rng.standard_normal((4, 3)).astype(np.float32),
        "3d": rng.standard_normal((2, 3, 2)).astype(np.float32),
        "non_finite": special,
        "integral": np.arange(-3, 3, dtype=np.float32).reshape(2, 3),
    }


@pytest.mark.parametrize("name", sorted(_dump_arrays()))
@pytest.mark.parametrize("path", ["native", "python"])
def test_dump_f32_equals_reference(name, path, monkeypatch):
    arr = _dump_arrays()[name]
    if path == "python":
        monkeypatch.setattr(native, "_native", False)
        monkeypatch.setattr(jax_native, "_native", False)
    assert native.dump_f32(arr) == jax_native.dump_f32(arr)
    body = {"predictions": arr}
    assert native.dump_response(body) == jax_native.dump_response(body)


def test_dump_response_eligibility():
    f32 = np.ones((2, 2), np.float32)
    for body in ({"predictions": f32.astype(np.int32)},
                 {"predictions": f32, "id": "x"},
                 {"predictions": f32.tolist()},
                 {"predictions": np.float32(1.0)}):
        assert native.dump_response(body) is None
        assert jax_native.dump_response(body) is None


def test_c_source_is_the_reference_codec():
    """The port's tensorjson.c differs from the JAX package's only in its
    header comment and module docstring."""
    def code(path):
        with open(os.path.join(REPO, path)) as f:
            text = f.read()
        body = text[text.index("#define PY_SSIZE_T_CLEAN"):]
        return [line for line in body.splitlines()
                if "codec for the" not in line]

    assert code("kfserving_tpu_torch/csrc/tensorjson.c") == \
        code("csrc/tensorjson.c")


def _tiny_resnet(**kwargs):
    with torch.device("meta"):
        module = ResNet([1, 1, 1, 1], num_filters=8, num_classes=7,
                        dtype="float32", image_size=16)
    return module, np.zeros((1, 16, 16, 3), np.float32)


def test_uint8_v1_body_takes_the_native_path(tmp_path, monkeypatch):
    """A uint8 model's V1 body served over HTTP: the native codec parses
    it straight to uint8, and the served top-k equals the json.loads
    path's bit for bit."""
    monkeypatch.setitem(port_registry._REGISTRY, "tiny_resnet",
                        _tiny_resnet)
    with open(os.path.join(str(tmp_path), "config.json"), "w") as f:
        json.dump({"architecture": "tiny_resnet", "batch_buckets": [1],
                   "max_batch_size": 1, "max_latency_ms": 1,
                   "warmup": False, "input_dtype": "uint8",
                   "scale": 1 / 255.0, "output": "topk", "topk": 3}, f)
    model = TorchModel("img", str(tmp_path), device="cpu")
    model.load()
    assert model.wire_dtype == "u1"
    image = np.random.default_rng(2).integers(0, 256, (16, 16, 3))
    body = json.dumps({"instances": [image.tolist()]}).encode()

    async def serve():
        server = ModelServer(http_port=0)
        await server.start_async([model], host="127.0.0.1")
        try:
            return await asyncio.to_thread(_post, server.http_port, body)
        finally:
            await server.stop_async()

    try:
        before = native.parse_counts["native"]
        fast = asyncio.run(serve())
        assert native.parse_counts["native"] == before + 1
        monkeypatch.setattr(native, "parse_v1", lambda *a, **k: None)
        slow = asyncio.run(serve())
        assert native.parse_counts["native"] == before + 1
    finally:
        model.unload()
    assert fast == slow
    preds = json.loads(fast)["predictions"]
    assert len(preds) == 1 and len(preds[0]["indices"]) == 3


def _post(port, body):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", "/v1/models/img:predict", body=body)
        resp = conn.getresponse()
        data = resp.read()
        assert resp.status == 200, data
        return data
    finally:
        conn.close()


def test_decode_body_native_array_feeds_the_same_inputs():
    """The parsed uint8 array and the json.loads lists give the model the
    same fp32 inputs (the uint8 scale of the served path)."""
    from kfserving_tpu_torch.model.repository import ModelRepository
    from kfserving_tpu_torch.server.dataplane import DataPlane

    image = np.random.default_rng(3).integers(0, 256, (2, 4, 4, 3))
    body = json.dumps({"instances": image.tolist()}).encode()
    dp = DataPlane(ModelRepository())
    fast = dp.decode_body({}, body, dtype_hint="u1")["instances"]
    slow = np.asarray(json.loads(body)["instances"]).astype(np.uint8)
    assert fast.dtype == np.uint8
    scale = float(torch.tensor(1 / 255.0, dtype=torch.bfloat16))
    np.testing.assert_array_equal(
        torch.from_numpy(np.stack(list(fast))).float() * scale,
        torch.from_numpy(slow).float() * scale)
