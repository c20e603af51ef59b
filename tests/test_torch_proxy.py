"""The port's proxy hop (``Model.predict`` / ``explain`` with
``predictor_host`` / ``explainer_host``), its HTTP client, and the
versioned V2 routes, against the JAX package's on the CPU.

A port ``Model`` whose ``predictor_host`` names an in-process port
server (an mlp ``TorchModel``) sends dense instance batches over the V2
binary wire; a V1-only predictor (404 on the V2 route) gets the JSON
fallback, and any other error propagates.  The V2 -> V1 translation and
the dense-batch test equal the JAX package's.
"""

import asyncio
import json

import numpy as np
import pytest
from torch_serving import MLP_CONFIG, arequest, serve, write_artifact

from kfserving_tpu.model import model as jax_model_mod
from kfserving_tpu.predictors.jax_model import JaxModel
from kfserving_tpu_torch.model import model as port_model_mod
from kfserving_tpu_torch.model.model import Model
from kfserving_tpu_torch.predictors.torch_model import TorchModel
from kfserving_tpu_torch.protocol.errors import InferenceError
from kfserving_tpu_torch.server.client import HTTPClient
from kfserving_tpu_torch.server.http import (
    HTTPServer,
    Response,
    Router,
    StreamingResponse,
)

# The input width of MLP_CONFIG's mlp (the registry's default).
MLP_ROW = 64


def _rows(n, seed=0):
    return np.random.default_rng(seed).normal(
        0, 1, (n, MLP_ROW)).astype(np.float32)


async def _stub_server(routes):
    """A port HTTPServer with only ``routes`` [(method, path, handler)]."""
    router = Router()
    for method, path, handler in routes:
        router.add(method, path, handler)
    server = HTTPServer(router)
    await server.start("127.0.0.1", 0)
    return server


def _request_counts(metrics: bytes):
    out = {}
    for line in metrics.decode().splitlines():
        if line.startswith("kfserving_tpu_request_total{"):
            key, value = line.rsplit(" ", 1)
            out[key[len("kfserving_tpu_request_total"):]] = float(value)
    return out


def test_binary_hop_to_a_port_predictor(tmp_path):
    """Dense ndarray instances ride the V2 binary wire (counted as verb
    "infer" by the predictor), come back in the V1 shape, and equal the
    predictor's own V1 answers; a list payload takes the V1 route."""
    model_dir = write_artifact(str(tmp_path), "m", MLP_CONFIG)
    predictor = TorchModel("m", model_dir, device="cpu")
    predictor.load()
    rows = _rows(3)

    async def drive(server):
        proxy = Model("m")
        proxy.predictor_host = f"127.0.0.1:{server.http_port}"
        try:
            binary = await proxy.predict({"instances": rows})
            stacked = await proxy.predict({"instances": list(rows)})
            as_json = await proxy.predict({"instances": rows.tolist()})
            direct = await predictor.predict({"instances": rows.tolist()})
            opened = proxy.http_client.connections_opened
            metrics = (await arequest(server.http_port, "GET",
                                      "/metrics"))[2]
        finally:
            await proxy.close()
        return (binary, stacked, as_json, direct, opened,
                proxy._binary_hop, metrics)

    binary, stacked, as_json, direct, opened, still_binary, metrics = \
        asyncio.run(serve("torch", [predictor], drive))
    assert binary == stacked == as_json == direct
    assert still_binary and opened == 1      # one keep-alive connection
    assert _request_counts(metrics) == {
        '{model="m",status="200",verb="infer"}': 2,
        '{model="m",status="200",verb="predict"}': 1}


@pytest.mark.parametrize("status,fallback", [(404, True), (405, True),
                                             (501, True), (500, False),
                                             (400, False)])
def test_binary_hop_fallback_only_on_missing_route(status, fallback):
    """404/405/501 on the V2 route: the JSON route from then on.  Any
    other status is the predictor's answer and propagates."""
    seen = []

    async def infer(req):
        seen.append(("infer", req.headers.get(
            "inference-header-content-length")))
        return Response(b'{"error": "no"}', status=status)

    async def predict(req):
        body = json.loads(req.body)
        seen.append(("predict", len(body["instances"])))
        return Response(json.dumps(
            {"predictions": [sum(r) for r in body["instances"]]}).encode())

    async def run():
        server = await _stub_server([
            ("POST", "/v2/models/{name}/infer", infer),
            ("POST", "/v1/models/{name}:predict", predict)])
        proxy = Model("m")
        proxy.predictor_host = f"127.0.0.1:{server.port}"
        try:
            out = []
            for _ in range(2):
                try:
                    out.append(await proxy.predict(
                        {"instances": np.ones((2, 3))}))
                except InferenceError as e:
                    out.append(("error", e.reason))
            return out, proxy._binary_hop
        finally:
            await proxy.close()
            await server.stop()

    out, binary_hop = asyncio.run(run())
    if fallback:
        assert out == [{"predictions": [3.0, 3.0]}] * 2
        assert not binary_hop
        assert [s[0] for s in seen] == ["infer", "predict", "predict"]
    else:
        assert out == [("error", '{"error": "no"}')] * 2
        assert binary_hop and [s[0] for s in seen] == ["infer", "infer"]


V2_BODIES = [
    {"outputs": []},
    {"outputs": [{"name": "output_0", "shape": [2, 3], "datatype": "FP32",
                  "data": [1, 2, 3, 4, 5, 6]}]},
    {"outputs": [{"name": "values", "shape": [2, 2], "datatype": "FP32",
                  "data": [0.5, 0.25, 0.75, 0.125]},
                 {"name": "indices", "shape": [2, 2], "datatype": "INT32",
                  "data": [3, 1, 0, 2]}]},
]


@pytest.mark.parametrize("body", V2_BODIES)
def test_v2_response_to_v1_matches_jax(body):
    assert port_model_mod._v2_response_to_v1(body) == \
        jax_model_mod._v2_response_to_v1(body)


@pytest.mark.parametrize("request_", [
    {"instances": np.ones((2, 3), np.float32)},
    {"instances": [np.ones(3), np.zeros(3)]},
    {"instances": [np.ones(3), np.zeros(4)]},
    {"instances": [[1.0, 2.0]]},
    {"instances": np.array(["a", "b"])},
    {"instances": np.ones(2), "parameters": {}},
])
def test_dense_instances_matches_jax(request_):
    got = port_model_mod._dense_instances(request_)
    want = jax_model_mod._dense_instances(request_)
    assert (got is None) == (want is None)
    if got is not None:
        np.testing.assert_array_equal(got, want)


def test_explain_proxies_to_the_explainer_host():
    """explain posts the request to explainer_host's V1 or V2 explain
    route; without a host both packages raise NotImplementedError."""
    seen = []

    async def explain(req):
        seen.append(req.path)
        return Response(json.dumps({"explained": json.loads(req.body)}
                                   ).encode())

    async def run():
        server = await _stub_server([
            ("POST", "/v1/models/{name}:explain", explain),
            ("POST", "/v2/models/{name}/explain", explain)])
        out = []
        for protocol in ("v1", "v2"):
            proxy = Model("m")
            proxy.protocol = protocol
            proxy.explainer_host = f"127.0.0.1:{server.port}"
            out.append(await proxy.explain(
                {"instances": np.arange(3.0)}))
            await proxy.close()
        await server.stop()
        for cls in (Model, jax_model_mod.Model):
            with pytest.raises(NotImplementedError):
                await cls("m").explain({"instances": [1]})
        return out

    out = asyncio.run(run())
    assert out == [{"explained": {"instances": [0.0, 1.0, 2.0]}}] * 2
    assert seen == ["/v1/models/m:explain", "/v2/models/m/explain"]


def test_client_keep_alive_chunks_and_timeout():
    """One connection serves several requests; a chunked body is
    reassembled; a slow answer past the timeout raises TimeoutError (an
    OSError, so retry policies replay it)."""

    async def fast(req):
        return Response(b"x" * int(req.query.get("n", "1")))

    async def chunked(req):
        async def parts():
            for i in range(3):
                yield f"part{i};".encode()
        return StreamingResponse(parts())

    async def slow(req):
        await asyncio.sleep(1.0)
        return Response(b"late")

    async def run():
        server = await _stub_server([("GET", "/fast", fast),
                                     ("GET", "/chunked", chunked),
                                     ("GET", "/slow", slow)])
        base = f"http://127.0.0.1:{server.port}"
        client = HTTPClient(timeout=0.2)
        try:
            sizes = [len((await client.request(
                "GET", f"{base}/fast?n={n}"))[2]) for n in (1, 1000, 70000)]
            status, headers, body = await client.request(
                "GET", f"{base}/chunked")
            opened = client.connections_opened
            with pytest.raises(TimeoutError):
                await client.request("GET", f"{base}/slow")
            with pytest.raises(ValueError):
                await client.request("GET", "https://example.com/x")
        finally:
            await client.close()
            await server.stop()
        return sizes, status, headers, body, opened

    sizes, status, headers, body, opened = asyncio.run(run())
    assert sizes == [1, 1000, 70000]
    assert status == 200 and headers["transfer-encoding"] == "chunked"
    assert body == b"part0;part1;part2;" and opened == 1


@pytest.mark.parametrize("method,path,body", [
    ("GET", "/v2/models/m/versions/1/ready", None),
    ("GET", "/v2/models/m/versions/7", None),
    ("POST", "/v2/models/m/versions/1/infer",
     {"inputs": [{"name": "x", "shape": [1, MLP_ROW], "datatype": "FP32",
                  "data": [0.5] * MLP_ROW}]}),
    ("GET", "/v2/models/nope/versions/1/ready", None),
])
def test_versioned_v2_routes_answer_as_jax(tmp_path, method, path, body):
    """The versioned forms serve the registered model under any version,
    with the JAX server's statuses and response keys."""
    model_dir = write_artifact(str(tmp_path), "m", MLP_CONFIG)
    answers = {}
    for kind, cls in (("jax", JaxModel), ("torch", TorchModel)):
        model = cls("m", model_dir) if kind == "jax" else \
            cls("m", model_dir, device="cpu")
        model.load()

        async def drive(server):
            return await arequest(server.http_port, method, path, body)

        status, _, raw = asyncio.run(serve(kind, [model], drive))
        answers[kind] = (status, sorted(json.loads(raw)) if raw else None)
        if kind == "torch" and path.endswith("/infer"):
            out = json.loads(raw)["outputs"][0]
            assert out["shape"] == [1, 10] and len(out["data"]) == 10
    assert answers["jax"] == answers["torch"]
