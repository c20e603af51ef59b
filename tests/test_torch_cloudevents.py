"""CloudEvents requests through the port's server against the JAX
package's, on the CPU: binary and structured events must give the same
status, response body and framing headers (``ce-*`` attributes, content
type) on the same requests."""

import asyncio
import json

import pytest
from torch_serving import arequest, serve

import kfserving_tpu
from kfserving_tpu_torch.model.model import Model


def _echo(request):
    if isinstance(request, (bytes, bytearray)):
        return {"raw_bytes": len(request)}
    return {"echo": request}


class _EchoPort(Model):
    async def predict(self, request):
        return _echo(request)


class _EchoJax(kfserving_tpu.Model):
    async def predict(self, request):
        return _echo(request)


BINARY = {"ce-specversion": "1.0", "ce-source": "test", "ce-type": "t",
          "ce-id": "id-1", "ce-custom": "x"}
ENVELOPE = {"specversion": "1.0", "source": "test", "type": "t",
            "id": "id-2", "datacontenttype": "application/json",
            "data": {"instances": [[1, 2]]}}
CASES = {
    "binary_json": (dict(BINARY, **{"content-type": "application/json"}),
                    json.dumps({"instances": [[1, 2]]}).encode()),
    "binary_charset": (dict(BINARY, **{
        "content-type": "application/json; charset=utf-8"}),
        b'{"instances": [[3]]}'),
    "binary_raw": (dict(BINARY, **{
        "content-type": "application/octet-stream"}), b"\x00\x01\x02"),
    "binary_bad_json": (dict(BINARY, **{"content-type": "application/json"}),
                        b"{not json"),
    "binary_without_id_is_plain_json": (
        {k: v for k, v in BINARY.items() if k != "ce-id"},
        b'{"instances": [[1]]}'),
    "structured": ({"content-type": "application/cloudevents+json"},
                   json.dumps(ENVELOPE).encode()),
    "structured_missing_source": (
        {"content-type": "application/cloudevents+json"},
        json.dumps({k: v for k, v in ENVELOPE.items()
                    if k != "source"}).encode()),
}


async def _drive(server):
    out = {}
    for name, (headers, body) in CASES.items():
        out[name] = await arequest(server.http_port, "POST",
                                   "/v1/models/echo:predict", body,
                                   headers=headers)
    return out


@pytest.fixture(scope="module")
def responses():
    from kfserving_tpu.observability import REGISTRY as JAX_REGISTRY

    out = {}
    for kind, cls in (("jax", _EchoJax), ("torch", _EchoPort)):
        model = cls("echo")
        model.load()
        out[kind] = asyncio.run(serve(kind, [model], _drive))
    # The JAX server's background sampler may have ticked into its
    # process registry; tests/conftest.py fails a test that starts with
    # samples there.
    JAX_REGISTRY.reset()
    return out


def _framing(headers):
    return {k: v for k, v in headers.items()
            if (k.startswith("ce-") and k != "ce-time")
            or k == "content-type"}


def _payload(headers, body):
    data = json.loads(body)
    if headers.get("content-type", "").startswith(
            "application/cloudevents+json"):
        assert data.pop("time")
    return data


@pytest.mark.parametrize("name", sorted(CASES))
def test_same_response_as_the_jax_server(responses, name):
    jax_status, jax_headers, jax_body = responses["jax"][name]
    status, headers, body = responses["torch"][name]
    assert status == jax_status
    assert _framing(headers) == _framing(jax_headers)
    assert _payload(headers, body) == _payload(jax_headers, jax_body)
    if status == 200 and "ce-id" in CASES[name][0]:
        assert headers["ce-id"] == "id-1" and "ce-time" in headers


def test_statuses(responses):
    got = {name: r[0] for name, r in responses["torch"].items()}
    assert got == {"binary_json": 200, "binary_charset": 200,
                   "binary_raw": 200, "binary_bad_json": 400,
                   "binary_without_id_is_plain_json": 200,
                   "structured": 200,
                   "structured_missing_source": 400}
