"""The port's control API, manager, client and CLI against the JAX
package's (``kfserving_tpu_torch.{control.api, control.manager, client}``
vs ``kfserving_tpu.{control.api, control.manager, client}``).

Exact for the control logic: ``merge_patch``; the API's statuses and
error messages on the same bad requests; the client's connect retries
(a refused connect and an injected ``client.request`` fault are
retried, a request that reached the server never is).  One lifecycle
goes through each package's ``ServingManager`` by its client alone
(create, wait, predict on both wires, canary, rollouts, promote,
TrainedModels on a multi-model parent, secrets, delete) and through its
CLI: the bodies are equal with replica addresses masked, and the
answers of the MLP agree within 0.02 (one bf16 hidden layer on both
sides, as tests/test_torch_repository.py's BF16_ATOL).  The CLI and the
manager also run as ``python -m`` subprocesses (marked slow, with the
in-process CLI runs as their tier-1 twin).
"""

import asyncio
import contextlib
import io
import json
import os
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
from flax import serialization
from torch_parity import randomized

from kfserving_tpu.client import cli as jax_cli
from kfserving_tpu.client import client as jax_client
from kfserving_tpu.control import api as jax_api
from kfserving_tpu.control import clusterconfig as jax_clusterconfig
from kfserving_tpu.control import controller as jax_controller
from kfserving_tpu.control import manager as jax_manager
from kfserving_tpu.control import orchestrator as jax_orchestrator
from kfserving_tpu.models import create_model as jax_create_model
from kfserving_tpu.reliability import faults as jax_faults
from kfserving_tpu.storage import credentials as jax_credentials
from kfserving_tpu_torch.client import cli, client
from kfserving_tpu_torch.control import api, clusterconfig, controller
from kfserving_tpu_torch.control import manager, orchestrator
from kfserving_tpu_torch.observability import REGISTRY
from kfserving_tpu_torch.reliability import faults
from kfserving_tpu_torch.server.http import HTTPServer, Response, Router
from kfserving_tpu_torch.storage import credentials

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {
    "jax": dict(api=jax_api, client=jax_client, cli=jax_cli,
                clusterconfig=jax_clusterconfig, controller=jax_controller,
                manager=jax_manager, orchestrator=jax_orchestrator,
                faults=jax_faults, credentials=jax_credentials),
    "torch": dict(api=api, client=client, cli=cli,
                  clusterconfig=clusterconfig, controller=controller,
                  manager=manager, orchestrator=orchestrator,
                  faults=faults, credentials=credentials),
}
MLP_KWARGS = {"input_dim": 4, "features": [16], "num_classes": 3}
BF16_ATOL = 0.02


@pytest.fixture(autouse=True)
def _state():
    REGISTRY.reset()
    faults.reset()
    jax_faults.reset()
    yield
    faults.reset()
    jax_faults.reset()
    REGISTRY.reset()


def _mlp_artifact(path, seed=0):
    spec_ = jax_create_model("mlp", **MLP_KWARGS)
    shapes = jax.eval_shape(lambda: spec_.module.init(
        jax.random.PRNGKey(0), spec_.example))
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"architecture": "mlp", "arch_kwargs": MLP_KWARGS,
                   "max_latency_ms": 2, "warmup": False}, f)
    with open(os.path.join(path, "checkpoint.msgpack"), "wb") as f:
        f.write(serialization.to_bytes(randomized(shapes, seed)))
    return str(path)


def _read_json(path):
    with open(path) as f:
        return json.load(f)


def _mask(value):
    """Replica addresses and time stamps differ by run: mask them."""
    if isinstance(value, dict):
        return {k: ("*" if k in ("host", "hosts", "ts", "started_ts",
                                 "updated_ts") else _mask(v))
                for k, v in value.items()}
    if isinstance(value, list):
        return [_mask(v) for v in value]
    if isinstance(value, str) and "127.0.0.1:" in value:
        return "127.0.0.1:*"
    return value


# ------------------------------------------------------------ merge patch --
@pytest.mark.parametrize("base,patch", [
    ({"a": 1, "b": {"c": 2, "d": 3}, "e": 4},
     {"b": {"c": 9, "d": None}, "e": None, "f": 5}),
    ({"a": {"b": {"c": 1}}}, {"a": {"b": None}}),
    ({"a": [1, 2]}, {"a": {"x": 1}}),
    ({"a": {"x": 1}}, {"a": [3]}),
    ({}, {"n": None, "m": {"k": None}}),
    ({"predictor": {"framework": "jax", "canary_traffic_percent": 10}},
     {"predictor": {"canary_traffic_percent": None, "min_replicas": 2}}),
])
def test_merge_patch_matches_jax(base, patch):
    assert api.merge_patch(base, patch) == jax_api.merge_patch(base, patch)


# ---------------------------------------------------------- API errors --
BAD_REQUESTS = [
    ("POST", "/v1/inferenceservices", b"{not json"),
    ("POST", "/v1/inferenceservices", b"[1, 2]"),
    ("POST", "/v1/inferenceservices", b"{}"),
    ("POST", "/v1/inferenceservices",
     json.dumps({"name": "Bad_Name", "predictor": {
         "framework": "jax", "storage_uri": "file:///m"}}).encode()),
    ("POST", "/v1/inferenceservices",
     json.dumps({"name": "ok", "predictor": {
         "framework": "caffe", "storage_uri": "file:///m"}}).encode()),
    ("POST", "/v1/inferenceservices",
     json.dumps({"name": "ok", "predictor": {
         "framework": "jax", "storage_uri": "file:///m",
         "min_replicas": 3, "max_replicas": 1}}).encode()),
    ("POST", "/v1/inferenceservices",
     json.dumps({"name": "ok", "predictor": {
         "framework": "jax", "storage_uri": "file:///m",
         "bogus_field": 1}}).encode()),
    ("GET", "/v1/inferenceservices/default/missing", b""),
    ("PATCH", "/v1/inferenceservices/default/missing", b"{}"),
    ("DELETE", "/v1/inferenceservices/default/missing", b""),
    ("PATCH", "/v1/inferenceservices/default/svc", b"{bad"),
    ("PATCH", "/v1/inferenceservices/default/svc",
     json.dumps({"predictor": {"min_replicas": -1}}).encode()),
    ("POST", "/v1/trainedmodels",
     json.dumps({"name": "tm", "inference_service": "none",
                 "storage_uri": "file:///a",
                 "memory_bytes": 1}).encode()),
    ("POST", "/v1/trainedmodels",
     json.dumps({"name": "tm", "inference_service": "svc",
                 "storage_uri": "file:///a",
                 "memory_bytes": 1}).encode()),
    ("POST", "/v1/trainedmodels", json.dumps({"nope": 1}).encode()),
    ("GET", "/v1/trainedmodels/default/none", b""),
    ("DELETE", "/v1/trainedmodels/default/none", b""),
    ("POST", "/v1/secrets", json.dumps({"type": "ftp",
                                        "data": {"a": 1}}).encode()),
    ("POST", "/v1/secrets", json.dumps({"type": "s3",
                                        "data": {}}).encode()),
    ("POST", "/v1/secrets", json.dumps({"data": {"a": 1}}).encode()),
    ("DELETE", "/v1/secrets/none", b""),
    ("POST", "/v1/serviceaccounts/sa/secrets", b"{}"),
    ("POST", "/v1/serviceaccounts/sa/secrets",
     json.dumps({"secret": "none"}).encode()),
    ("GET", "/v1/nothing", b""),
]


async def _api_answers(pkg, with_store):
    p = PACKAGES[pkg]
    c = p["controller"].Controller(p["orchestrator"].FakeOrchestrator())
    store = p["credentials"].CredentialStore() if with_store else None
    a = p["api"].ControlAPI(c, credentials=store)
    await a.start_async()
    http = client.HTTPClient(timeout=10, keepalive=False)
    try:
        ok = await http.request("POST", f"http://127.0.0.1:{a.http_port}"
                                "/v1/inferenceservices", json.dumps({
                                    "name": "svc", "predictor": {
                                        "framework": "jax",
                                        "storage_uri": "file:///m"}}
                                ).encode())
        out = [(ok[0], json.loads(ok[2]))]
        for method, path, body in BAD_REQUESTS:
            status, _, data = await http.request(
                method, f"http://127.0.0.1:{a.http_port}{path}", body=body)
            out.append((method, path, status, json.loads(data)))
        return out
    finally:
        await a.stop_async()


@pytest.mark.parametrize("with_store", [True, False])
async def test_api_errors_match_jax(with_store):
    out = {pkg: await _api_answers(pkg, with_store) for pkg in PACKAGES}
    assert out["torch"] == out["jax"]
    assert out["torch"][0][0] == 201
    assert sum(s in (404, 422) for _, _, s, _ in out["torch"][1:]) >= 20


# ------------------------------------------------------- connect retries --
async def _retry_trace(pkg, tmp_path):
    p = PACKAGES[pkg]
    retry_cls = type(p["client"].KFServingClient("http://x").retry)
    policy = retry_cls.from_env("KFS_CLIENT", base_delay_s=0.001,
                                jitter=0.0,
                                retry_on=_retry_on(pkg))
    trace = []
    # A refused connect: replayed up to the policy's 3 attempts.
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        closed_port = sock.getsockname()[1]
    c = p["client"].KFServingClient(f"http://127.0.0.1:{closed_port}",
                                    retry=policy)
    try:
        await c.get()
    except Exception as e:
        trace.append(("refused", policy.retries, type(e).__name__ in (
            "ConnectError", "ClientConnectorError")))
    finally:
        await c.close()
    # A server that reads the request and drops the connection: the
    # request was sent, so it is never replayed.
    seen = []

    async def drop(reader, writer):
        seen.append(await reader.readuntil(b"\r\n\r\n"))
        writer.close()

    server = await asyncio.start_server(drop, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    policy.retries = 0
    c = p["client"].KFServingClient(f"http://127.0.0.1:{port}",
                                    retry=policy)
    try:
        await c.create({"name": "x"})
    except Exception:
        trace.append(("dropped", policy.retries, len(seen)))
    finally:
        await c.close()
        server.close()
        await server.wait_closed()
    # An injected client.request fault (a refused connect): replayed.
    router = Router()

    async def listing(req):
        return Response(b'{"items": []}')

    router.add("GET", "/v1/inferenceservices", listing)
    ok = HTTPServer(router)
    await ok.start("127.0.0.1", 0)
    p["faults"].configure({"client.request": {"fail_first": 2}})
    policy.retries = 0
    c = p["client"].KFServingClient(f"http://127.0.0.1:{ok.port}",
                                    retry=policy)
    try:
        trace.append(("fault", await c.get(), policy.retries,
                      p["faults"].stats()))
    finally:
        await c.close()
        await ok.stop()
        p["faults"].reset()
    return trace


def _retry_on(pkg):
    if pkg == "jax":
        import aiohttp

        from kfserving_tpu.reliability import FaultInjected

        return (aiohttp.ClientConnectorError, ConnectionRefusedError,
                FaultInjected)
    from kfserving_tpu_torch.reliability import FaultInjected
    from kfserving_tpu_torch.server.client import ConnectError

    return (ConnectError, ConnectionRefusedError, FaultInjected)


@pytest.mark.chaos
async def test_client_retries_connects_only_as_jax(tmp_path):
    out = {pkg: await _retry_trace(pkg, tmp_path) for pkg in PACKAGES}
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == ("refused", 2, True)
    assert out["torch"][1] == ("dropped", 0, 1)
    assert out["torch"][2] == ("fault", {"items": []}, 2, {
        "client.request": {"calls": 3, "injected": 2}})


def test_client_retry_policy_classes():
    c = client.KFServingClient("http://127.0.0.1:1")
    assert c.retry.retry_on == _retry_on("torch")


# ----------------------------------------------- lifecycle through client --
async def _lifecycle(pkg, tmp_path):
    # The artifacts are shared: their URIs enter the revision hashes.
    p = PACKAGES[pkg]
    root = tmp_path / pkg
    model_dir = str(tmp_path / "mlp")
    mm_dir = str(tmp_path / "mm" / "tm-a")
    cfg = p["clusterconfig"].ClusterConfig()
    cfg.credentials.store_file = str(root / "creds.json")
    cfg.modelconfig_dir = str(root / "modelconfig")
    root.mkdir()
    s3 = root / "aws"
    s3.write_text("[default]\naws_access_key_id = AK\n"
                  "aws_secret_access_key = SK\n")
    kwargs = dict(cluster_config=cfg, orchestrator="inprocess",
                  control_port=0, ingress_port=0, host="127.0.0.1")
    if pkg == "torch":
        kwargs["device"] = "cpu"
    m = p["manager"].ServingManager(**kwargs)
    await m.start_async()
    x = np.random.default_rng(0).standard_normal((2, 4)).astype(np.float32)
    trail, answers = [], []
    try:
        async with p["client"].KFServingClient(
                f"http://127.0.0.1:{m.api.http_port}",
                f"http://127.0.0.1:{m.router.http_port}") as c:
            async def step(name, coro):
                try:
                    trail.append((name, _mask(await coro)))
                except p["client"].ClientError as e:
                    trail.append((name, "error", e.status, e.message))

            await step("create", c.create(p["client"].isvc_spec(
                "mlp", "jax", f"file://{model_dir}")))
            await c.wait_isvc_ready("mlp")
            answers.append(await c.predict("mlp", {"instances": x.tolist()}))
            answers.append(await c.predict(
                "mlp", {"inputs": [{"name": "input_0", "shape": [2, 4],
                                    "datatype": "FP32",
                                    "data": x.ravel().tolist()}]},
                protocol="v2"))
            binary = await c.predict_binary("mlp", {"input_0": x})
            answers.append(binary["outputs"][0]["data"])
            await step("canary", c.rollout_canary(
                "mlp", 30, runtime_version="v2"))
            for _ in range(3):
                answers.append(await c.predict(
                    "mlp", {"instances": x[:1].tolist()}))
            await step("rollouts", c.rollouts())
            await step("promote", c.promote("mlp"))
            await step("list", c.get())
            await step("mm", c.create(p["client"].isvc_spec(
                "mm", "jax", f"file://{tmp_path / 'mm'}", multi_model=True)))
            await step("tm", c.create_trained_model({
                "name": "tm-a", "inference_service": "mm",
                "storage_uri": f"file://{mm_dir}", "memory_bytes": 4096}))
            await step("tm-get", c.get_trained_model("tm-a"))
            await step("tm-list", c.get_trained_model())
            trail.append(("shard", await asyncio.to_thread(
                _read_json, os.path.join(cfg.modelconfig_dir,
                                         "default-mm-shard-0.json"))))
            await step("tm-delete", c.delete_trained_model("tm-a"))
            await step("tm-missing", c.get_trained_model("tm-a"))
            await step("s3", c.set_s3_credentials(
                str(s3), service_account="sa", s3_endpoint="minio:9000"))
            await step("secrets", c.list_secrets())
            await step("delete", c.delete("mlp"))
            await step("missing", c.get("mlp"))
            try:
                await p["client"].KFServingClient(
                    "http://127.0.0.1:1").predict("x", {})
            except ValueError as e:
                trail.append(("no-ingress", str(e)))
        stored = await asyncio.to_thread(_read_json,
                                         cfg.credentials.store_file)
        trail.append(("store", sorted(stored), sorted(
            stored.get("serviceAccounts", {}))))
    finally:
        await m.stop_async()
    return trail, answers


async def test_lifecycle_through_the_client_matches_jax(tmp_path):
    _mlp_artifact(tmp_path / "mlp")
    _mlp_artifact(tmp_path / "mm" / "tm-a", seed=1)
    out = {pkg: await _lifecycle(pkg, tmp_path) for pkg in PACKAGES}
    want, got = out["jax"][0], out["torch"][0]
    for i, (a, b) in enumerate(zip(want, got)):
        assert b == a, i
    assert len(got) == len(want)
    (_, jax_answers), (_, torch_answers) = out["jax"], out["torch"]
    for a, b in zip(jax_answers, torch_answers):
        if isinstance(a, dict) and "outputs" in a:
            a, b = a["outputs"][0]["data"], b["outputs"][0]["data"]
        elif isinstance(a, dict):
            a, b = a["predictions"], b["predictions"]
        np.testing.assert_allclose(np.asarray(b, np.float64),
                                   np.asarray(a, np.float64),
                                   atol=BF16_ATOL, rtol=0)
    names = [t[0] for t in got]
    assert ("missing", "error", 404) == got[names.index("missing")][:3]
    assert ("tm-missing", "error", 404) == got[names.index("tm-missing")][:3]


# -------------------------------------------------------------------- CLI --
async def _cli_trail(pkg, tmp_path):
    p = PACKAGES[pkg]
    root = tmp_path / pkg
    root.mkdir()
    model_dir = str(tmp_path / "mlp")
    spec_file = root / "isvc.json"
    spec_file.write_text(json.dumps(p["client"].isvc_spec(
        "cli-mlp", "jax", f"file://{model_dir}")))
    payload = root / "payload.json"
    payload.write_text(json.dumps({"instances": [[1.0, 2.0, 3.0, 4.0]]}))
    kwargs = dict(orchestrator="inprocess", control_port=0,
                  ingress_port=0, host="127.0.0.1")
    if pkg == "torch":
        kwargs["device"] = "cpu"
    m = p["manager"].ServingManager(**kwargs)
    await m.start_async()
    control = f"http://127.0.0.1:{m.api.http_port}"
    ingress = f"http://127.0.0.1:{m.router.http_port}"

    def run(*argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = p["cli"].main(["--control-url", control,
                                "--ingress-url", ingress, *argv])
        text = out.getvalue()
        try:
            return rc, _mask(json.loads(text))
        except ValueError:
            return rc, text

    loop = asyncio.get_running_loop()
    trail = []
    try:
        for argv in (["apply", "-f", str(spec_file)], ["wait", "cli-mlp"],
                     ["get"], ["get", "cli-mlp"], ["rollouts"],
                     ["predict", "cli-mlp", "-f", str(payload)],
                     ["trainedmodel", "get"], ["credentials", "list"],
                     ["delete", "cli-mlp"]):
            rc, body = await loop.run_in_executor(None, run, *argv)
            if argv[0] == "predict":
                body = np.asarray(body["predictions"], np.float64)
            trail.append((argv[0], rc, body))
    finally:
        await m.stop_async()
    return trail


async def test_cli_matches_jax(tmp_path):
    _mlp_artifact(tmp_path / "mlp")
    out = {pkg: await _cli_trail(pkg, tmp_path) for pkg in PACKAGES}
    for (a_name, a_rc, a), (b_name, b_rc, b) in zip(out["jax"],
                                                    out["torch"]):
        assert (b_name, b_rc) == (a_name, a_rc)
        if a_name == "predict":
            np.testing.assert_allclose(b, a, atol=BF16_ATOL, rtol=0)
        else:
            assert b == a, a_name
    assert [rc for _, rc, _ in out["torch"]] == [0] * 9


def test_help_of_both_entry_points():
    for main in (cli.main, __import__(
            "kfserving_tpu_torch.control.__main__",
            fromlist=["main"]).main):
        with pytest.raises(SystemExit) as exc:
            with contextlib.redirect_stdout(io.StringIO()):
                main(["--help"])
        assert exc.value.code == 0


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.mark.slow
def test_control_and_client_run_as_modules(tmp_path):
    """``python -m kfserving_tpu_torch.control serve --device cpu`` boots a
    fabric that applies a spec at start, and ``python -m
    kfserving_tpu_torch.client get`` lists it."""
    model_dir = _mlp_artifact(tmp_path / "mlp")
    spec_file = tmp_path / "isvc.json"
    spec_file.write_text(json.dumps(client.isvc_spec(
        "sub-mlp", "jax", f"file://{model_dir}")))
    control, ingress = _free_port(), _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "kfserving_tpu_torch.control", "serve",
         "--control-port", str(control), "--ingress-port", str(ingress),
         "--device", "cpu", "--apply", str(spec_file)],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    try:
        body = None
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            res = subprocess.run(
                [sys.executable, "-m", "kfserving_tpu_torch.client",
                 "--control-url", f"http://127.0.0.1:{control}", "get"],
                cwd=REPO, env=env, capture_output=True, text=True,
                timeout=60)
            if res.returncode == 0:
                body = json.loads(res.stdout)
                if body["items"] and body["items"][0]["ready"]:
                    break
            time.sleep(0.5)
        assert body == {"items": [{"name": "sub-mlp",
                                   "namespace": "default", "ready": True}]}
    finally:
        proc.terminate()
        proc.wait(timeout=30)
