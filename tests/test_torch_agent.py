"""The port's agent against the JAX package's (``kfserving_tpu_torch.agent``
vs ``kfserving_tpu.agent``).

The same model configs, artifacts, events and requests go through both
packages and must come out equal (exact: the agent is control logic):
models.json parsing and diffing, the watcher's load/unload events, the
downloader's digests, trees, markers and idempotence, the ``agent.pull``
fault retried by the puller (with ``FaultInjector.stats``), the payload
logger's CloudEvents (queued events, drops, what a sink receives), and a
multi-model replica built from the jaxserver flags (``--config_dir``,
``--log_url``) whose watcher, puller and downloader load the same MLP
artifacts: the answers agree within 0.02 (the served MLP's hidden layer
is bf16 in both packages: ``BF16_ATOL`` of tests/test_torch_repository.py),
and the sink gets one request and one response event per predict with
the bodies byte-equal.
"""

import asyncio
import json
import os

import jax
import numpy as np
import pytest
from flax import serialization
from torch_parity import randomized
from torch_serving import arequest

from kfserving_tpu import agent as jax_agent
from kfserving_tpu.agent import downloader as jax_downloader
from kfserving_tpu.agent import logger as jax_logger
from kfserving_tpu.agent import watcher as jax_watcher
from kfserving_tpu.models import create_model as jax_create_model
from kfserving_tpu.predictors.jaxserver import __main__ as jax_jaxserver
from kfserving_tpu.reliability import RetryPolicy as JaxRetryPolicy
from kfserving_tpu.reliability import faults as jax_faults
from kfserving_tpu_torch import agent
from kfserving_tpu_torch.agent import downloader, logger, watcher
from kfserving_tpu_torch.observability import REGISTRY
from kfserving_tpu_torch.predictors.jaxserver import __main__ as jaxserver
from kfserving_tpu_torch.reliability import RetryPolicy, faults
from kfserving_tpu_torch.server.http import HTTPServer, Response, Router

PACKAGES = {
    "jax": dict(agent=jax_agent, downloader=jax_downloader,
                watcher=jax_watcher, logger=jax_logger,
                faults=jax_faults, retry=JaxRetryPolicy,
                jaxserver=jax_jaxserver),
    "torch": dict(agent=agent, downloader=downloader, watcher=watcher,
                  logger=logger, faults=faults, retry=RetryPolicy,
                  jaxserver=jaxserver),
}
MLP_KWARGS = {"input_dim": 4, "features": [16], "num_classes": 3}
# One bf16 dense layer (the served MLP's default) on both sides, as
# tests/test_torch_repository.py's BF16_ATOL.
BF16_ATOL = 0.02


@pytest.fixture(autouse=True)
def _port_state():
    REGISTRY.reset()
    faults.reset()
    jax_faults.reset()
    yield
    faults.reset()
    jax_faults.reset()
    REGISTRY.reset()


def _outcome(fn):
    """The value of fn(), or ("raised", type name, message)."""
    try:
        return fn()
    except Exception as e:  # compared across the packages
        return ("raised", type(e).__name__, str(e))


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for base, _, files in os.walk(root):
        for name in files:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _mlp_artifact(root, name, seed):
    spec_ = jax_create_model("mlp", **MLP_KWARGS)
    shapes = jax.eval_shape(lambda: spec_.module.init(
        jax.random.PRNGKey(0), spec_.example))
    path = os.path.join(str(root), name)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"architecture": "mlp", "arch_kwargs": MLP_KWARGS,
                   "max_latency_ms": 2, "warmup": False}, f)
    with open(os.path.join(path, "checkpoint.msgpack"), "wb") as f:
        f.write(serialization.to_bytes(randomized(shapes, seed)))
    return path


class _Sink:
    """A CloudEvents sink on the port's HTTP server, answering `status`."""

    def __init__(self, status=200):
        self.status = status
        self.received = []
        router = Router()
        router.add("POST", "/", self._handle)
        self.server = HTTPServer(router)

    async def _handle(self, req):
        self.received.append((dict(req.headers), req.body))
        return Response(b"ok", status=self.status)

    async def start(self):
        await self.server.start("127.0.0.1", 0)
        self.url = f"http://127.0.0.1:{self.server.port}/"

    async def stop(self):
        await self.server.stop()


# ---------------------------------------------------------------- watcher --
MODEL_CONFIGS = [
    b"",
    b"[]",
    b"{not json",
    b'{"modelName": "a"}',
    b"42",
    json.dumps([
        {"modelName": "a", "modelSpec": {"storageUri": "file:///x"}},
        {"modelName": "bad"},
        {"modelSpec": {"storageUri": "file:///y"}},
        "scalar", 7,
        {"modelName": "c", "modelSpec": {"framework": "jax"}},
        {"modelName": "d", "modelSpec": {"storageUri": "gs://b/d",
                                         "memory": "1Gi"}},
    ]).encode(),
]


@pytest.mark.parametrize("raw", MODEL_CONFIGS)
def test_parse_model_config_matches_jax(raw):
    out = {pkg: _outcome(lambda: p["watcher"].parse_model_config(raw))
           for pkg, p in PACKAGES.items()}
    assert out["torch"] == out["jax"]


def test_diff_configs_matches_jax():
    old = {"a": {"storageUri": "u1"}, "b": {"storageUri": "u2"},
           "c": {"storageUri": "u3"}}
    new = {"a": {"storageUri": "u1"}, "b": {"storageUri": "u2b"},
           "d": {"storageUri": "u4"}}
    out = {pkg: p["watcher"].diff_configs(old, new)
           for pkg, p in PACKAGES.items()}
    assert out["torch"] == out["jax"]
    assert out["torch"][2] == ["c"]


async def test_watcher_events_match_jax(tmp_path):
    """One sequence of config writes through both watchers: the same
    events, in order, and the same views."""
    contents = [
        None,
        [{"modelName": "m1", "modelSpec": {"storageUri": "file:///a"}}],
        [{"modelName": "m1", "modelSpec": {"storageUri": "file:///a"}}],
        [{"modelName": "m1", "modelSpec": {"storageUri": "file:///a2"}},
         {"modelName": "m2", "modelSpec": {"storageUri": "file:///b"}}],
        "{broken",
        [{"modelName": "m2", "modelSpec": {"storageUri": "file:///b"}}],
        [],
    ]

    async def run(pkg):
        root = tmp_path / pkg
        root.mkdir()
        # The directory form: models.json inside a mounted directory.
        w = PACKAGES[pkg]["watcher"].ModelConfigWatcher(str(root))
        trail = []
        for content in contents:
            if content is not None:
                text = (content if isinstance(content, str)
                        else json.dumps(content))
                (root / "models.json").write_text(text)
            emitted = await w.sync()
            events = [w.events.get_nowait()
                      for _ in range(w.events.qsize())]
            trail.append((emitted, events, dict(w.current)))
        return trail

    assert await run("torch") == await run("jax")


# ------------------------------------------------------------- downloader --
SPECS = [{"storageUri": "file:///m", "framework": "jax"},
         {"framework": "jax", "storageUri": "file:///m"},
         {"storageUri": "file:///m", "memory": "1Gi"}]


def test_spec_digest_matches_jax():
    out = {pkg: [p["downloader"].spec_digest(s) for s in SPECS]
           for pkg, p in PACKAGES.items()}
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == out["torch"][1]


def test_downloader_trees_and_idempotence_match_jax(tmp_path):
    src = tmp_path / "artifact"
    (src / "sub").mkdir(parents=True)
    (src / "config.json").write_text('{"architecture": "mlp"}')
    (src / "sub" / "weights.bin").write_bytes(bytes(range(256)))
    spec = {"storageUri": f"file://{src}"}
    changed = {"storageUri": str(src), "memory": "1Gi"}

    def run(pkg):
        root = str(tmp_path / pkg)
        d = PACKAGES[pkg]["downloader"].Downloader(root)
        trail = []
        for s in (spec, spec, changed, changed):
            got = d.download("m1", s)
            trail.append((None if got is None else os.path.relpath(
                got, root), d.is_downloaded("m1", s),
                d.is_downloaded("m1", spec), _tree(root)))
        return trail

    out = {pkg: run(pkg) for pkg in PACKAGES}
    assert out["torch"] == out["jax"]
    # The second pull of each spec stops at its marker; a changed spec
    # leaves exactly one marker.
    assert [t[0] for t in out["torch"]] == ["m1", None, "m1", None]
    markers = [k for k in out["torch"][-1][3] if "SUCCESS." in k]
    assert len(markers) == 1


class _FakeRepo:
    def __init__(self):
        self.loaded, self.unloaded = [], []

    async def load(self, name):
        self.loaded.append(name)
        return True

    async def unload(self, name):
        if name not in self.loaded:
            raise KeyError(name)
        self.unloaded.append(name)


@pytest.mark.chaos
@pytest.mark.parametrize("fail_first", [1, 2])
async def test_agent_pull_fault_retried_as_jax(tmp_path, fail_first):
    """agent.pull fails the first N pulls of m1: with the default two
    attempts the puller rides out one failure and gives up on two, in
    both packages; the injectors count alike."""
    src = tmp_path / "artifact"
    src.mkdir()
    (src / "config.json").write_text("{}")

    async def run(pkg):
        p = PACKAGES[pkg]
        p["faults"].configure({"agent.pull": {"fail_first": fail_first,
                                              "match": "m1"}})
        repo = _FakeRepo()
        retry = p["retry"].from_env("KFS_PULLER", default_max_attempts=2,
                                    base_delay_s=0.001, jitter=0.0)
        puller = p["agent"].Puller(
            repo, p["agent"].Downloader(str(tmp_path / pkg)), retry=retry)
        await puller.start()
        try:
            spec = {"storageUri": f"file://{src}"}
            for name in ("m1", "m2"):
                await puller.events.put(("load", name, spec))
            await puller.events.put(("unload", "never", spec))
            for _ in range(400):
                if puller.ops_ok + puller.ops_failed == 3:
                    break
                await asyncio.sleep(0.005)
            return (sorted(repo.loaded), repo.unloaded, puller.ops_ok,
                    puller.ops_failed, retry.retries,
                    p["faults"].stats())
        finally:
            await puller.stop()
            p["faults"].reset()

    out = {pkg: await run(pkg) for pkg in PACKAGES}
    assert out["torch"] == out["jax"]
    loaded = ["m1", "m2"] if fail_first == 1 else ["m2"]
    assert out["torch"][0] == loaded
    # m2's pulls do not match: only m1's two attempts count.
    assert out["torch"][5] == {"agent.pull": {"calls": 2,
                                              "injected": fail_first}}


# ----------------------------------------------------------------- logger --
@pytest.mark.parametrize("mode", ["all", "request", "response"])
async def test_logger_queue_matches_jax(mode):
    """The same log() calls: the same queued (event, payload) pairs in
    the mode's filter, the same drops past the queue's size, the same
    structured events."""
    def run(pkg):
        mod = PACKAGES[pkg]["logger"]
        lg = mod.RequestLogger("http://sink.invalid/", source_uri="",
                               log_mode=mod.LogMode(mode),
                               inference_service="isvc", namespace="ns",
                               endpoint="default", queue_size=3)
        for i in range(3):
            lg.log("m", "predict", "request", b'{"instances": [%d]}' % i,
                   request_id=f"r{i}")
            lg.log("m", "predict", "response", b'{"predictions": [1]}',
                   request_id=f"r{i}", status=200 + i)
        items = []
        while not lg.queue.empty():
            items.append(lg.queue.get_nowait())
        return (items, lg.dropped, lg.stats(),
                [mod.structured_event(e, b) for e, b in items])

    out = {pkg: run(pkg) for pkg in PACKAGES}
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("sink_status", [200, 500, None])
async def test_logger_sends_what_jax_sends(sink_status):
    """Both loggers against one sink: the same ce- headers and bodies
    arrive; a 500 or an unreachable sink counts failures alike."""
    sink = _Sink(sink_status or 200)
    await sink.start()
    url = sink.url
    if sink_status is None:
        await sink.stop()  # nothing listens there now

    async def run(pkg):
        sink.received.clear()
        lg = PACKAGES[pkg]["logger"].RequestLogger(
            url, inference_service="isvc", component="predictor")
        await lg.start()
        try:
            for i in range(4):
                kind = "request" if i % 2 == 0 else "response"
                lg.log("m", "predict", kind, f'{{"i": {i}}}'.encode(),
                       request_id=f"id{i // 2}")
            await asyncio.wait_for(lg.queue.join(), 10)
        finally:
            await lg.stop()
        got = sorted(
            (sorted((k.lower(), v) for k, v in h.items()
                    if k.lower().startswith("ce-")
                    or k.lower() == "content-type"), body)
            for h, body in sink.received)
        return got, lg.stats()

    try:
        out = {pkg: await run(pkg) for pkg in PACKAGES}
    finally:
        if sink_status is not None:
            await sink.stop()
    assert out["torch"] == out["jax"]
    sent, failed = out["torch"][1]["sent"], out["torch"][1]["failed"]
    assert (sent, failed) == ((4, 0) if sink_status == 200 else (0, 4))


# ------------------------------------------------ the multi-model replica --
async def test_multi_model_replica_matches_jax(tmp_path):
    """The jaxserver flags build a replica whose watcher, puller and
    downloader load each model in models.json; a removed model unloads.
    Answers agree across the packages within BF16_ATOL; the sink gets one
    request and one response event per predict, ids paired, bodies
    byte-equal to what went over the wire."""
    artifacts = {f"m{i}": _mlp_artifact(tmp_path / "src", f"m{i}", seed=i)
                 for i in (1, 2)}
    x = np.random.default_rng(0).standard_normal((3, 4)).tolist()
    sink = _Sink()
    await sink.start()

    async def wait_for(cond):
        for _ in range(600):
            if cond():
                return
            await asyncio.sleep(0.01)
        raise AssertionError("timed out")

    async def run(pkg):
        sink.received.clear()
        cfg = tmp_path / pkg / "models.json"
        argv = ["--model_dir", str(tmp_path / pkg / "models"),
                "--config_dir", str(cfg), "--log_url", sink.url,
                "--http_port", "0"]
        if pkg == "torch":
            argv += ["--device", "cpu"]
        server = PACKAGES[pkg]["jaxserver"].build_server(
            PACKAGES[pkg]["jaxserver"].parser.parse_args(argv))
        watcher, puller, lg = server.services[-3:]
        watcher.poll_interval = 0.02
        cfg.parent.mkdir(parents=True, exist_ok=True)
        cfg.write_text(json.dumps([
            {"modelName": n, "modelSpec": {"storageUri": f"file://{d}"}}
            for n, d in artifacts.items()]))
        await server.start_async([], host="127.0.0.1")
        try:
            repo = server.repository
            await wait_for(lambda: all(repo.is_model_ready(n)
                                       for n in artifacts))
            answers = {}
            for n in artifacts:
                status, _, body = await arequest(
                    server.http_port, "POST", f"/v1/models/{n}:predict",
                    {"instances": x})
                assert status == 200, body
                answers[n] = (json.loads(body)["predictions"], body)
            cfg.write_text(json.dumps([
                {"modelName": "m1",
                 "modelSpec": {"storageUri": f"file://{artifacts['m1']}"}}]))
            await wait_for(lambda: repo.get_model("m2") is None)
            status, _, _ = await arequest(
                server.http_port, "POST", "/v1/models/m2:predict",
                {"instances": x})
            await asyncio.wait_for(lg.queue.join(), 10)
            return (answers, status, sorted(os.listdir(
                tmp_path / pkg / "models")), puller.stats(), lg.stats(),
                list(sink.received))
        finally:
            await server.stop_async()

    try:
        out = {pkg: await run(pkg) for pkg in PACKAGES}
    finally:
        await sink.stop()
    for n in artifacts:
        np.testing.assert_allclose(
            np.asarray(out["torch"][0][n][0], np.float64),
            np.asarray(out["jax"][0][n][0], np.float64), atol=BF16_ATOL,
            rtol=0)
    assert out["torch"][1:5] == out["jax"][1:5]
    assert out["torch"][1] == 404
    # Three predicts (two served, one refused): six events each side.
    for pkg in PACKAGES:
        events = out[pkg][5]
        assert len(events) == 6 and out[pkg][4]["dropped"] == 0
        by_id = {}
        for headers, body in events:
            h = {k.lower(): v for k, v in headers.items()}
            by_id.setdefault(h["ce-id"], {})[h["ce-type"]] = (h, body)
        assert len(by_id) == 3
        for pair in by_id.values():
            req = pair[jax_logger.CE_TYPE_REQUEST]
            resp = pair[jax_logger.CE_TYPE_RESPONSE]
            assert json.loads(req[1]) == {"instances": x}
            model = req[0]["ce-model"]
            if model in artifacts and resp[0]["ce-status"] == "200":
                assert resp[1] == out[pkg][0][model][1]
