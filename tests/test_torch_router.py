"""The port's ingress router, breaker, brownout gate, federation and
upstream client against the JAX package's, on the CPU.

One scenario runs through both control planes on the same MLP artifact
(a two-replica service, then a 30% canary): the same answers, the same
seeded canary split and ``x-kfs-revision`` sequence, and the same
``/metrics`` families (``NOT_PORTED`` is empty), and the same live
rollout at ``/v2/rollouts`` once a third revision under a ``RolloutPolicy``
steps to 50%.  The ring, affinity and prefix-affinity picks, the
breaker's transitions, ``merge_scrapes`` and the autoscaler's sizing are
held against the JAX classes on one input.  Failover, timeout-no-evict,
mid-response-no-retry, fail-fast activation and swap holds are the JAX
tests' cases on the port; the client's connect error, single send and
streaming read are what the router's upstream calls rest on; the chain
runs ``vit_tiny`` behind the port's image transformer against the JAX
chain; scale to zero and activation run through the autoscaler.
"""

import asyncio
import json
import os
import random

import jax
import numpy as np
import pytest
from flax import serialization
from torch_parity import randomized
from torch_serving import arequest

from examples.image_transformer import ImageTransformer as JaxTransformer
from kfserving_tpu.control import autoscaler as jax_autoscaler
from kfserving_tpu.control import controller as jax_controller
from kfserving_tpu.control import orchestrator as jax_orchestrator
from kfserving_tpu.control import rollout as jax_rollout
from kfserving_tpu.control import router as jax_router
from kfserving_tpu.control import spec as jax_spec
from kfserving_tpu.models import create_model as jax_create_model
from kfserving_tpu.observability import REGISTRY as JAX_REGISTRY
from kfserving_tpu.observability import federation as jax_federation
from kfserving_tpu.reliability import breaker as jax_breaker
from kfserving_tpu.reliability import brownout as jax_brownout
from kfserving_tpu_torch.control import autoscaler, controller, orchestrator
from kfserving_tpu_torch.control import rollout, router, spec
from kfserving_tpu_torch.examples.image_transformer import ImageTransformer
from kfserving_tpu_torch.observability import REGISTRY, federation
from kfserving_tpu_torch.reliability import breaker, brownout, faults
from kfserving_tpu_torch.server.client import (
    ConnectError,
    HTTPClient,
    HTTPClientError,
)

PACKAGES = {
    "jax": dict(spec=jax_spec, controller=jax_controller,
                orchestrator=jax_orchestrator, router=jax_router,
                autoscaler=jax_autoscaler, breaker=jax_breaker,
                brownout=jax_brownout, federation=jax_federation,
                registry=JAX_REGISTRY, rollout=jax_rollout),
    "torch": dict(spec=spec, controller=controller,
                  orchestrator=orchestrator, router=router,
                  autoscaler=autoscaler, breaker=breaker,
                  brownout=brownout, federation=federation,
                  registry=REGISTRY, rollout=rollout),
}
# Families the JAX router exports that the port does not: none since the
# rollout manager and the predictive loop were ported.
NOT_PORTED = set()
MLP_KWARGS = {"input_dim": 4, "features": [16], "num_classes": 5}
# The router's federated views, and their refusals of bad parameters.
FLEET_VIEWS = [
    "/debug/traces?limit=5", "/v2/health/slo?refresh=1",
    "/debug/flightrecorder?limit=5&pinned=1", "/debug/profile?format=events",
    "/debug/profile?window_s=5", "/debug/history?window_s=5",
    "/debug/incidents", "/debug/incidents?id=nope", "/debug/cache?top_k=2",
    "/debug/traces?limit=x", "/debug/profile?format=bogus",
    "/debug/history?step_s=x", "/debug/cache?top_k=x",
    "/debug/flightrecorder?since_ts=x", "/debug/incidents?limit=x",
]


@pytest.fixture(autouse=True)
def _port_state():
    # The port's process registry is its own (the JAX one is reset by
    # tests/conftest.py); fault specs are process-global.
    REGISTRY.reset()
    faults.reset()
    yield
    faults.reset()
    REGISTRY.reset()


def _mlp_dir(root, name, seed=0):
    spec_ = jax_create_model("mlp", **MLP_KWARGS)
    shapes = jax.eval_shape(lambda: spec_.module.init(
        jax.random.PRNGKey(0), spec_.example))
    path = os.path.join(str(root), name)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"architecture": "mlp", "arch_kwargs": MLP_KWARGS,
                   "dtype": "float32", "max_latency_ms": 2,
                   "warmup": False, "output": "argmax"}, f)
    with open(os.path.join(path, "checkpoint.msgpack"), "wb") as f:
        f.write(serialization.to_bytes(randomized(shapes, seed)))
    return path


def _orchestrator(pkg, **kwargs):
    cls = PACKAGES[pkg]["orchestrator"].InProcessOrchestrator
    if pkg == "torch":
        kwargs.setdefault("device", "cpu")
    return cls(**kwargs)


def _families(text: str):
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE ")}


def _predict_path(name):
    return f"/v1/models/{name}:predict"


# ------------------------------------------------ one scenario, two stacks --
async def _scenario(pkg, dirs):
    """A 2-replica service, then a 30% canary: answers and revision
    headers of sequential requests, plus the router's scrapes."""
    s = PACKAGES[pkg]["spec"]
    orch = _orchestrator(pkg)
    c = PACKAGES[pkg]["controller"].Controller(orch)
    r = PACKAGES[pkg]["router"].IngressRouter(c, seed=7)
    await r.start_async()
    out = {"answers": [], "revisions": [], "statuses": []}
    rng = np.random.default_rng(3)
    rows = rng.normal(size=(26, 4)).round(3).tolist()
    try:
        isvc = s.InferenceService(name="mlp", predictor=s.PredictorSpec(
            framework="jax", storage_uri=f"file://{dirs[0]}",
            min_replicas=2, max_replicas=2))
        await c.apply(isvc)
        canary = s.InferenceService(name="mlp", predictor=s.PredictorSpec(
            framework="jax", storage_uri=f"file://{dirs[1]}",
            min_replicas=2, max_replicas=2, canary_traffic_percent=30))
        for i, row in enumerate(rows):
            if i == 6:
                await c.apply(canary)
            status, headers, body = await arequest(
                r.http_port, "POST", _predict_path("mlp"),
                {"instances": [row]})
            out["statuses"].append(status)
            out["answers"].append(json.loads(body)["predictions"])
            out["revisions"].append(headers.get("x-kfs-revision"))
        for path in ("/v1/models/nope:predict", "/v1/models/mlp"):
            method = "POST" if path.endswith("predict") else "GET"
            status, _, body = await arequest(r.http_port, method, path,
                                             {"instances": [[0] * 4]})
            out["statuses"].append(status)
        _, _, body = await arequest(r.http_port, "GET", "/metrics")
        out["metrics"] = body.decode()
        _, _, body = await arequest(r.http_port, "GET",
                                    "/metrics?federate=0")
        out["own_metrics"] = body.decode()
        out["fleet_views"] = {}
        for path in FLEET_VIEWS:
            status, _, body = await arequest(r.http_port, "GET", path)
            view = json.loads(body) if body else None
            out["fleet_views"][path] = (
                status, sorted(view) if isinstance(view, dict) else view)
        out["replica_keys"] = sorted(json.loads(
            (await arequest(r.http_port, "GET",
                            "/debug/cache"))[2])["replicas"])
        out["replica_count"] = len(r._replica_hosts())
        out["rollouts"] = await _live_rollout(pkg, c, r, dirs[2])
    finally:
        await r.stop_async()
        await orch.shutdown()
    return out


def _masked(value):
    """A rollout report with its time stamps and replica hosts masked."""
    if isinstance(value, dict):
        return {k: "*" if k in ("ts", "started_ts", "updated_ts",
                                "replicas") else _masked(v)
                for k, v in value.items()}
    if isinstance(value, list):
        return [_masked(v) for v in value]
    return value


async def _live_rollout(pkg, c, r, model_dir):
    """A third revision under a RolloutPolicy: the package's manager
    probes its replicas' readiness over HTTP and steps it to 50%; the
    router's /v2/rollouts then reports the live rollout."""
    s = PACKAGES[pkg]["spec"]
    mgr = PACKAGES[pkg]["rollout"].RolloutManager(c)
    if pkg == "jax":
        import aiohttp

        mgr._session = aiohttp.ClientSession(
            timeout=aiohttp.ClientTimeout(total=2.0))
    else:
        from kfserving_tpu_torch.server.client import HTTPClient

        mgr._http = HTTPClient(timeout=2.0, keepalive=False)
    try:
        await c.apply(s.InferenceService(name="mlp", predictor=s.PredictorSpec(
            framework="jax", storage_uri=f"file://{model_dir}",
            min_replicas=2, max_replicas=2, rollout=s.RolloutPolicy(
                steps=[50, 100], hold_s=60.0, settle_s=0.0,
                warmup_probes=1))))
        await mgr.tick()
        _, _, body = await arequest(r.http_port, "GET", "/v2/rollouts")
        return _masked(json.loads(body))
    finally:
        if pkg == "jax":
            await mgr._session.close()
        else:
            await mgr._http.close()


@pytest.fixture(scope="module")
def scenario(tmp_path_factory):
    root = tmp_path_factory.mktemp("router")
    dirs = [_mlp_dir(root, "v1", seed=0), _mlp_dir(root, "v2", seed=1),
            _mlp_dir(root, "v3", seed=2)]
    out = {}
    # Every replica's history sampler ticks within the scenario, so its
    # families show in both scrapes.
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KFS_HISTORY_TICK_S", "0.02")
        for pkg in ("jax", "torch"):
            REGISTRY.reset()
            JAX_REGISTRY.reset()
            out[pkg] = asyncio.run(_scenario(pkg, dirs))
    REGISTRY.reset()
    JAX_REGISTRY.reset()
    return out


def test_same_answers_and_statuses(scenario):
    assert scenario["torch"]["statuses"] == scenario["jax"]["statuses"] \
        == [200] * 26 + [404, 200]
    assert scenario["torch"]["answers"] == scenario["jax"]["answers"]


def test_same_seeded_canary_split_and_revision_headers(scenario):
    revs = scenario["torch"]["revisions"]
    assert revs == scenario["jax"]["revisions"]
    assert len(set(revs[:6])) == 1 and len(set(revs[6:])) == 2
    assert all(revs)


def test_same_metric_families_as_the_jax_router(scenario):
    jax_families = _families(scenario["jax"]["metrics"])
    port_families = _families(scenario["torch"]["metrics"])
    assert port_families == jax_families - NOT_PORTED
    own = _families(scenario["torch"]["own_metrics"])
    for family in ("kfserving_tpu_router_request_ms",
                   "kfserving_tpu_router_requests_total",
                   "kfserving_tpu_router_inflight",
                   "kfserving_tpu_revision_requests_total",
                   "kfserving_tpu_revision_request_ms"):
        assert family in own
    rollouts = scenario["torch"]["rollouts"]
    assert rollouts == scenario["jax"]["rollouts"]
    # A live rollout, stepped once after real readiness probes.
    [active] = rollouts["active"]
    assert (active["phase"], active["percent"]) == ("progressing", 50)
    assert [e["event"] for e in active["events"]] == \
        ["started", "warmed", "step"]


def test_same_fleet_views(scenario):
    """Every federated view answers with the same status and top-level
    shape as the JAX router's, refusals included."""
    views = scenario["torch"]["fleet_views"]
    assert views == scenario["jax"]["fleet_views"]
    assert [views[p][0] for p in FLEET_VIEWS] == [200] * 7 + [404] + \
        [200] + [400] * 6
    assert len(scenario["torch"]["replica_keys"]) == 4
    assert scenario["torch"]["replica_count"] == \
        scenario["jax"]["replica_count"] == 4


def test_route_tables_are_equal():
    from kfserving_tpu.server import http as jax_http
    from kfserving_tpu_torch.server import http as port_http

    tables = {}
    for pkg, module in (("jax", jax_http), ("torch", port_http)):
        table = tables[pkg] = set()
        add = module.Router.add

        def recording(self, method, pattern, handler, _add=add,
                      _table=table):
            _table.add((method, pattern))
            return _add(self, method, pattern, handler)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(module.Router, "add", recording)
            PACKAGES[pkg]["router"].IngressRouter(
                PACKAGES[pkg]["controller"].Controller(
                    PACKAGES[pkg]["orchestrator"].FakeOrchestrator()))
    assert tables["torch"] == tables["jax"]
    assert ("GET", "/debug/incidents") in tables["torch"]


# ------------------------------------------------------ pure router logic --
def _fake_stack(pkg, hosts_per_cid):
    orch = PACKAGES[pkg]["orchestrator"].FakeOrchestrator()
    rep = PACKAGES[pkg]["orchestrator"].Replica
    for cid, hosts in hosts_per_cid.items():
        state = orch.state.setdefault(
            cid, PACKAGES[pkg]["orchestrator"]._ComponentState())
        state.replicas.extend(rep(cid, "rev1", h) for h in hosts)
    c = PACKAGES[pkg]["controller"].Controller(orch)
    return orch, PACKAGES[pkg]["router"].IngressRouter(c, seed=11,
                                                       affinity="model")


def test_ring_affinity_and_prefix_picks_match_jax():
    hosts = [f"10.0.0.{i}:80{i}" for i in range(1, 6)]
    keys = [f"model-{i}" for i in range(40)]
    bodies = [b"", b"not json", json.dumps({"text_input": "hi"}).encode(),
              json.dumps({"instances": [{"prompt": "a" * 700}]}).encode(),
              json.dumps({"instances": ["b" * 2000]}).encode(),
              json.dumps({"prompt": "x"}).encode(),
              json.dumps({"instances": [{"prompt": "é" * 300}]}).encode()]

    def run(pkg):
        orch, r = _fake_stack(pkg, {"ns/m/predictor": hosts})
        replicas = orch.replicas("ns/m/predictor")
        ring = r._ring(tuple(sorted(hosts)))
        picks = [r._affinity_pick(k, replicas, lambda h: None)
                 for k in keys]
        # A loaded home spills to the next distinct host on the ring.
        r._host_inflight[picks[0]] = r.affinity_spill
        spilled = r._affinity_pick(keys[0], replicas, lambda h: None)
        r._host_inflight.clear()
        prefix = [r._prefix_affinity_key(b) for b in bodies]
        rr = [r._pick_replica("ns/m/predictor", "rev1") for _ in range(7)]
        pinned = [r._pick_replica("ns/m/predictor", "rev1",
                                  affinity_key=k) for k in keys[:10]]
        excluded = [r._pick_replica("ns/m/predictor", "rev1",
                                    exclude=set(hosts[:4]))
                    for _ in range(3)]
        return ring[:50], len(ring), picks, spilled, prefix, rr, pinned, \
            excluded

    jax_out, port_out = run("jax"), run("torch")
    assert port_out == jax_out
    assert port_out[1] == 5 * router.IngressRouter.AFFINITY_VNODES
    assert port_out[3] != port_out[2][0]


def test_canary_rolls_match_jax():
    from types import SimpleNamespace as target

    cstatus = target(traffic=[target(revision="a", percent=30),
                              target(revision="b", percent=70),
                              target(revision="c", percent=0)])

    def run(pkg):
        _, r = _fake_stack(pkg, {})
        return [r._pick_revision(cstatus) for _ in range(500)]

    assert run("torch") == run("jax")


def test_breaker_transitions_match_jax():
    """One seeded sequence of failures, successes, admissions, resets and
    clock steps through both breakers (three configurations): the same
    states and verdicts at every step, and the same state gauge and
    transition counters in each package's registry."""
    rng = random.Random(5)
    events = [rng.choice(["fail", "fail", "ok", "allow", "allow", "tick",
                          "tick", "reset"]) for _ in range(400)]
    steps = [rng.uniform(0.0, 3.0) for _ in events]
    configs = [dict(failure_threshold=3, window_s=10.0, reset_timeout_s=5.0),
               dict(failure_threshold=1, reset_timeout_s=2.0,
                    half_open_max=2),
               dict(failure_threshold=2, window_s=4.0, reset_timeout_s=1.0,
                    half_open_max=0)]

    def run(pkg):
        out = []
        for n, cfg in enumerate(configs):
            now = {"t": 0.0}
            b = PACKAGES[pkg]["breaker"].CircuitBreaker(
                name=f"b{n}", clock=lambda: now["t"], **cfg)
            for event, dt in zip(events, steps):
                if event == "fail":
                    b.record_failure()
                elif event == "ok":
                    b.record_success()
                elif event == "allow":
                    out.append(b.allow())
                elif event == "reset":
                    b.reset()
                else:
                    now["t"] += dt
                out.append(b.state)
        return out

    jax_out, port_out = run("jax"), run("torch")
    assert port_out == jax_out
    assert {"open", "half_open", "closed"} <= set(port_out)


def test_breaker_metrics_match_jax():
    def run(pkg):
        now = {"t": 0.0}
        b = PACKAGES[pkg]["breaker"].CircuitBreaker(
            failure_threshold=1, reset_timeout_s=1.0, name="replica:h",
            clock=lambda: now["t"])
        b.record_failure()
        now["t"] = 2.0
        b.allow()
        b.record_success()
        text = "\n".join(PACKAGES[pkg]["registry"].render_lines())
        return sorted(line for line in text.splitlines()
                      if "breaker" in line and not line.startswith("#"))

    assert run("torch") == run("jax")


def test_brownout_admission_matches_jax():
    rng = random.Random(9)
    ops = [(rng.choice(["set", "admit", "admit", "estimate"]),
            rng.choice(["m1", "m2"]), rng.randint(0, 4),
            rng.choice([None, 0.001, 0.5, 5.0]))
           for _ in range(300)]

    def run(pkg):
        b = PACKAGES[pkg]["brownout"].BrownoutController(retry_after_s=2.0)
        tiers = [PACKAGES[pkg]["brownout"].priority_tier(v)
                 for v in (None, "batch", "normal", "critical", "bogus")]
        out = [tiers]
        for op, model, n, budget in ops:
            if op == "set":
                out.append(b.set_level(model, n))
            elif op == "estimate":
                b.update_estimate(model, n * 0.1)
            else:
                out.append(b.admit(model, n % 3, budget))
            out.append(b.report())
        return out

    assert run("torch") == run("jax")


def test_merge_scrapes_matches_jax():
    own = ['# HELP kfserving_tpu_router_inflight In-flight',
           '# TYPE kfserving_tpu_router_inflight gauge',
           'kfserving_tpu_router_inflight{component="router/m/predictor"} 2']
    replica_a = "\n".join([
        '# HELP kfserving_tpu_request_total Requests',
        '# TYPE kfserving_tpu_request_total counter',
        'kfserving_tpu_request_total{model="m",verb="predict",'
        'status="200"} 5',
        '# HELP kfserving_tpu_request_latency_ms Latency',
        '# TYPE kfserving_tpu_request_latency_ms histogram',
        'kfserving_tpu_request_latency_ms_bucket{le="1.0"} 1 # '
        '{trace_id="ab"} 0.5 1700000000.0',
        'kfserving_tpu_request_latency_ms_bucket{le="+Inf"} 3',
        'kfserving_tpu_request_latency_ms_sum 7.5',
        'kfserving_tpu_request_latency_ms_count 3',
        '# EOF'])
    replica_b = "\n".join([
        '# TYPE kfserving_tpu_request_total counter',
        'kfserving_tpu_request_total{model="m\\"q",verb="predict",'
        'status="503"} 1',
        '# TYPE kfserving_tpu_router_inflight gauge',
        'kfserving_tpu_router_inflight 9',
        'garbage line without value',
        'kfserving_tpu_uptime_seconds 12.5'])
    scrapes = [("127.0.0.1:1", replica_a), ("127.0.0.1:2", replica_b)]

    def run(pkg):
        fed = PACKAGES[pkg]["federation"]
        return [fed.merge_scrapes(list(own), scrapes, keep_exemplars=k)
                for k in (False, True)] + [
            fed.relabel(replica_a, {"replica": "h"}),
            [fed.split_sample(line) for line in replica_b.splitlines()]]

    jax_out, port_out = run("jax"), run("torch")
    assert port_out == jax_out
    assert any('replica="127.0.0.1:1"' in line for line in port_out[0])


async def test_autoscaler_sizing_matches_jax():
    """The same in-flight gauge sequence through both autoscalers over
    fake fleets: the same replica counts per component after each tick,
    and scale to zero after the idle ticks."""
    gauges = [(16, 0), (16, 0), (0, 24), (0, 24), (0, 0)] + [(0, 0)] * 32

    async def run(pkg):
        s = PACKAGES[pkg]["spec"]
        orch = PACKAGES[pkg]["orchestrator"].FakeOrchestrator()
        c = PACKAGES[pkg]["controller"].Controller(orch)
        isvc = s.InferenceService(name="duo", predictor=s.PredictorSpec(
            framework="jax", storage_uri="file:///m", max_replicas=8,
            min_replicas=0))
        isvc.transformer = s.TransformerSpec(min_replicas=1, max_replicas=8,
                                             command=["true"])
        await c.apply(isvc)
        r = PACKAGES[pkg]["router"].IngressRouter(c)
        scaler = PACKAGES[pkg]["autoscaler"].Autoscaler(
            c, r, target_concurrency=4.0, tick_seconds=0.01)
        counts = []
        for pred, trans in gauges:
            r.inflight["router/duo/predictor"] = pred
            r.inflight["router/duo/transformer"] = trans
            await scaler.tick()
            counts.append((len(orch.replicas("default/duo/predictor")),
                           len(orch.replicas("default/duo/transformer"))))
        return counts

    jax_counts, port_counts = await run("jax"), await run("torch")
    assert port_counts == jax_counts
    assert port_counts[1] == (4, 1) and port_counts[-1][0] == 0


# ------------------------------------------------------------ the client --
async def test_client_connect_error_means_nothing_was_sent():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    client = HTTPClient(timeout=5, keepalive=False)
    with pytest.raises(ConnectError) as err:
        await client.request("POST", f"http://127.0.0.1:{port}/x", b"{}")
    assert isinstance(err.value, OSError)
    with pytest.raises(ConnectError):
        await client.open("GET", f"http://127.0.0.1:{port}/")


async def test_client_without_keepalive_sends_once():
    """A peer that reads the request and closes: the keep-alive client
    re-sends a request it wrote on a reused connection (the idle
    connection may have timed out); the router's client never re-sends,
    and the failure is not a ConnectError."""
    seen = []

    async def handle(reader, writer):
        data = await reader.readuntil(b"\r\n\r\n")
        seen.append(data)
        if len(seen) == 1:
            writer.write(b"HTTP/1.1 200 OK\r\ncontent-length: 2\r\n\r\nok")
            await writer.drain()
            # Keep the connection open, then drop it on the next request.
            try:
                await reader.readuntil(b"\r\n\r\n")
                seen.append(b"second on the kept connection")
            except asyncio.IncompleteReadError:
                pass
        writer.close()

    server = await asyncio.start_server(handle, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{server.sockets[0].getsockname()[1]}/p"
    try:
        keepalive = HTTPClient(timeout=5)
        assert (await keepalive.request("GET", url))[0] == 200
        # The reused connection is dropped after the request was
        # written; the keep-alive client sends it again on a new one.
        with pytest.raises(HTTPClientError):
            await keepalive.request("POST", url, b"x")
        assert len(seen) == 3
        seen.clear()
        once = HTTPClient(timeout=5, keepalive=False)
        assert (await once.request("GET", url))[0] == 200
        assert b"Connection: close" in seen[0]
        seen.clear()
        seen.append(b"first")       # the handler now drops every request
        with pytest.raises(HTTPClientError) as err:
            await once.request("POST", url, b"x")
        assert not isinstance(err.value, ConnectError)
        assert len(seen) == 2       # sent exactly once
    finally:
        server.close()
        await server.wait_closed()


async def test_client_streams_a_chunked_body_and_closes_early():
    gate = asyncio.Event()
    closed = asyncio.Event()

    async def handle(reader, writer):
        await reader.readuntil(b"\r\n\r\n")
        writer.write(b"HTTP/1.1 200 OK\r\ncontent-type: text/event-stream\r\n"
                     b"transfer-encoding: chunked\r\n\r\n")
        writer.write(b"6\r\ndata 1\r\n")
        await writer.drain()
        await gate.wait()
        try:
            for i in range(2, 100):
                writer.write(b"6\r\ndata %d\r\n" % (i % 10))
                await writer.drain()
                await asyncio.sleep(0.01)
        except (ConnectionError, OSError):
            closed.set()
        writer.close()

    server = await asyncio.start_server(handle, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{server.sockets[0].getsockname()[1]}/s"
    try:
        resp = await HTTPClient(timeout=5, keepalive=False).open("POST", url)
        assert resp.status == 200
        assert resp.headers["content-type"] == "text/event-stream"
        chunks = resp.iter_chunks(read_timeout=5)
        # The first chunk arrives before the body is complete.
        assert await asyncio.wait_for(chunks.__anext__(), 5) == b"data 1"
        gate.set()
        assert await chunks.__anext__() == b"data 2"
        await chunks.aclose()       # the downstream went away
        await asyncio.wait_for(closed.wait(), 5)
        # A read timeout bounds each piece, not the whole body.
        gate.clear()
        resp = await HTTPClient(timeout=5, keepalive=False).open("GET", url)
        with pytest.raises(TimeoutError):
            async for _ in resp.iter_chunks(read_timeout=0.2):
                pass
        gate.set()
    finally:
        server.close()


# --------------------------------------------- routing behavior, port side --
class _Recorder:
    """A raw upstream that records each request's head and answers it."""

    def __init__(self):
        self.heads = []
        self.server = None

    async def start(self):
        async def handle(reader, writer):
            head = await reader.readuntil(b"\r\n\r\n")
            n = int(next((line.split(b":")[1] for line in head.split(b"\r\n")
                          if line.lower().startswith(b"content-length")),
                         b"0"))
            if n:
                await reader.readexactly(n)
            self.heads.append(head.decode("latin1").lower())
            body = b'{"predictions": [7]}'
            writer.write(b"HTTP/1.1 200 OK\r\ncontent-type: "
                         b"application/json\r\ncontent-length: %d\r\n"
                         b"connection: close\r\n\r\n%s" % (len(body), body))
            await writer.drain()
            writer.close()

        self.server = await asyncio.start_server(handle, "127.0.0.1", 0)
        return f"127.0.0.1:{self.server.sockets[0].getsockname()[1]}"


async def test_failover_evicts_and_retries_with_the_kv_peer_hint():
    """A refused connection is a pre-dispatch failure: the router evicts
    the dead replica and retries the next one, naming the dead one in
    x-kfs-kv-peer so a successor can pull its KV."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        dead = f"127.0.0.1:{sock.getsockname()[1]}"
    live = _Recorder()
    live_host = await live.start()
    orch = orchestrator.FakeOrchestrator()
    c = controller.Controller(orch)
    await c.apply(spec.InferenceService(
        name="ha", predictor=spec.PredictorSpec(
            framework="jax", storage_uri="file:///m", min_replicas=2,
            max_replicas=2)))
    replicas = orch.replicas("default/ha/predictor")
    replicas[0].host, replicas[1].host = dead, live_host
    r = router.IngressRouter(c)
    await r.start_async()
    try:
        status, headers, body = await arequest(
            r.http_port, "POST", _predict_path("ha"), {"instances": [[1]]})
        assert status == 200 and json.loads(body) == {"predictions": [7]}
        assert [x.host for x in orch.replicas("default/ha/predictor")] == \
            [live_host]
        assert f"x-kfs-kv-peer: http://{dead}" in live.heads[-1]
        assert "connection: close" in live.heads[-1]
    finally:
        await r.stop_async()
        live.server.close()


async def test_router_fails_over_a_dead_in_process_replica(tmp_path):
    orch = _orchestrator("torch")
    c = controller.Controller(orch)
    r = router.IngressRouter(c)
    await r.start_async()
    try:
        await c.apply(spec.InferenceService(
            name="ha", predictor=spec.PredictorSpec(
                framework="jax",
                storage_uri=f"file://{_mlp_dir(tmp_path, 'm')}",
                min_replicas=2, max_replicas=2)))
        cid = "default/ha/predictor"
        dead = orch.replicas(cid)[0]
        await dead.handle.stop_async()
        for _ in range(4):
            status, _, body = await arequest(
                r.http_port, "POST", _predict_path("ha"),
                {"instances": [[0.1, 0.2, 0.3, 0.4]]})
            assert status == 200, body
        assert dead.host not in [x.host for x in orch.replicas(cid)]
    finally:
        await r.stop_async()
        await orch.shutdown()


def _custom_isvc(name, **pred):
    return spec.InferenceService(name=name, predictor=spec.PredictorSpec(
        framework="custom", command=["unused"], **pred))


async def test_router_timeout_does_not_evict():
    from kfserving_tpu_torch.model.model import Model

    class SlowModel(Model):
        def load(self):
            self.ready = True
            return True

        async def predict(self, request):
            await asyncio.sleep(2.0)
            return {"predictions": [1]}

    orch = _orchestrator("torch", model_factory=lambda cid, s: SlowModel(
        cid.split("/")[1]))
    c = controller.Controller(orch)
    r = router.IngressRouter(c, upstream_timeout_s=0.3)
    await r.start_async()
    try:
        await c.apply(_custom_isvc("slow"))
        status, _, body = await arequest(r.http_port, "POST",
                                         _predict_path("slow"),
                                         {"instances": [[1]]})
        assert status == 504, body
        assert len(orch.replicas("default/slow/predictor")) == 1
    finally:
        await r.stop_async()
        await orch.shutdown()


async def test_router_mid_response_failure_no_retry_no_evict():
    from kfserving_tpu_torch.model.model import Model

    class OkModel(Model):
        def load(self):
            self.ready = True
            return True

        async def predict(self, request):
            return {"predictions": [1]}

    hits = {"n": 0}

    async def slam(reader, writer):
        head = await reader.read(1024)
        if head.startswith(b"GET / "):
            writer.write(b"HTTP/1.1 200 OK\r\ncontent-length: 5\r\n"
                         b"connection: close\r\n\r\nAlive")
            await writer.drain()
            writer.close()
            return
        hits["n"] += 1
        writer.close()

    orch = _orchestrator("torch", model_factory=lambda cid, s: OkModel(
        cid.split("/")[1]))
    c = controller.Controller(orch)
    r = router.IngressRouter(c)
    await r.start_async()
    slam_server = await asyncio.start_server(slam, "127.0.0.1", 0)
    try:
        await c.apply(_custom_isvc("drop"))
        replicas = orch.replicas("default/drop/predictor")
        replicas[0].host = \
            f"127.0.0.1:{slam_server.sockets[0].getsockname()[1]}"
        status, _, body = await arequest(r.http_port, "POST",
                                         _predict_path("drop"),
                                         {"instances": [[1]]})
        assert status == 502, body
        assert hits["n"] == 1
        assert len(orch.replicas("default/drop/predictor")) == 1
    finally:
        slam_server.close()
        await r.stop_async()
        await orch.shutdown()


async def test_activation_fails_fast_on_a_deterministic_create_error():
    import time

    class BoomOrchestrator(orchestrator.InProcessOrchestrator):
        async def create_replica(self, component_id, revision, spec_,
                                 placement=None):
            raise RuntimeError("no such artifact")

    orch = BoomOrchestrator(device="cpu")
    c = controller.Controller(orch)
    r = router.IngressRouter(c)
    await r.start_async()
    try:
        await c.apply(_custom_isvc("doomed", min_replicas=0))
        t0 = time.perf_counter()
        status, _, _ = await arequest(r.http_port, "POST",
                                      _predict_path("doomed"),
                                      {"instances": [[1]]})
        assert status == 503
        assert time.perf_counter() - t0 < 10.0
    finally:
        await r.stop_async()


class _StubReplica:
    def __init__(self, revision, host):
        self.revision, self.host = revision, host


class _StubOrch:
    def __init__(self):
        self.swap_announced = {}
        self._replicas = {}
        self.state = {}

    def replicas(self, cid):
        return list(self._replicas.get(cid, []))


def _stub_router(orch):
    from types import SimpleNamespace

    ctl = SimpleNamespace(reconciler=SimpleNamespace(orchestrator=orch))
    return router.IngressRouter(ctl)


async def test_swap_hold_serves_when_a_replica_appears():
    from kfserving_tpu_torch.observability import metrics as obs

    orch = _StubOrch()
    r = _stub_router(orch)
    cid = "default/m/predictor"
    orch.swap_announced[cid] = asyncio.get_running_loop().time() + 5.0

    async def register_later():
        await asyncio.sleep(0.15)
        orch._replicas[cid] = [_StubReplica("rev1", "127.0.0.1:9999")]

    task = asyncio.ensure_future(register_later())
    verdict, host = await r._hold_for_swap(cid, "rev1", (), None)
    await task
    assert (verdict, host) == ("host", "127.0.0.1:9999")
    assert obs.router_swap_held_total().labels(outcome="served").value == 1
    assert not r._swap_held


async def test_swap_hold_sheds_at_the_cap_and_passes_unannounced():
    orch = _StubOrch()
    r = _stub_router(orch)
    r.swap_hold_max = 1
    cid = "default/m/predictor"
    assert (await r._hold_for_swap(cid, "rev1", (), None))[0] == "pass"
    orch.swap_announced[cid] = asyncio.get_running_loop().time() + 5.0
    r._swap_held[cid] = 1
    assert (await r._hold_for_swap(cid, "rev1", (), None))[0] == "shed"


async def test_brownout_gate_sheds_like_the_jax_router():
    """A model at brownout level 2 sheds batch and normal tiers with the
    same retriable 503 body and Retry-After as the JAX router; critical
    passes to the (absent) replica and 404s on the name."""
    outs = {}
    for pkg in PACKAGES:
        b = PACKAGES[pkg]["brownout"].BrownoutController(retry_after_s=2.0)
        b.set_level("m", 2)
        r = PACKAGES[pkg]["router"].IngressRouter(
            PACKAGES[pkg]["controller"].Controller(
                PACKAGES[pkg]["orchestrator"].FakeOrchestrator()),
            brownout=b)
        await r.start_async()
        try:
            got = []
            for tier in ("batch", "normal", "critical"):
                status, headers, body = await arequest(
                    r.http_port, "POST", _predict_path("m"),
                    {"instances": [[1]]}, {"x-kfs-priority": tier})
                got.append((status, headers.get("retry-after"),
                            json.loads(body)))
            outs[pkg] = got
        finally:
            await r.stop_async()
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][0][0] == 503 and outs["torch"][0][2]["retriable"]


# ---------------------------------------------------------- the two chains --
VIT_TINY = {"architecture": "vit_tiny", "arch_kwargs": {"dtype": "float32"},
            "max_batch_size": 8, "max_latency_ms": 5.0, "warmup": False,
            "output": "logits"}


async def _chain(pkg, model_dir, images):
    s = PACKAGES[pkg]["spec"]
    orch_mod = PACKAGES[pkg]["orchestrator"]
    transformer_cls = JaxTransformer if pkg == "jax" else ImageTransformer

    def factory(component_id, spec_):
        if isinstance(spec_, s.TransformerSpec):
            return transformer_cls(component_id.split("/")[1],
                                   predictor_host=None)
        if pkg == "jax":
            return orch_mod.default_model_factory(component_id, spec_)
        return orch_mod.default_model_factory(component_id, spec_,
                                              device="cpu")

    orch = orch_mod.InProcessOrchestrator(model_factory=factory, **(
        {"device": "cpu"} if pkg == "torch" else {}))
    c = PACKAGES[pkg]["controller"].Controller(orch)
    r = PACKAGES[pkg]["router"].IngressRouter(c)
    await r.start_async()
    try:
        await c.apply(s.InferenceService(
            name="vitchain",
            predictor=s.PredictorSpec(framework="jax",
                                      storage_uri=f"file://{model_dir}"),
            transformer=s.TransformerSpec()))
        t = orch.replicas("default/vitchain/transformer")[0]
        model = t.handle.repository.get_model("vitchain")
        assert model.predictor_host == \
            f"127.0.0.1:{r.http_port}/direct/predictor"
        out = []
        for image in images:
            status, headers, body = await arequest(
                r.http_port, "POST", _predict_path("vitchain"),
                {"instances": [image.tolist()]})
            assert status == 200, body
            out.append((np.asarray(json.loads(body)["predictions"][0]),
                        headers.get("x-kfs-revision")))
        return out
    finally:
        await r.stop_async()
        await orch.shutdown()


async def test_chain_matches_the_jax_chain(tmp_path):
    spec_ = jax_create_model("vit_tiny", dtype="float32")
    shapes = jax.eval_shape(lambda: spec_.module.init(
        jax.random.PRNGKey(0), spec_.example))
    model_dir = os.path.join(str(tmp_path), "vit")
    os.makedirs(model_dir)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(VIT_TINY, f)
    with open(os.path.join(model_dir, "checkpoint.msgpack"), "wb") as f:
        f.write(serialization.to_bytes(randomized(shapes, 4)))
    size = spec_.example.shape[1]
    images = np.random.default_rng(2).integers(
        0, 256, (3, size, size, 3)).astype(np.uint8)
    jax_out = await _chain("jax", model_dir, images)
    port_out = await _chain("torch", model_dir, images)
    for (want, want_rev), (got, rev) in zip(jax_out, port_out):
        assert rev == want_rev and rev
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
        assert int(np.argmax(got)) == int(np.argmax(want))


async def test_scale_to_zero_and_activate(tmp_path):
    orch = _orchestrator("torch")
    c = controller.Controller(orch)
    r = router.IngressRouter(c)
    scaler = autoscaler.Autoscaler(c, r, tick_seconds=0.01)
    await r.start_async()
    cid = "default/szero/predictor"
    try:
        await c.apply(spec.InferenceService(
            name="szero", predictor=spec.PredictorSpec(
                framework="jax",
                storage_uri=f"file://{_mlp_dir(tmp_path, 'm')}",
                min_replicas=0)))
        assert orch.replicas(cid) == []
        status, headers, body = await arequest(
            r.http_port, "POST", _predict_path("szero"),
            {"instances": [[0.1, 0.2, 0.3, 0.4]]})
        assert status == 200, body
        assert headers.get("x-kfs-revision")
        replica = orch.replicas(cid)[0]
        model = replica.handle.repository.get_model("szero")
        for _ in range(autoscaler.IDLE_TICKS_TO_ZERO + 1):
            await scaler.tick()
        assert orch.replicas(cid) == []
        # The scale-down released the model it built.
        assert not model.ready and model.engine is None
    finally:
        await scaler.stop()
        await r.stop_async()
        await orch.shutdown()


async def test_stream_passes_through_the_router(tmp_path):
    """An SSE generate through the router's pass-through: the same
    events as the replica's own stream, the revision header, and the
    in-flight gauge released when the stream ends."""
    from kfserving_tpu_torch.server.client import HTTPClient as Client

    model_dir = os.path.join(str(tmp_path), "gen")
    os.makedirs(model_dir)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump({"architecture": "decoder_tiny",
                   "arch_kwargs": {"num_layers": 2, "hidden_size": 64,
                                   "num_heads": 2, "intermediate_size": 128,
                                   "max_seq": 64},
                   "max_slots": 2, "max_seq": 64, "prefill_buckets": [16, 64],
                   "max_new_tokens": 8, "tokenizer": "byte"}, f)
    orch = _orchestrator("torch")
    c = controller.Controller(orch)
    r = router.IngressRouter(c)
    await r.start_async()
    try:
        await c.apply(spec.InferenceService(
            name="gen", predictor=spec.PredictorSpec(
                framework="generative", storage_uri=f"file://{model_dir}")))
        replica = orch.replicas("default/gen/predictor")[0]
        body = json.dumps({"text_input": "hello", "max_tokens": 6}).encode()
        client = Client(timeout=30, keepalive=False)
        streams = {}
        for key, host in (("router", f"127.0.0.1:{r.http_port}"),
                          ("replica", replica.host)):
            resp = await client.open(
                "POST", f"http://{host}/v2/models/gen/generate_stream", body)
            assert resp.status == 200
            assert resp.headers["content-type"].startswith(
                "text/event-stream")
            streams[key] = (b"".join([c async for c in resp.iter_chunks()]),
                            resp.headers)
        events = [json.loads(line[6:]) for line in
                  streams["router"][0].decode().splitlines()
                  if line.startswith("data: ")]
        assert events and events[-1]["finish_reason"] == "length"
        assert streams["router"][0] == streams["replica"][0]
        assert streams["router"][1].get("x-kfs-revision")
        # The stream's close hook releases the gauges once the router
        # has written the last chunk, which may follow the client's read.
        for _ in range(100):
            if r.inflight["router/gen/predictor"] == 0 and \
                    not r._host_inflight:
                break
            await asyncio.sleep(0.05)
        assert r.inflight["router/gen/predictor"] == 0
        assert not r._host_inflight
    finally:
        await r.stop_async()
        await orch.shutdown()


async def test_no_cpu_fallback_when_the_card_is_missing(tmp_path):
    """The orchestrator's default device is the card: without one, the
    replica's build raises, the apply fails, and the router sheds."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda replicas would start")
    orch = orchestrator.InProcessOrchestrator()
    c = controller.Controller(orch)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        await c.apply(spec.InferenceService(
            name="m", predictor=spec.PredictorSpec(
                framework="jax",
                storage_uri=f"file://{_mlp_dir(tmp_path, 'm')}")))
    assert orch.replicas("default/m/predictor") == []
