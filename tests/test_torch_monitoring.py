"""The port's monitoring loop against the JAX package's, on the CPU: the
same request sequence under a fake clock gives the same flight-recorder
entries and pins, the same SLO reports and breach edges, and the same
drift / outlier verdicts; and the port's server wires it in
(``/v2/health/slo``, ``/debug/flightrecorder``, the shed pins).
"""

import asyncio
import json
import types

import numpy as np
import pytest
from torch_serving import MLP_CONFIG, arequest, load_models, serve, \
    write_artifact

from kfserving_tpu.observability import REGISTRY as JAX_REGISTRY
from kfserving_tpu.observability import monitoring as jax_monitoring
from kfserving_tpu.observability import profiling as jax_profiling
from kfserving_tpu.server.metrics import Metrics as JaxMetrics
from kfserving_tpu_torch.observability import REGISTRY, monitoring
from kfserving_tpu_torch.observability.profiling import TIMELINE
from kfserving_tpu_torch.server.metrics import Metrics

OBJECTIVES = {"m": {"latency_ms": 25, "target": 0.9},
              "e": {"error_target": 0.95}}


@pytest.fixture(autouse=True)
def _clean():
    REGISTRY.reset()
    TIMELINE.clear()
    jax_profiling.TIMELINE.clear()
    yield
    REGISTRY.reset()


def _requests(seed: int):
    """(model, status, latency_ms, tick_after) in order: healthy traffic,
    a slow phase that breaches the latency objective, failures on "e",
    sheds and a recovery."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(120):
        slow = 40 <= i < 80
        latency = float(rng.uniform(40, 90) if slow else
                        rng.uniform(1, 12))
        status = 200
        if i % 17 == 5:
            status = 504
        elif i % 23 == 7:
            status = 503
        out.append(("m", status, latency, i % 10 == 9))
        if i % 3 == 0:
            out.append(("e", 500 if 50 <= i < 70 else 200,
                        float(rng.uniform(1, 5)), False))
    return out


def _facades(monkeypatch):
    monkeypatch.setenv("KFS_SLO_OBJECTIVES", json.dumps(OBJECTIVES))
    monkeypatch.setenv("KFS_SLO_WINDOWS_S", "2,6")
    monkeypatch.setenv("KFS_FLIGHTRECORDER_SIZE", "64")
    monkeypatch.setenv("KFS_FLIGHTRECORDER_PINNED", "16")
    out = {}
    for key, pkg, metrics in (("jax", jax_monitoring, JaxMetrics),
                              ("torch", monitoring, Metrics)):
        server = types.SimpleNamespace(metrics=metrics(), request_hooks=[])
        facade = pkg.Monitoring(server)
        edges = []
        facade.slo.transition_listeners.append(
            lambda m, a, rates, _e=edges: _e.append((m, a, rates)))
        out[key] = (server, facade, edges)
    return out


def _strip(entry):
    return {k: v for k, v in entry.items() if k != "ts"}


def test_same_requests_same_pins_and_slo_reports(monkeypatch):
    """One request sequence through both facades, the SLO ticked at the
    same fake monotonic times: equal reports after every tick, equal
    breach edges, equal recorder dumps (ring, pins, filters)."""
    facades = _facades(monkeypatch)
    reports = {"jax": [], "torch": []}
    now = 1000.0
    for k, (model, status, latency, tick) in enumerate(_requests(0)):
        for key, (server, facade, _) in facades.items():
            server.metrics.observe_request(model, "predict", status,
                                           latency)
            facade.record_request(model, "predict", status, latency,
                                  trace_id=f"r{k}",
                                  stages={"infer": latency / 2})
        if tick:
            now += 0.5
            for key, (_, facade, _) in facades.items():
                reports[key].append(facade.slo.tick(now=now))
    assert reports["torch"] == reports["jax"]
    assert any(r["alerting"] for r in reports["torch"])
    port_edges, jax_edges = facades["torch"][2], facades["jax"][2]
    assert port_edges == jax_edges and port_edges
    for kwargs in ({}, {"pinned_only": True},
                   {"pin_type": "slo_"}, {"limit": 5}, {"limit": 0}):
        dumps = {key: facade.dump_flightrecorder(**kwargs)
                 for key, (_, facade, _) in facades.items()}
        for part in ("entries", "pinned"):
            assert [_strip(e) for e in dumps["torch"][part]] == \
                [_strip(e) for e in dumps["jax"][part]], (kwargs, part)
        assert dumps["torch"]["recorded"] == dumps["jax"]["recorded"]
        assert dumps["torch"]["pinned_total"] == \
            dumps["jax"]["pinned_total"]
    pinned = facades["torch"][1].dump_flightrecorder(pinned_only=True)
    reasons = {e["pinned"] for e in pinned["pinned"]}
    assert {"deadline_shed", "unavailable", "error"} <= reasons
    assert reasons & {"slo_breach", "slo_violation"}
    port_lines = [line for line in REGISTRY.render_lines(False)
                  if "flightrecorder" in line or "slo_" in line]
    jax_lines = [line for line in JAX_REGISTRY.render_lines(False)
                 if "flightrecorder" in line or "slo_" in line]
    assert port_lines == jax_lines and port_lines


def test_drift_and_outlier_monitors_equal_jax():
    """The same bus events give the same drift verdicts and outlier
    rates, alert states and gauges."""
    rng = np.random.default_rng(2)
    reference = rng.standard_normal((200, 4))
    events = []
    for i in range(40):
        shift = 0.0 if i < 20 else 1.5
        rows = rng.standard_normal((4, 4)) + shift
        events.append({"model": "d", "payload": json.dumps(
            {"instances": rows.tolist()}).encode()})
    events.append({"model": "d", "payload": b"not json"})
    events.append({"model": "x", "payload": events[0]["payload"]})
    results = {}
    for key, pkg in (("jax", jax_monitoring), ("torch", monitoring)):
        drift = pkg.DriftMonitor("d", reference, window=32, test_stride=4)
        outlier = pkg.OutlierMonitor("d", reference=reference, window=32,
                                     alert_rate=0.2)
        trace = []

        async def feed():
            for event in events:
                await drift(event)
                await outlier(event)
                trace.append((drift.alerting, outlier.alerting,
                              drift.last_result, outlier.flagged))

        asyncio.run(feed())
        results[key] = (trace, outlier.threshold, outlier.seen)
    assert results["torch"] == results["jax"]
    assert results["torch"][0][-1][0] and results["torch"][0][-1][1]
    lines = {key: [line for line in reg.render_lines(False)
                   if "drift_score" in line or "outlier_rate" in line
                   or "monitor_alert_state" in line]
             for key, reg in (("jax", JAX_REGISTRY), ("torch", REGISTRY))}
    assert lines["torch"] == lines["jax"] and lines["torch"]


async def _drive_server(server):
    port = server.http_port
    rows = {"instances": np.zeros((1, 64)).tolist()}
    statuses = []
    for headers in ({}, {"x-request-timeout-ms": "0.001"}, {}):
        statuses.append((await arequest(
            port, "POST", "/v1/models/mlp:predict", rows,
            headers=headers))[0])
    slo = json.loads((await arequest(port, "GET",
                                     "/v2/health/slo?refresh=1"))[2])
    pinned = json.loads((await arequest(
        port, "GET", "/debug/flightrecorder?pinned=1"))[2])
    filtered = json.loads((await arequest(
        port, "GET", "/debug/flightrecorder?pin_type=deadline&since_ts=0"
    ))[2])
    bad = (await arequest(port, "GET",
                          "/debug/flightrecorder?since_ts=nope"))[0]
    return statuses, slo, pinned, filtered, bad


def test_servers_answer_the_monitoring_routes_alike(tmp_path,
                                                    monkeypatch):
    """The JAX server and the port's, on the same requests: the same SLO
    report and the same pinned deadline shed (trace id, stages, status),
    the same filter answers and the same 400."""
    monkeypatch.setenv("KFS_SLO_OBJECTIVES",
                       json.dumps({"mlp": {"latency_ms": 5000}}))
    artifacts = {"mlp": write_artifact(str(tmp_path), "mlp", MLP_CONFIG)}
    out = {kind: asyncio.run(serve(kind, load_models(kind, artifacts),
                                   _drive_server))
           for kind in ("jax", "torch")}
    port, ref = out["torch"], out["jax"]
    assert port[0] == ref[0] == [200, 504, 200]
    assert port[1] == ref[1] and "mlp" in port[1]["models"]
    for dump_p, dump_j in ((port[2], ref[2]), (port[3], ref[3])):
        shed_p = [e for e in dump_p["pinned"]
                  if e["pinned"] == "deadline_shed"]
        shed_j = [e for e in dump_j["pinned"]
                  if e["pinned"] == "deadline_shed"]
        assert len(shed_p) == len(shed_j) == 1
        keys = ("model", "verb", "status", "pinned")
        assert {k: shed_p[0][k] for k in keys} == \
            {k: shed_j[0][k] for k in keys}
        assert set(shed_p[0]) == set(shed_j[0])
    assert port[4] == ref[4] == 400
