"""The port's incident engine against the JAX package's, on the CPU: the
same evidence gives the same ranked hypotheses, and the same trigger
sequence under a fake clock opens, attaches to and closes the same
incidents; through the port's server a detector pin opens one incident,
read back from ``/debug/incidents``.
"""

import asyncio
import json
import time

import numpy as np
import pytest
from torch_serving import MLP_CONFIG, arequest, load_models, serve, \
    write_artifact

from kfserving_tpu.observability import attribution as jax_attribution
from kfserving_tpu.observability import incidents as jax_incidents
from kfserving_tpu.observability import profiling as jax_profiling
from kfserving_tpu.observability.monitoring import (
    FlightRecorder as JaxFlightRecorder,
)
from kfserving_tpu_torch.observability import REGISTRY, attribution, \
    incidents
from kfserving_tpu_torch.observability.monitoring import FlightRecorder
from kfserving_tpu_torch.observability.profiling import TIMELINE
from kfserving_tpu_torch.reliability.faults import faults

T0 = 1.7e9
REQUEST_PINS = ("slo_breach", "slo_violation", "latency_outlier",
                "deadline_shed", "error", "unavailable")


@pytest.fixture(autouse=True)
def _clean():
    REGISTRY.reset()
    faults.reset()
    for mod in (attribution, jax_attribution):
        mod.clear()
    TIMELINE.clear()
    jax_profiling.TIMELINE.clear()
    yield
    REGISTRY.reset()
    faults.reset()


def _bundle(rng):
    """A seeded evidence bundle with every source the classifier reads."""
    def frames(level, jump):
        n = int(rng.integers(0, 12))
        return [[T0 + i, float(level + (jump if i >= n // 2 else 0.0)
                               + rng.uniform(0, 0.05))]
                for i in range(n)]

    history = [
        {"name": "kfserving_tpu_request_latency_ms_p99",
         "frames": frames(rng.uniform(5, 50), rng.uniform(0, 100))},
        {"name": "kfserving_tpu_batch_queue_wait_ms_p99",
         "frames": frames(rng.uniform(0, 30), rng.uniform(0, 50))},
        {"name": "kfserving_tpu_history_prefix_hit_ratio",
         "frames": frames(rng.uniform(0.1, 0.9), -rng.uniform(0, 0.5))}]
    pins = []
    for _ in range(int(rng.integers(0, 6))):
        latency = float(rng.uniform(1, 200))
        pins.append({
            "pinned": str(rng.choice(REQUEST_PINS + (
                "sanitizer_recompile", "eviction_storm"))),
            "latency_ms": latency,
            "status": int(rng.choice([200, 503, 504, 500])),
            "stages": {"decode": float(rng.uniform(0, 2)),
                       "infer": float(rng.uniform(0, latency))}})
    return {
        "history": history,
        "flightrecorder": {"pinned": pins},
        "consistency": {"attribution_device_ms": 10.0,
                        "timeline_device_ms": 12.0, "delta_ratio": 0.2},
        "cache": {"models": {"gen": {"paged": {
            "pool_occupancy_ratio": float(rng.uniform(0.5, 1.0))}}}},
        "router": {"brownout_levels": {"a": int(rng.integers(0, 3))}},
    }


@pytest.mark.parametrize("seed", range(6))
def test_same_evidence_same_hypotheses(seed):
    """Seeded bundles and trigger counts: the same ranked hypotheses, each
    with the same score, summary and evidence numbers."""
    rng = np.random.default_rng(seed)
    for _ in range(20):
        counts = {kind: int(rng.integers(0, 3)) for kind in (
            "slo_breach", "eviction_storm", "faultback_storm",
            "sanitizer", "failover", "trend")}
        bundle = _bundle(rng)
        assert incidents.classify(counts, bundle) == \
            jax_incidents.classify(counts, bundle)
    assert incidents.CAUSES == jax_incidents.CAUSES


def _manager(pkg, recorder):
    return pkg.IncidentManager(recorder=recorder, cooldown_s=30.0,
                               dedup_window_s=60.0, evidence_window_s=60.0,
                               tick_s=0.05, spool_dir="")


def test_same_triggers_same_incidents(monkeypatch):
    """Pins and SLO edges fed to both managers, drained at the same fake
    times (the wall clock pinned too): the same records (ids, keys, root
    causes, trigger counts, hypotheses, evidence) and the same closes
    after the cooldown."""
    clock = [T0]
    monkeypatch.setattr(time, "time", lambda: clock[0])
    runs = {}
    for key, pkg, rec_cls in (("jax", jax_incidents, JaxFlightRecorder),
                              ("torch", incidents, FlightRecorder)):
        recorder = rec_cls()
        mgr = _manager(pkg, recorder)
        recorder.add_pin_listener(mgr.on_pin)
        steps = [
            (1, {"pinned": "x", "sanitizer": "recompile",
                 "ts": T0 + 1}, "sanitizer_recompile"),
            (2, {"kind": "residency_eviction_storm", "ts": T0 + 2},
             "eviction_storm"),
            (3, {"model": "m", "latency_ms": 90.0, "status": 200,
                 "stages": {"infer": 80.0}, "ts": T0 + 3}, "slo_breach"),
            (4, {"kind": "trend", "series": "s", "labels": {"model": "m"},
                 "z": 9.0, "value": 3.0, "baseline": 1.0,
                 "slope_per_s": 0.1, "ts": T0 + 4}, "trend_s"),
            (5, {"latency_ms": 5.0, "ts": T0 + 5}, "latency_outlier"),
        ]
        report = []

        async def drive():
            for t, entry, pin in steps:
                clock[0] = T0 + t
                recorder.record(entry, pin=pin)
                if t == 3:
                    mgr.on_slo_transition("m", True, {"latency": {"6": 9}})
                await mgr.drain(now=T0 + t)
                report.append(mgr.report())
            clock[0] = T0 + 20
            mgr.on_slo_transition("m", False, {})
            await mgr.drain(now=T0 + 20)
            report.append(mgr.report())
            await mgr.drain(now=T0 + 60)   # past the cooldown
            report.append(mgr.report())

        asyncio.run(drive())
        ids = [i["id"] for i in mgr.list()]
        runs[key] = (report, [mgr.get(i) for i in ids])
    assert runs["torch"] == runs["jax"]
    report, records = runs["torch"]
    assert report[2]["open"] == 2 and report[-1]["open"] == 0
    by_key = {r["key"]: r for r in records}
    assert by_key["_server"]["root_cause"] in (
        "eviction_thrash", "recompile_host_sync")
    assert by_key["_server"]["trigger_counts"] == {
        "sanitizer": 1, "eviction_storm": 1}
    assert by_key["m"]["trigger_counts"] == {"slo_breach": 1, "trend": 1}
    assert all(r["state"] == "closed" for r in records)


async def _drive_pin(server):
    port = server.http_port
    server.monitoring.flight_recorder.record(
        {"sanitizer": "forbidden_transfer", "source": "test"},
        pin="sanitizer_forbidden_transfer")
    for _ in range(100):
        listing = json.loads((await arequest(port, "GET",
                                             "/debug/incidents"))[2])
        if listing["open"]:
            break
        await asyncio.sleep(0.02)
    incident_id = listing["incidents"][0]["id"]
    record = json.loads((await arequest(
        port, "GET", f"/debug/incidents?id={incident_id}"))[2])
    missing = (await arequest(port, "GET", "/debug/incidents?id=nope"))[0]
    bad = (await arequest(port, "GET", "/debug/incidents?limit=x"))[0]
    return listing, record, missing, bad, server.incidents


def test_a_pin_opens_one_incident_through_the_port_server(tmp_path,
                                                          monkeypatch):
    """A sanitizer pin in the server's flight recorder opens one
    incident, listed and read back by id with its evidence bundle; an
    injected observability.incident_open failure is counted; incidents
    off answers {"enabled": false}."""
    monkeypatch.setenv("KFS_INCIDENT_TICK_S", "0.02")
    faults.configure({"observability.incident_open": {"fail_first": 1}})
    artifacts = {"mlp": write_artifact(str(tmp_path), "mlp", MLP_CONFIG)}

    async def twice(server):
        # The first trigger's diagnosis hits the injected failure.
        server.monitoring.flight_recorder.record({}, pin="eviction_storm")
        await asyncio.sleep(0.1)
        return await _drive_pin(server)

    listing, record, missing, bad, mgr = asyncio.run(
        serve("torch", load_models("torch", artifacts), twice))
    assert listing["open"] == 1 and listing["total_opened"] == 1
    assert listing["incidents"][0]["root_cause"] == "recompile_host_sync"
    assert record["trigger_counts"] == {"sanitizer": 1}
    assert record["key"] == "_server" and record["state"] == "open"
    assert {"window", "flightrecorder", "timeline", "attribution",
            "cache", "consistency", "sources"} <= set(record["evidence"])
    assert (missing, bad) == (404, 400)
    failures = {labels["reason"]: child.value for labels, child in
                REGISTRY.counter(
                    "kfserving_tpu_incident_failures_total").samples()}
    assert failures == {"error": 1}
    monkeypatch.setenv("KFS_INCIDENTS", "0")

    async def off(server):
        return json.loads((await arequest(server.http_port, "GET",
                                          "/debug/incidents"))[2])

    assert asyncio.run(serve("torch", load_models("torch", artifacts),
                             off)) == {"enabled": False, "open": 0,
                                       "incidents": []}
