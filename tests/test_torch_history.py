"""The port's telemetry history against the JAX package's, on the CPU: the
same registry updates ticked at the same fake times give the same series
catalog, frames, synthetic ratios and change points (pins, counters,
slope gauges) in both packages; the port's server serves
``/debug/history`` as the JAX server does, and an injected
``observability.history_tick`` failure is counted, not raised.
"""

import asyncio
import json

import numpy as np
import pytest
from torch_serving import MLP_CONFIG, arequest, load_models, serve, \
    write_artifact

from kfserving_tpu.observability import REGISTRY as JAX_REGISTRY
from kfserving_tpu.observability import history as jax_history
from kfserving_tpu.observability.monitoring import (
    FlightRecorder as JaxFlightRecorder,
)
from kfserving_tpu.observability.registry import Registry as JaxRegistry
from kfserving_tpu_torch.observability import REGISTRY, history
from kfserving_tpu_torch.observability.monitoring import FlightRecorder
from kfserving_tpu_torch.observability.registry import Registry
from kfserving_tpu_torch.reliability.faults import faults

T0 = 1.7e9


@pytest.fixture(autouse=True)
def _clean():
    REGISTRY.reset()
    faults.reset()
    yield
    REGISTRY.reset()
    faults.reset()


def _setup(pkg, registry_cls, recorder_cls):
    reg = registry_cls()
    store = pkg.HistoryStore(tick_s=1.0, tiers=[(1.0, 40), (5.0, 10)])
    recorder = recorder_cls()
    detector = pkg.TrendDetector(store, recorder=recorder,
                                 min_samples=8, breach_ticks=2,
                                 cooldown_s=5.0, window_s=20.0)
    sampler = pkg.HistorySampler(store=store, registries=[reg],
                                 tick_s=1.0, detector=detector)
    return reg, sampler, recorder


def _drive(reg, sampler, seed: int, ticks: int):
    """Seeded request, lookup, gauge and latency updates, one tick a
    second; latency steps up at tick 30 (a change point)."""
    rng = np.random.default_rng(seed)
    total = reg.counter("kfserving_tpu_request_total")
    lat = reg.histogram("kfserving_tpu_request_latency_ms")
    lookups = reg.counter("kfserving_tpu_generator_prefix_lookups_total")
    gauge = reg.gauge("kfserving_tpu_generator_pool_occupancy_ratio")
    for t in range(ticks):
        for _ in range(int(rng.integers(5, 15))):
            status = "500" if rng.random() < 0.1 else "200"
            total.labels(model="m", verb="predict", status=status).inc()
            base = 80.0 if t >= 30 else 8.0
            lat.labels(model="m", verb="predict").observe(
                float(base + rng.uniform(0, 4)))
        lookups.labels(model="g", outcome=("hit", "miss", "host_hit")[
            t % 3]).inc(int(rng.integers(1, 6)))
        gauge.labels(model="g").set(float(rng.uniform(0.2, 0.9)))
        if t == ticks - 1:
            gauge.prune(model="g")   # a pruned child's series goes
        sampler.tick(now=T0 + t)


def test_same_ticks_same_frames_and_changepoints():
    """Catalog, aligned and resampled frames from both tiers, the pinned
    trend entries, the change-point count and the exported trend gauges
    equal the JAX package's."""
    runs = {}
    for key, pkg, reg_cls, rec_cls in (
            ("jax", jax_history, JaxRegistry, JaxFlightRecorder),
            ("torch", history, Registry, FlightRecorder)):
        reg, sampler, recorder = _setup(pkg, reg_cls, rec_cls)
        _drive(reg, sampler, seed=4, ticks=60)
        store = sampler.store
        runs[key] = {
            "index": store.index(),
            "all": store.query(window_s=40, now=T0 + 59),
            "coarse": store.query(window_s=60, now=T0 + 59),
            "resampled": store.query(
                series="kfserving_tpu_request_latency_ms_p99",
                labels={"model": "m"}, window_s=30, step_s=3.0,
                now=T0 + 59),
            "latest": store.latest("kfserving_tpu_history_error_ratio",
                                   {"model": "m"}),
            "pins": recorder.dump(pinned_only=True)["pinned"],
            "changepoints": sampler.detector.changepoints,
            "ticks": sampler.ticks,
        }
    assert runs["torch"] == runs["jax"]
    trend = {key: [line for line in reg.render_lines(False)
                   if "trend_" in line]
             for key, reg in (("jax", JAX_REGISTRY), ("torch", REGISTRY))}
    assert trend["torch"] == trend["jax"] and trend["torch"]
    names = {s["name"] for s in runs["torch"]["index"]}
    assert {"kfserving_tpu_history_error_ratio",
            "kfserving_tpu_history_prefix_hit_ratio",
            "kfserving_tpu_request_latency_ms_p99",
            "kfserving_tpu_request_total"} <= names
    assert "kfserving_tpu_generator_pool_occupancy_ratio" not in names
    assert runs["torch"]["changepoints"] >= 1
    assert any(p["pinned"] == "trend_kfserving_tpu_request_latency_ms_p99"
               for p in runs["torch"]["pins"])


async def _drive_server(server):
    port = server.http_port
    rows = {"instances": np.zeros((1, 64)).tolist()}
    for _ in range(3):
        await arequest(port, "POST", "/v1/models/mlp:predict", rows)
        await asyncio.sleep(0.06)
    answers = []
    for path in ("/debug/history?index=1",
                 "/debug/history?series=kfserving_tpu_request_total"
                 "&window_s=60",
                 "/debug/history?window_s=nope",
                 "/debug/history?step_s=-1",
                 "/debug/history?labels=model"):
        status, _, body = await arequest(port, "GET", path)
        answers.append((status, json.loads(body)))
    return answers


def test_servers_answer_the_history_route_alike(tmp_path, monkeypatch):
    """The JAX server and the port's, ticking every 20 ms on the same
    requests: the request families in the catalog, rate frames for the
    request counter, the same 400s."""
    monkeypatch.setenv("KFS_HISTORY_TICK_S", "0.02")
    artifacts = {"mlp": write_artifact(str(tmp_path), "mlp", MLP_CONFIG)}
    out = {kind: asyncio.run(serve(kind, load_models(kind, artifacts),
                                   _drive_server))
           for kind in ("jax", "torch")}
    for kind, answers in out.items():
        (s_index, index), (s_series, series) = answers[:2]
        assert s_index == s_series == 200 and index["enabled"], kind
        names = {s["name"] for s in index["series"]}
        assert "kfserving_tpu_request_total" in names
        assert "kfserving_tpu_request_latency_ms_p99" in names
        assert series["series"] and all(
            s["kind"] == "rate" for s in series["series"])
        assert [a[0] for a in answers[2:]] == [400, 400, 400]
    assert set(out["torch"][0][1]) == set(out["jax"][0][1])
    assert [a[1] for a in out["torch"][2:]] == \
        [a[1] for a in out["jax"][2:]]


def test_history_tick_fault_is_counted_and_history_off(tmp_path,
                                                       monkeypatch):
    """observability.history_tick failing its first two probes: the
    failures are counted and ticking goes on; KFS_HISTORY=0 answers
    {"enabled": false}."""
    monkeypatch.setenv("KFS_HISTORY_TICK_S", "0.02")
    faults.configure({"observability.history_tick": {"fail_first": 2}})
    artifacts = {"mlp": write_artifact(str(tmp_path), "mlp", MLP_CONFIG)}

    async def drive(server):
        await asyncio.sleep(0.3)
        return (server.history.failures, server.history.ticks,
                (await arequest(server.http_port, "GET", "/metrics"))[2])

    failures, ticks, scrape = asyncio.run(
        serve("torch", load_models("torch", artifacts), drive))
    assert failures == 2 and ticks >= 2
    assert "kfserving_tpu_history_tick_failures_total 2" in scrape.decode()
    monkeypatch.setenv("KFS_HISTORY", "0")

    async def off(server):
        return json.loads((await arequest(server.http_port, "GET",
                                          "/debug/history"))[2])

    assert asyncio.run(serve("torch", load_models("torch", artifacts),
                             off)) == {"enabled": False, "series": []}
