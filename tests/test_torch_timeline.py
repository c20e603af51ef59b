"""The port's engine event timeline against the JAX package's, on the CPU:
the same recorded events give the same ring, Chrome trace, fleet merge
and summary in both packages; the port's generator (paged with chunked
prefill, and n-gram speculative) records only the JAX generator's event
names on its tracks, one device event per fetched dispatch, with the
requests' trace ids; the port's predict engine records the JAX engine's
events for the same requests.
"""

import asyncio
import contextvars
import json
import re

import numpy as np
import pytest
from torch_generation import MAX_SEQ, RNG_SEED, TinyDecoder
from torch_serving import MLP_CONFIG, arequest, write_artifact

import kfserving_tpu
from kfserving_tpu.observability import profiling as jax_profiling
from kfserving_tpu.predictors.jax_model import JaxModel
from kfserving_tpu_torch import tracing
from kfserving_tpu_torch.engine.generator import GenerationEngine
from kfserving_tpu_torch.observability import profiling
from kfserving_tpu_torch.observability.profiling import TIMELINE
from kfserving_tpu_torch.predictors.torch_model import TorchModel

TRACKS = ("host", "device", "slot", "counter")
NAMES = ("decode.wave", "prefill.chunk", "prefill.bucket", "preempt",
         "wave.suppressed", "hold", "cache.hit", "spec.verify")


def _events(seed: int, n: int):
    """A seeded event sequence: (track, name, dur_s, trace_id, slot,
    t_end, attrs) with instants, spans, counters and slotless events."""
    rng = np.random.default_rng(seed)
    t = 1.7e9
    out = []
    for i in range(n):
        t += float(rng.uniform(0.0, 0.02))
        track = TRACKS[int(rng.integers(len(TRACKS)))]
        if track == "counter":
            out.append((track, "pool", 0.0, None, -1, t,
                        {"free_blocks": int(rng.integers(64)),
                         "active_slots": int(rng.integers(8)),
                         "engine": "gen"}))
            continue
        dur = 0.0 if rng.random() < 0.3 else float(rng.uniform(0, 0.03))
        slot = int(rng.integers(4)) if track == "slot" else -1
        trace = None if rng.random() < 0.4 else f"t{int(rng.integers(9))}"
        attrs = None if rng.random() < 0.5 else {"k": i, "w": 0.5 * i}
        out.append((track, NAMES[int(rng.integers(len(NAMES)))], dur,
                    trace, slot, t, attrs))
    return out


def _record(timeline, events):
    for track, name, dur, trace, slot, t_end, attrs in events:
        if track == "counter":
            timeline.record(track, name, t_end=t_end, attrs=attrs)
        else:
            timeline.record(track, name, dur_s=dur, trace_id=trace,
                            slot=slot, t_end=t_end, attrs=attrs)


@pytest.mark.parametrize("seed,n,capacity", [(0, 200, 8192), (1, 300, 64)])
def test_same_events_same_trace_and_summary(seed, n, capacity):
    """The ring (overwriting oldest-first past its capacity), its window
    view, event dicts, the Chrome trace, the merge of two replicas and
    the summary equal the JAX package's."""
    events = _events(seed, n)
    port = profiling.EngineTimeline(capacity)
    ref = jax_profiling.EngineTimeline(capacity)
    _record(port, events)
    _record(ref, events)
    assert port.snapshot() == ref.snapshot()
    assert port.recorded == ref.recorded == n
    assert len(port.snapshot()) == min(n, port.capacity)
    last = events[-1][5]
    assert port.snapshot(window_s=1.0, now=last) == \
        ref.snapshot(window_s=1.0, now=last)
    assert port.window(last - 2.0, last, limit=32) == \
        ref.window(last - 2.0, last, limit=32)
    snap = port.snapshot()
    assert json.dumps(profiling.to_chrome_trace(snap, pid=3)) == \
        json.dumps(jax_profiling.to_chrome_trace(snap, pid=3))
    traces = [("a", profiling.to_chrome_trace(snap[:40])),
              ("b", profiling.to_chrome_trace(snap[40:]))]
    assert profiling.merge_traces(traces) == \
        jax_profiling.merge_traces(traces)
    assert profiling.summarize(snap) == jax_profiling.summarize(snap)
    assert profiling.summarize(snap)["decode_waves"] == sum(
        1 for e in snap if e[2] == "device" and e[3] == "decode.wave")


def _jax_generator_events():
    """(track, name) pairs the JAX generator records, read off its
    source."""
    path = kfserving_tpu.__path__[0] + "/engine/generator.py"
    with open(path) as f:
        src = f.read()
    pairs = set(re.findall(
        r'TIMELINE\.record\(\s*"(\w+)",\s*"([\w.]+)"', src))
    pairs |= {("counter", n)
              for n in re.findall(r'TIMELINE\.counter\("(\w+)"', src)}
    return pairs


@pytest.fixture(scope="module")
def tiny():
    ref = TinyDecoder()
    return ref, ref.port()


async def _run_traced(eng, prompts, budget, **kw):
    """One request per prompt, each submitted under its own trace id."""
    async def one(i, p):
        tracing.current_request_id.set(f"trace-{i}")
        return await eng.complete(p, max_new_tokens=budget, **kw)

    try:
        return await asyncio.wait_for(asyncio.gather(*[
            asyncio.get_running_loop().create_task(
                one(i, p), context=contextvars.copy_context())
            for i, p in enumerate(prompts)]), timeout=120)
    finally:
        await eng.close()


@pytest.mark.parametrize("mode", ["paged_chunked", "ngram"])
def test_generator_records_the_jax_events(tiny, mode):
    """Every event the port's generator records is one the JAX generator
    records, on the same track; one device event per fetched wave,
    prefill and chunk; slot events carry the requests' trace ids."""
    _ref, port = tiny
    rng = np.random.default_rng(5)
    shared = [int(t) for t in rng.integers(1, 96, 40)]
    kw = dict(max_slots=3, max_seq=MAX_SEQ, block_size=16,
              steps_per_call=2, rng_seed=RNG_SEED)
    if mode == "paged_chunked":
        kw.update(prefill_buckets=[16, 32, 64], prefill_chunk_tokens=32,
                  cache_blocks=14)
        prompts = [shared + [3, 4], shared + [5], [7, 8, 9],
                   [int(t) for t in rng.integers(1, 96, 70)], [1, 2]]
    else:
        kw.update(prefill_buckets=[16, 32, 64], speculative={"tokens": 3})
        prompts = [([5, 9, 2, 7] * 8)[:n] for n in (12, 20, 25)]
    TIMELINE.clear()
    eng = GenerationEngine(port, **kw)
    asyncio.run(_run_traced(eng, prompts, 10))
    events = TIMELINE.snapshot()
    seen = {(e[2], e[3]) for e in events}
    assert seen <= _jax_generator_events(), \
        seen - _jax_generator_events()
    count = {}
    for e in events:
        count[(e[2], e[3])] = count.get((e[2], e[3]), 0) + 1
    assert count.get(("device", "prefill.bucket"), 0) == eng.prefills
    assert count.get(("device", "prefill.chunk"), 0) == \
        eng.prefill_chunks
    if mode == "ngram":
        assert count[("device", "spec.verify")] == eng.spec_waves > 0
        assert count[("host", "spec.draft")] == eng.spec_waves
    else:
        assert eng.prefill_chunks > 0 and ("host", "cache.hit") in seen
        assert count[("device", "decode.wave")] * eng.steps_per_call == \
            eng._token_steps
    ids = {f"trace-{i}" for i in range(len(prompts))}
    for e in events:
        if e[2] == "slot":
            assert e[4] in ids and e[5] >= 0, e
        assert e[1] >= 0.0
    assert ("counter", "pool") in seen
    summary = profiling.summarize(events)
    assert summary["prefill_dispatches"] == eng.prefills


def test_predict_engine_records_the_jax_events(tmp_path):
    """The same predicts through the JAX and the port's mlp: the same
    engine.execute, compile.miss and batch.flush events (names, tracks,
    attribute keys, order)."""
    model_dir = write_artifact(str(tmp_path), "mlp", MLP_CONFIG)
    rows = np.random.default_rng(0).standard_normal((4, 64)).tolist()
    out = {}
    for kind, cls, timeline in (
            ("jax", JaxModel, jax_profiling.TIMELINE),
            ("torch", TorchModel, TIMELINE)):
        model = (cls("mlp", model_dir) if kind == "jax"
                 else cls("mlp", model_dir, device="cpu"))
        model.load()
        timeline.clear()
        try:
            async def drive():
                for n in (1, 3, 1):
                    await model.predict({"instances": rows[:n]})

            asyncio.run(drive())
        finally:
            model.unload()
        out[kind] = [(e[2], e[3], sorted(e[6] or {}))
                     for e in timeline.snapshot()]
    assert out["torch"] == out["jax"]
    names = [e[1] for e in out["torch"]]
    assert names.count("engine.execute") >= names.count("batch.flush") == 3
    assert ("host", "compile.miss", ["shape"]) in out["torch"]


async def _drive_profile_routes(server):
    port = server.http_port
    rows = {"instances": np.zeros((2, 64)).tolist()}
    await arequest(port, "POST", "/v1/models/mlp:predict", rows)
    out = {"trace": json.loads((await arequest(
        port, "GET", "/debug/profile?window_s=60"))[2])}
    out["events"] = json.loads((await arequest(
        port, "GET", "/debug/profile?format=events"))[2])
    out["bad"] = [(await arequest(port, "GET", path))[0] for path in (
        "/debug/profile?window_s=x", "/debug/profile?format=xml")]
    log_dir = server.profile_dir
    calls = [("POST", "/debug/profiler/start", {"log_dir": log_dir}),
             ("POST", "/debug/profiler/start", {"log_dir": log_dir}),
             ("POST", "/v1/models/mlp:predict", rows),
             ("POST", "/debug/profile/capture", {"duration_s": 0.1}),
             ("POST", "/debug/profiler/stop", None),
             ("POST", "/debug/profiler/stop", None),
             ("POST", "/debug/profile/capture",
              {"duration_s": 0.1, "log_dir": log_dir}),
             ("POST", "/debug/profile/capture", {"duration_s": "x"})]
    out["profiler"] = []
    for method, path, body in calls:
        status, _, raw = await arequest(port, method, path, body)
        out["profiler"].append((path, status, json.loads(raw)))
    return out


def test_profile_and_profiler_routes(tmp_path):
    """GET /debug/profile serves the timeline as Chrome-trace JSON (the
    predict's engine.execute on the device track) or as event dicts; the
    torch.profiler routes start, refuse a second start with 409, stop
    into a Chrome trace, 409 when idle, and capture a bounded window."""
    from kfserving_tpu_torch.server.app import ModelServer

    model_dir = write_artifact(str(tmp_path), "mlp", MLP_CONFIG)
    model = TorchModel("mlp", model_dir, device="cpu")
    model.load()
    TIMELINE.clear()

    async def run():
        server = ModelServer(http_port=0)
        server.profile_dir = str(tmp_path / "prof")
        await server.start_async([model], host="127.0.0.1")
        try:
            return await _drive_profile_routes(server)
        finally:
            await server.stop_async()

    try:
        out = asyncio.run(run())
    finally:
        model.unload()
    trace = out["trace"]
    assert trace["displayTimeUnit"] == "ms"
    executes = [e for e in trace["traceEvents"]
                if e.get("name") == "engine.execute"]
    assert executes and executes[0]["tid"] == 2 and \
        executes[0]["ph"] == "X"
    assert out["events"]["recorded"] >= len(out["events"]["events"]) > 0
    assert out["bad"] == [400, 400]
    statuses = [(path.rsplit("/", 1)[1], status)
                for path, status, _ in out["profiler"]]
    assert statuses == [("start", 200), ("start", 409), ("mlp:predict", 200),
                        ("capture", 409), ("stop", 200), ("stop", 409),
                        ("capture", 200), ("capture", 400)]
    stopped = out["profiler"][4][2]
    captured = out["profiler"][6][2]
    for body in (stopped, captured):
        with open(body["trace"]) as f:
            chrome = json.load(f)
        assert chrome["traceEvents"]
        assert body["trace"].startswith(str(tmp_path / "prof"))
    assert captured["captured"] and captured["duration_s"] == 0.1
