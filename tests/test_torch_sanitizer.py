"""The port's device-discipline sanitizer (``KFS_SANITIZE=1``) on the CPU:
a capture after a source's declared warmup through the port's compile
cache is a ``recompile`` violation, as in the JAX package; the stall
watchdog pins a blocked loop; the transfer guard (a torch function mode)
raises on its own thread for every implicit transfer kind and is silent
on another thread and inside ``sanctioned_fetch``; off, it enters no
mode and starts no thread.  Through the port's server a sanitized
decoder_tiny generates with zero violations, then a forbidden transfer on
the loop counts, pins and opens an incident.
"""

import asyncio
import json
import operator
import threading
import time

import pytest
import torch
from torch_serving import arequest, write_artifact

from kfserving_tpu.engine import compile_cache as jax_compile_cache
from kfserving_tpu.observability.monitoring import (
    FlightRecorder as JaxFlightRecorder,
)
from kfserving_tpu.reliability import sanitizer as jax_sanitizer
from kfserving_tpu_torch.engine import compile_cache
from kfserving_tpu_torch.observability import REGISTRY
from kfserving_tpu_torch.observability.monitoring import FlightRecorder
from kfserving_tpu_torch.reliability import sanitizer


@pytest.fixture
def sanitized(monkeypatch):
    monkeypatch.setenv("KFS_SANITIZE", "1")
    for mod in (sanitizer, jax_sanitizer):
        mod.reset()
    REGISTRY.reset()
    yield
    for mod in (sanitizer, jax_sanitizer):
        mod.reset()
    REGISTRY.reset()


def _strip(entries):
    return [{k: v for k, v in e.items() if k != "ts"} for e in entries]


def test_recompile_after_declared_warmup_as_jax(sanitized):
    """The same notes and declarations through both compile caches: the
    same violations, pins and status (pre-warmup notes and other
    sources are not flagged)."""
    out = {}
    for key, cache, san, rec_cls in (
            ("jax", jax_compile_cache, jax_sanitizer, JaxFlightRecorder),
            ("torch", compile_cache, sanitizer, FlightRecorder)):
        recorder = rec_cls()
        san.attach_flight_recorder(recorder)
        cache.note_compilation("eng", ("decode", 8, 16))
        cache.declare_warmup_complete("eng")
        cache.note_compilation("eng", ("decode", 8, 16, True))
        cache.note_compilation("other", ("b", 4))
        status = san.status()
        out[key] = (san.violations(),
                    _strip(recorder.dump(pinned_only=True)["pinned"]),
                    status["warmed_sources"], status["violations"])
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == {"recompile": 1}
    assert out["torch"][1][0]["source"] == "eng"


def test_stall_watchdog_pins_a_blocked_loop(sanitized, monkeypatch):
    monkeypatch.setenv("KFS_SANITIZE_STALL_MS", "60")
    recorder = FlightRecorder()
    sanitizer.attach_flight_recorder(recorder)

    async def run():
        wd = sanitizer.start_watchdog(asyncio.get_running_loop())
        assert wd is not None
        assert sanitizer.start_watchdog(asyncio.get_running_loop()) is None
        await asyncio.sleep(0.1)
        # kfslint: disable=async-blocking — the stall under test.
        time.sleep(0.3)
        await asyncio.sleep(0.1)
        sanitizer.stop_watchdog()
        return wd.stalls

    assert asyncio.run(run()) == 1   # one violation per stall episode
    assert sanitizer.violations() == {"loop_stall": 1}
    entry = recorder.dump(pinned_only=True)["pinned"][0]
    assert entry["pinned"] == "sanitizer_loop_stall"
    assert entry["stall_ms"] >= 60 and entry["threshold_ms"] == 60


T = torch.ones(3)
TO_HOST = [
    ("item", lambda: T[0].item()), ("tolist", lambda: T.tolist()),
    ("cpu", lambda: T.cpu()), ("numpy", lambda: T.numpy()),
    ("bool", lambda: bool(T[0])),
    ("int", lambda: int(T[0])), ("float", lambda: float(T[0])),
    ("index", lambda: operator.index(torch.tensor(2))),
    ("nonzero", lambda: T.nonzero()), ("torch.nonzero",
                                       lambda: torch.nonzero(T))]
# Moves onto a device of the guarded type: "meta" stands in for the card
# (a move off it takes the same branch).
TO_DEVICE = [
    ("to", lambda: T.to("meta")),
    ("to_device_kw", lambda: T.to(device=torch.device("meta"))),
    ("copy_", lambda: torch.empty(3, device="meta").copy_(T)),
    ("tensor", lambda: torch.tensor([1.0], device="meta")),
    ("as_tensor", lambda: torch.as_tensor([1.0], device="meta"))]


@pytest.mark.parametrize("device_type,name,op",
                         [("cpu",) + c for c in TO_HOST]
                         + [("meta",) + c for c in TO_DEVICE])
def test_guard_raises_on_its_thread(sanitized, device_type, name, op):
    """Each implicit transfer kind raises under the guard, is counted
    once and pinned; the same op passes on another thread and inside
    sanctioned_fetch."""
    recorder = FlightRecorder()
    sanitizer.attach_flight_recorder(recorder)
    with pytest.raises(sanitizer.ForbiddenTransfer, match="disallowed"):
        with sanitizer.loop_guard("test", device_type):
            op()
    assert sanitizer.violations() == {"forbidden_transfer": 1}
    assert [e["pinned"] for e in recorder.dump(pinned_only=True)[
        "pinned"]] == ["sanitizer_forbidden_transfer"]
    errors = []
    with sanitizer.loop_guard("test", device_type):
        with sanitizer.sanctioned_fetch():
            op()
        other = threading.Thread(target=lambda: errors.append(
            _try(op)))
        other.start()
        other.join(timeout=10)
        assert not other.is_alive()
        # Host work that moves nothing passes under the guard.
        (T * 2).sum()
        T.to(torch.float64)
    assert errors == [None]
    assert sanitizer.violations() == {"forbidden_transfer": 1}


def _try(op):
    try:
        op()
    except Exception as e:   # the other thread must see none
        return e
    return None


def test_nested_guards_disarm_in_completion_order(sanitized):
    """Two scopes on one thread (two engines on one loop), exiting in
    completion order: the guard stays armed until the last exits."""
    a, b = sanitizer.loop_guard("a", "cpu"), sanitizer.loop_guard("b", "cpu")
    a.__enter__()
    b.__enter__()
    a.__exit__(None, None, None)
    assert sanitizer.guard_active()
    with pytest.raises(sanitizer.ForbiddenTransfer):
        T.tolist()
    b.__exit__(None, None, None)
    assert not sanitizer.guard_active()
    assert T.tolist() == [1.0, 1.0, 1.0]
    assert sanitizer.status()["guard"] == {"armed_threads": 0, "arms": 1}


def test_off_is_a_no_op(monkeypatch):
    """KFS_SANITIZE unset: no torch function mode is entered, no
    watchdog thread starts, nothing is counted."""
    monkeypatch.delenv("KFS_SANITIZE", raising=False)
    sanitizer.reset()
    depth = torch._C._len_torch_function_stack()
    threads = {t.name for t in threading.enumerate()}
    with sanitizer.loop_guard("off", "cpu"):
        assert torch._C._len_torch_function_stack() == depth
        assert T[0].item() == 1.0
        with sanitizer.sanctioned_fetch():
            pass
    compile_cache.declare_warmup_complete("off")
    compile_cache.note_compilation("off", ("x",))

    async def start():
        return sanitizer.start_watchdog(asyncio.get_running_loop())

    assert asyncio.run(start()) is None
    assert {t.name for t in threading.enumerate()} == threads
    assert sanitizer.violations() == {}
    assert sanitizer.status()["warmed_sources"] == []


GEN_CONFIG = {"architecture": "decoder_tiny",
              "arch_kwargs": dict(num_layers=2, hidden_size=64, num_heads=2,
                                  intermediate_size=128, max_seq=128),
              "max_slots": 2, "max_seq": 128, "prefill_buckets": [32, 128],
              "block_size": 16, "cache_blocks": 16, "steps_per_call": 2,
              "tokenizer": "byte"}


def test_sanitized_server_generates_clean_then_pins_a_transfer(
        sanitized, tmp_path, monkeypatch):
    """A port server with KFS_SANITIZE=1: two generations leave zero
    violations and show the guard armed in the ready probe; then .item()
    under loop_guard on the server's loop raises, counts one
    forbidden_transfer, pins it and opens one incident."""
    from kfserving_tpu_torch.predictors.llm import GenerativeModel
    from kfserving_tpu_torch.server.app import ModelServer

    monkeypatch.setenv("KFS_SANITIZE_STALL_MS", "5000")
    monkeypatch.setenv("KFS_INCIDENT_TICK_S", "0.02")
    model = GenerativeModel("gen", write_artifact(str(tmp_path), "gen",
                                                  GEN_CONFIG),
                            device="cpu")
    model.load()

    async def run():
        server = ModelServer(http_port=0)
        await server.start_async([model], host="127.0.0.1")
        port = server.http_port
        try:
            for body in ({"text_input": "hello there", "max_tokens": 5},
                         {"text_input": "hello again", "max_tokens": 7,
                          "stream": True}):
                status, _, _ = await arequest(
                    port, "POST", "/v2/models/gen/generate", body)
                assert status == 200
            ready = json.loads((await arequest(
                port, "GET", "/v2/health/ready"))[2])
            with pytest.raises(sanitizer.ForbiddenTransfer):
                with sanitizer.loop_guard("probe", "cpu"):
                    torch.ones(2).sum().item()
            for _ in range(100):
                listing = json.loads((await arequest(
                    port, "GET", "/debug/incidents"))[2])
                if listing["open"]:
                    break
                await asyncio.sleep(0.02)
            pinned = json.loads((await arequest(
                port, "GET", "/debug/flightrecorder?pinned=1"))[2])
            metrics = (await arequest(port, "GET", "/metrics"))[2].decode()
            return ready, listing, pinned, metrics
        finally:
            await server.stop_async()
            await model.engine.close()

    ready, listing, pinned, metrics = asyncio.run(run())
    block = ready["sanitizer"]
    assert block["enabled"] and block["watchdog"]
    assert block["violations"] == {} and block["guard"]["arms"] >= 1
    assert listing["open"] == 1
    assert listing["incidents"][0]["root_cause"] == "recompile_host_sync"
    assert [e["pinned"] for e in pinned["pinned"]] == \
        ["sanitizer_forbidden_transfer"]
    assert 'kfserving_tpu_sanitizer_violations_total{kind=' \
        '"forbidden_transfer"} 1' in metrics
    assert "kfserving_tpu_sanitizer_armed 1" in metrics
    assert sanitizer.status()["watchdog"] is False   # the server stopped it
