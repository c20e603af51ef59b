"""The port's subprocess orchestrator on the CPU: standby spawn, activate
and serve; crash promotion within one supervisor tick; an activation
failure that keeps the incumbent; a warm recycle whose successor adopts
the incumbent's KV; and a SIGKILL in the middle of a stream.

Replicas are the port's entry points run with ``--device cpu``
(``python -m kfserving_tpu_torch.predictors.jaxserver`` /
``llmserver``).  Their answers are held against the JAX package: the MLP
against a ``JaxModel`` on the same checkpoint, the decoder's tokens
against the JAX decoder's greedy rule on the same weights
(``tests/torch_generation.py``).  Each test spawns three replica
processes and the pool re-arms in the background.
"""

import asyncio
import json
import os
import signal

import numpy as np
import pytest
from flax import serialization
from torch_generation import TinyDecoder
from torch_serving import arequest

from kfserving_tpu.predictors.jax_model import JaxModel
from kfserving_tpu_torch.control.controller import Controller
from kfserving_tpu_torch.control.router import IngressRouter
from kfserving_tpu_torch.control.spec import InferenceService, PredictorSpec
from kfserving_tpu_torch.control.subprocess_orchestrator import (
    RecyclePolicy,
    SubprocessOrchestrator,
)
from kfserving_tpu_torch.observability import REGISTRY
from kfserving_tpu_torch.observability import metrics as obs
from kfserving_tpu_torch.predictors.llm import EOS_ID, ByteTokenizer
from kfserving_tpu_torch.reliability import faults
from kfserving_tpu_torch.server.client import HTTPClient

MAX_SEQ = 128
BS = 16
GEN_ARCH = dict(num_layers=2, hidden_size=64, num_heads=2,
                intermediate_size=128, max_seq=MAX_SEQ)


@pytest.fixture(autouse=True)
def _clean_slate():
    REGISTRY.reset()
    faults.reset()
    yield
    faults.reset()
    REGISTRY.reset()


async def _wait_for(predicate, timeout_s=60.0, interval_s=0.1):
    deadline = asyncio.get_running_loop().time() + timeout_s
    while asyncio.get_running_loop().time() < deadline:
        result = predicate()
        if result:
            return result
        await asyncio.sleep(interval_s)
    raise AssertionError(f"condition not met within {timeout_s}s")


def _replica_children():
    """Live child processes of this process that run a replica."""
    out = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmdline = f.read()
        except OSError:
            continue
        if int(fields[1]) == os.getpid() and fields[0] != "Z" and \
                b"kfserving_tpu_torch" in cmdline:
            out.append(int(pid))
    return out


def _port(host: str) -> int:
    return int(host.rsplit(":", 1)[1])


def _mlp_dir(tmp_path):
    import jax

    from kfserving_tpu.models import create_model
    from torch_parity import randomized

    ak = {"input_dim": 4, "features": [8], "num_classes": 3}
    spec = create_model("mlp", **ak)
    shapes = jax.eval_shape(lambda: spec.module.init(
        jax.random.PRNGKey(0), spec.example))
    d = tmp_path / "mlp"
    d.mkdir()
    (d / "config.json").write_text(json.dumps({
        "architecture": "mlp", "arch_kwargs": ak, "dtype": "float32",
        "max_latency_ms": 2.0, "output": "argmax", "warmup": False}))
    (d / "checkpoint.msgpack").write_bytes(
        serialization.to_bytes(randomized(shapes, 3)))
    return str(d)


async def test_standby_promotion_and_activation_failure(tmp_path):
    """A standby spawned with KFS_STANDBY answers liveness but serves no
    model until activated; activated, it serves the JAX model's answers.
    SIGKILLed, the serving replica is replaced by the pool's armed
    standby within one supervisor tick, with the failover pinned.  Then
    an injected activation failure aborts a recycle: the incumbent keeps
    serving, the failure is counted and pinned."""
    earlier = set(await asyncio.to_thread(_replica_children))
    model_dir = _mlp_dir(tmp_path)
    rows = np.random.default_rng(0).normal(size=(4, 4)).round(3).tolist()
    jax_model = JaxModel("smoke", model_dir)
    jax_model.load()
    want = (await jax_model.predict({"instances": rows}))["predictions"]
    want = np.asarray(want).tolist()

    orch = SubprocessOrchestrator(
        device="cpu",
        recycle=RecyclePolicy(check_interval_s=0.3, min_age_s=0.0))
    spec = PredictorSpec(framework="jax", storage_uri=model_dir)
    cid = "default/smoke/predictor"
    try:
        standby = await orch.create_replica(cid, "rev1", spec,
                                            standby=True)
        assert orch.replicas(cid) == []
        port = _port(standby.host)
        assert (await arequest(port, "GET", "/"))[0] == 200
        assert (await arequest(port, "GET", "/v1/models/smoke"))[0] == 404
        await orch._activate_standby(standby)
        assert [r.host for r in orch.replicas(cid)] == [standby.host]
        status, _, body = await arequest(
            port, "POST", "/v1/models/smoke:predict", {"instances": rows})
        assert status == 200 and json.loads(body)["predictions"] == want
        phases = json.loads((await arequest(port, "GET",
                                            "/startup_phases"))[2])
        assert "standby_activate" in phases

        # Crash promotion: the watchdog armed a standby; SIGKILL.
        pool = await _wait_for(lambda: orch._standbys.get((cid, "rev1")))
        armed = pool[0]
        os.kill(standby.handle.process.pid, signal.SIGKILL)
        await _wait_for(lambda: orch.promotions >= 1, timeout_s=30.0)
        assert [r.host for r in orch.replicas(cid)] == [armed.host]
        status, _, body = await arequest(
            _port(armed.host), "POST", "/v1/models/smoke:predict",
            {"instances": rows})
        assert status == 200 and json.loads(body)["predictions"] == want
        pinned = orch.flight_recorder.dump(limit=10,
                                           pinned_only=True)["pinned"]
        failover = [e for e in pinned if e.get("kind") == "replica_failover"]
        assert failover and failover[-1]["trigger"] == "process_exit"
        assert failover[-1]["outcome"] == "promoted"
        assert failover[-1]["dead_host"] == standby.host
        assert failover[-1]["promoted_host"] == armed.host

        # An activation failure keeps the incumbent.
        await _wait_for(lambda: orch._standbys.get((cid, "rev1")))
        faults.configure({"orchestrator.standby_activate":
                          {"fail_first": 1}})
        incumbent = orch.replicas(cid)[0]
        await orch._recycle_replica(incumbent, "test")
        assert orch.swap_failures == 1 and orch.recycle_count == 0
        assert incumbent.handle.process.returncode is None
        assert [r.host for r in orch.replicas(cid)] == [incumbent.host]
        status, _, _ = await arequest(
            _port(incumbent.host), "POST", "/v1/models/smoke:predict",
            {"instances": rows})
        assert status == 200
        assert obs.lifecycle_swap_failures_total().labels(
            reason="activate_error").value == 1.0
        pinned = orch.flight_recorder.dump(limit=10,
                                           pinned_only=True)["pinned"]
        assert any(e.get("kind") == "swap_failure" for e in pinned)
        # The pool re-arms after the failed swap: a standby boots while
        # the orchestrator shuts down.
        await _wait_for(lambda: orch._tasks)
    finally:
        await orch.shutdown()
    # No replica process outlives the orchestrator, a booting standby's
    # included (children left by other tests in this process aside).
    assert set(await asyncio.to_thread(_replica_children)) <= earlier


def _gen_dir(tmp_path, tiny):
    d = tmp_path / "llm"
    d.mkdir()
    (d / "config.json").write_text(json.dumps({
        "architecture": "decoder_tiny", "arch_kwargs": GEN_ARCH,
        "max_slots": 2, "max_seq": MAX_SEQ,
        "prefill_buckets": [16, 32, MAX_SEQ], "max_new_tokens": 8,
        "tokenizer": "byte", "block_size": BS, "cache_blocks": 16,
        "host_tier_blocks": 16}))
    (d / "checkpoint.msgpack").write_bytes(
        serialization.to_bytes(tiny.variables))
    return str(d)


def _greedy(tiny, prompt: str, steps: int):
    """The JAX decoder's greedy tokens for a text prompt, up to EOS."""
    out = tiny.greedy(ByteTokenizer().encode(prompt), steps)
    return out[:out.index(EOS_ID)] if EOS_ID in out else out


def _events(body: bytes):
    return [json.loads(line[6:]) for line in body.decode().splitlines()
            if line.startswith("data: ")]


def _ids(events):
    return [e["token"]["id"] for e in events
            if e.get("token") and e["token"]["id"] is not None]


async def _stream(port, prompt, max_tokens, headers=None):
    status, _, body = await arequest(
        port, "POST", "/v2/models/gen/generate_stream",
        {"text_input": prompt, "max_tokens": max_tokens}, headers)
    assert status == 200, body
    return _events(body)


async def _host_tier(host):
    body = json.loads((await arequest(_port(host), "GET",
                                      "/debug/cache"))[2])
    return (body.get("host_tier") or {}).get("gen") or {}


async def test_warm_recycle_and_sigkill_failover(tmp_path):
    """The decoder behind the router.  A warm recycle: the incumbent's
    drain exports the conversation into the persistent tier, the
    successor adopts it and serves the returning turn by fault-back with
    the JAX greedy rule's tokens.  Then the successor is SIGKILLed during
    a stream: the stream ends with the retriable failover event naming
    it, a request sent right after reaches the dead replica, and the
    router evicts it and retries with x-kfs-kv-peer; the promoted standby
    answers, with the JAX greedy rule's tokens, and pulled from the
    named peer."""
    earlier = set(await asyncio.to_thread(_replica_children))
    tiny = TinyDecoder(GEN_ARCH)
    model_dir = _gen_dir(tmp_path, tiny)
    policy = RecyclePolicy(check_interval_s=0.3, min_age_s=0.0)
    orch = SubprocessOrchestrator(
        device="cpu", recycle=policy,
        env_overrides={"KFS_KV_TIER_DIR": str(tmp_path / "kv"),
                       "KFS_DRAIN_GRACE_S": "1"})
    controller = Controller(orch)
    router = IngressRouter(controller, buffer_deadline_s=30.0)
    await router.start_async()
    cid = "default/gen/predictor"
    prompt = "w" * 32
    try:
        await controller.apply(InferenceService(
            name="gen", predictor=PredictorSpec(
                framework="generative", storage_uri=f"file://{model_dir}")))
        incumbent = orch.replicas(cid)[0]
        await _wait_for(lambda: orch._standbys.get((cid,
                                                    incumbent.revision)))
        before = _ids(await _stream(router.http_port, prompt, 4))
        assert before == _greedy(tiny, prompt, 4)

        await orch._recycle_replica(incumbent, "test-handoff")
        successor = orch.replicas(cid)[0]
        assert successor.host != incumbent.host
        assert orch.swap_breakdown[-1]["mode"] == "warm_standby"
        tier = await _host_tier(successor.host)
        assert (tier.get("handoff") or {}).get("adopted", 0) >= 2, tier
        assert _ids(await _stream(router.http_port, prompt, 4)) == before
        assert (await _host_tier(successor.host)).get(
            "faulted_blocks", 0) >= 2

        # The kill.  The supervisor's tick is slowed first, so the dead
        # replica leaves rotation through the router alone; the stream's
        # liveness probe waits until the second request has met the
        # corpse, so the router's own retry is what evicts it.
        await _wait_for(lambda: orch._standbys.get((cid,
                                                    successor.revision)))
        policy.check_interval_s = 60.0
        await asyncio.sleep(0.5)
        gate = asyncio.Event()
        probe = router._replica_alive

        async def gated_probe(host):
            await gate.wait()
            return await probe(host)

        router._replica_alive = gated_probe
        resp = await HTTPClient(timeout=60, keepalive=False).open(
            "POST", f"http://127.0.0.1:{router.http_port}"
            "/v2/models/gen/generate_stream",
            json.dumps({"text_input": "k", "max_tokens": 120}).encode())
        chunks = resp.iter_chunks()
        first = await chunks.__anext__()
        os.kill(successor.handle.process.pid, signal.SIGKILL)
        await successor.handle.process.wait()

        async def rest():
            return first + b"".join([c async for c in chunks])

        stream = asyncio.ensure_future(rest())
        racer = asyncio.ensure_future(_stream(router.http_port, prompt, 4))
        await _wait_for(lambda: orch.promotions >= 1, timeout_s=30.0)
        gate.set()
        final = _events(await stream)[-1]
        assert final["finish_reason"] == "failover" and final["retriable"]
        assert final["predecessor"] == successor.host
        assert _ids(await racer) == before
        promoted = orch.replicas(cid)[0]
        assert promoted.host not in (incumbent.host, successor.host)
        # The router retried the request away from the corpse, naming it.
        retried = obs.revision_requests_total().labels(
            model="gen", revision=promoted.revision, status="503").value
        assert retried == 1.0
        pins = json.loads((await arequest(
            _port(promoted.host), "GET",
            "/debug/flightrecorder?pinned=1"))[2])["pinned"]
        assert any(e.get("kind") == "kv_handoff_peer_pull"
                   and e.get("peer") == f"http://{successor.host}"
                   for e in pins), pins
        # The supervisor's failover pin federates through the router.
        body = json.loads((await arequest(
            router.http_port, "GET", "/debug/flightrecorder?pinned=1"))[2])
        sup = [e for e in body["pinned"] if e.get("replica") == "supervisor"
               and e.get("kind") == "replica_failover"]
        assert sup and sup[-1]["outcome"] == "promoted"
        assert sup[-1]["trigger"] == "crash_report"
    finally:
        await router.stop_async()
        await orch.shutdown()
    assert set(await asyncio.to_thread(_replica_children)) <= earlier


def test_argv_runs_the_port_entry_points_on_the_device(tmp_path):
    """The replica argv: the port's module per framework, --device, the
    batcher flags the port's parser now accepts, and the refusal of an
    explainer type without a command."""
    import sys

    from kfserving_tpu_torch.control.spec import (
        BatcherSpec,
        ExplainerSpec,
    )
    from kfserving_tpu_torch.predictors.llmserver import __main__ as llm
    from kfserving_tpu_torch.server.app import parser

    orch = SubprocessOrchestrator()
    assert orch.device == "cuda"
    argv = orch._command("default/m/predictor", PredictorSpec(
        framework="jax", storage_uri="/m", container_concurrency=2,
        batcher=BatcherSpec(max_batch_size=8, max_latency_ms=3.0)), 9000)
    assert argv[:3] == [sys.executable, "-m",
                        "kfserving_tpu_torch.predictors.jaxserver"]
    assert argv[argv.index("--device") + 1] == "cuda"
    args, unknown = parser.parse_known_args(argv[3:])
    assert (args.max_batch_size, args.max_latency_ms, args.workers) == \
        (8, 3.0, 1)
    assert unknown == ["--model_name", "m", "--model_dir", "/m",
                       "--device", "cuda"]
    gen = SubprocessOrchestrator(device="cpu")._command(
        "default/g/predictor",
        PredictorSpec(framework="generative", storage_uri="/g"), 9001)
    assert gen[2] == "kfserving_tpu_torch.predictors.llmserver"
    assert llm.parser.parse_known_args(gen[3:])[0].device == "cpu"
    exp = orch._command("default/e/explainer", ExplainerSpec(
        explainer_type="square_attack"), 9002)
    assert exp[2] == "kfserving_tpu_torch.explainers"
    assert exp[exp.index("--device") + 1] == "cuda"
    with pytest.raises(ValueError, match="explicit command"):
        orch._command("default/e/explainer",
                      ExplainerSpec(explainer_type="alibi"), 9003)


class FakeProcess:
    """A replica process that exits when told to (no process runs)."""

    def __init__(self, returncode=None):
        self.returncode = returncode
        self.pid = 0

    def terminate(self):
        self.returncode = -15

    def kill(self):
        self.returncode = -9

    async def wait(self):
        return self.returncode


async def test_exclusive_device_swap_announces_the_window(tmp_path):
    """exclusive_device (a transport that admits one resident process):
    the incumbent drains before the standby activates, inside a window
    the orchestrator announces; the swap counts its window.  The
    standby is a fake handle: no process is spawned."""
    from kfserving_tpu_torch.control.orchestrator import Replica
    from kfserving_tpu_torch.control.subprocess_orchestrator import _Proc

    orch = SubprocessOrchestrator(device="cpu", recycle=RecyclePolicy(
        exclusive_device=True, min_age_s=0.0))
    cid = "default/x/predictor"
    spec = PredictorSpec(framework="jax", storage_uri="/m")
    incumbent = Replica(cid, "rev1", "127.0.0.1:1",
                        handle=_Proc(FakeProcess(), 1, spec=spec))
    standby = Replica(cid, "rev1", "127.0.0.1:2",
                      handle=_Proc(FakeProcess(), 2, spec=spec))
    from kfserving_tpu_torch.control.orchestrator import _ComponentState

    orch.state[cid] = _ComponentState(replicas=[incumbent])
    orch._standbys[(cid, "rev1")] = [standby]
    seen = {}

    async def activate(replica):
        # The incumbent is gone and the window announced.
        seen["announced"] = cid in orch.swap_announced
        seen["incumbent_exited"] = incumbent.handle.process.returncode
        orch.state[cid].replicas.append(replica)

    async def no_reattach(host):
        seen["reattach"] = host

    orch._activate_standby = activate
    orch._kv_reattach = no_reattach
    await orch._recycle_replica(incumbent, "test")
    assert seen == {"announced": True, "incumbent_exited": -15,
                    "reattach": standby.host}
    assert orch.replicas(cid) == [standby]
    assert orch.swap_breakdown[-1]["mode"] == "exclusive_standby"
    assert cid not in orch.swap_announced and orch.recycle_count == 1


async def _promote_after_a_reaping_tick(orchestrator_module,
                                        subprocess_module):
    """A crash report, then a supervisor tick's orphan reaping before the
    promotion task runs: the failover pin's outcome."""
    cid = "default/c/predictor"
    spec = PredictorSpec(framework="jax", storage_uri="/m")
    orch = subprocess_module.SubprocessOrchestrator(
        recycle=subprocess_module.RecyclePolicy(min_age_s=0.0))
    proc = subprocess_module._Proc
    dead = orchestrator_module.Replica(
        cid, "rev1", "127.0.0.1:1", handle=proc(FakeProcess(-9), 1, spec=spec))
    standby = orchestrator_module.Replica(
        cid, "rev1", "127.0.0.1:2", handle=proc(FakeProcess(), 2, spec=spec))
    orch.state[cid] = orchestrator_module._ComponentState(replicas=[dead])
    orch._standbys[(cid, "rev1")] = [standby]

    async def activate(replica):
        orch.state[cid].replicas.append(replica)

    async def cold_spawn(component_id, revision, spec_, **kwargs):
        replica = orchestrator_module.Replica(
            cid, revision, "127.0.0.1:3",
            handle=proc(FakeProcess(), 3, spec=spec_))
        orch.state[cid].replicas.append(replica)
        return replica

    async def no_reattach(host):
        return None

    orch._activate_standby = activate
    orch.create_replica = cold_spawn
    orch._kv_reattach = no_reattach
    await orch.report_crash(dead)
    orch._reap_orphan_standbys()       # a watchdog tick in the window
    await _wait_for(lambda: orch.promotions >= 1, timeout_s=10.0)
    pin = orch.flight_recorder.dump(limit=5, pinned_only=True)["pinned"][-1]
    return pin["outcome"], pin["promoted_host"], [
        r.host for r in orch.replicas(cid)]


async def test_crash_promotion_keeps_its_standby_from_the_reaper():
    """The router's crash report takes the corpse out of the state and
    promotes in a task; a supervisor tick that lands in between must not
    reap the standby the promotion is about to activate.  The JAX
    orchestrator reaps it there and cold-respawns; the port keeps a
    revision with a create in flight and promotes."""
    from kfserving_tpu.control import orchestrator as jax_orchestrator
    from kfserving_tpu.control import subprocess_orchestrator as jax_sub
    from kfserving_tpu_torch.control import orchestrator
    from kfserving_tpu_torch.control import subprocess_orchestrator

    jax_outcome = await _promote_after_a_reaping_tick(jax_orchestrator,
                                                      jax_sub)
    assert jax_outcome == ("cold_respawn", "127.0.0.1:3", ["127.0.0.1:3"])
    port_outcome = await _promote_after_a_reaping_tick(
        orchestrator, subprocess_orchestrator)
    assert port_outcome == ("promoted", "127.0.0.1:2", ["127.0.0.1:2"])


async def test_a_cuda_replica_without_a_card_fails_its_create(tmp_path):
    """No fallback: a subprocess replica asked for cuda on a machine
    without a card exits at load, and its create fails."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the replica would start")
    orch = SubprocessOrchestrator()
    try:
        with pytest.raises(RuntimeError, match="exited rc="):
            await orch.create_replica(
                "default/m/predictor", "rev1",
                PredictorSpec(framework="jax",
                              storage_uri=_mlp_dir(tmp_path)))
        assert orch.replicas("default/m/predictor") == []
    finally:
        await orch.shutdown()

