"""Durable KV handoff in the port, on the CPU: the drain export, a
successor's adoption, the peer pull between two port servers, standby
activation and the SIGTERM sequence.

Every arm gives the tokens of an unbroken session, which are the JAX
decoder's greedy tokens (the JAX GenerationEngine itself is never
driven); a failed export or import degrades to a re-prefill, and what it
dropped is counted.  The tier and handoff families the port publishes
carry the JAX package's names, kinds and buckets, and its scrape passes
the JAX package's exposition linter.
"""

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import time

import pytest
from torch_generation import TinyDecoder
from torch_serving import arequest, request

from kfserving_tpu.observability import metrics as jax_obs
from kfserving_tpu.tools.check_metrics import lint_exposition
from kfserving_tpu_torch import startup
from kfserving_tpu_torch.engine.generator import GenerationEngine
from kfserving_tpu_torch.engine.kv_tier import HostKVTier
from kfserving_tpu_torch.observability import REGISTRY
from kfserving_tpu_torch.observability import metrics as obs
from kfserving_tpu_torch.predictors.llm import GenerativeModel
from kfserving_tpu_torch.reliability.faults import faults
from kfserving_tpu_torch.server import app as app_module
from kfserving_tpu_torch.server.app import ModelServer

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_SEQ = 64
BS = 16
P1 = list(range(1, 2 * BS + 1))
# Byte tokenizer: 32 characters + BOS = two full blocks and one id.
PROMPT = "s" * 32
# The tier and handoff families (kfserving_tpu/observability/metrics.py).
TIER_FAMILIES = (
    "generator_kv_tier_blocks", "generator_kv_tier_occupancy_ratio",
    "generator_kv_tier_spills_total", "generator_kv_tier_faultbacks_total",
    "generator_kv_tier_faultback_ms", "generator_kv_tier_evictions_total",
    "generator_kv_tier_tokens_saved_total",
    "kv_handoff_exported_blocks_total", "kv_handoff_reattached_blocks_total",
    "kv_handoff_peer_blocks_total", "kv_handoff_export_ms")
# Model config of the served tests: two slots, a small pool, a tier.
SERVED_CONFIG = {
    "architecture": "decoder_tiny",
    "arch_kwargs": {"num_layers": 2, "hidden_size": 64, "num_heads": 2,
                    "intermediate_size": 128, "max_seq": MAX_SEQ},
    "max_slots": 2, "max_seq": MAX_SEQ,
    "prefill_buckets": [16, 32, MAX_SEQ], "max_new_tokens": 4,
    "tokenizer": "byte", "block_size": BS, "cache_blocks": 8,
    "host_tier_blocks": 8,
}


@pytest.fixture(autouse=True)
def _clean_slate():
    REGISTRY.reset()
    faults.reset()
    yield
    faults.reset()
    REGISTRY.reset()


@pytest.fixture(scope="module")
def tiny():
    return TinyDecoder()


@pytest.fixture(scope="module")
def port_module(tiny):
    return tiny.port()


def make_engine(module, **kw):
    kw.setdefault("max_slots", 1)
    kw.setdefault("max_seq", MAX_SEQ)
    kw.setdefault("prefill_buckets", [16, 32, MAX_SEQ])
    kw.setdefault("block_size", BS)
    kw.setdefault("cache_blocks", 8)
    return GenerationEngine(module, name=kw.pop("name", "kvhandoff"), **kw)


def counter(family: str, **labels) -> float:
    want = {(k, str(v)) for k, v in labels.items()}
    return sum(child.value for sample, child
               in REGISTRY.counter(family).samples()
               if want <= set(sample.items()))


async def settle_pool(eng, timeout_s: float = 10.0) -> None:
    total = eng.stats()["paged"]["pool_blocks"]
    for _ in range(int(timeout_s / 0.02)):
        await asyncio.sleep(0.02)
        st = eng.stats()["paged"]
        if st["free_blocks"] + st["reclaimable_blocks"] == total:
            return
    raise AssertionError(f"pool never settled: {eng.stats()['paged']}")


async def complete(eng, prompt, n: int = 3):
    toks, reason = await eng.complete(prompt, max_new_tokens=n)
    assert reason == "length"
    await settle_pool(eng)
    return toks


def write_model(root, name: str, **overrides) -> str:
    d = os.path.join(str(root), name)
    os.makedirs(d, exist_ok=True)
    config = dict(SERVED_CONFIG, **overrides)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(config, f)
    return d


# ------------------------------------------------ engine: export + adopt

async def test_drain_export_successor_adopts_bit_exact(tiny, port_module,
                                                       tmp_path):
    """The incumbent's export lands its chains in the persistent tier; a
    successor engine on the same directory adopts the same bytes and
    serves the return visit by fault-back, with the unbroken session's
    tokens."""
    want = tiny.greedy(P1, 3)
    d = str(tmp_path / "kv")
    eng1 = make_engine(port_module, host_tier_blocks=8, host_tier_dir=d,
                       name="kvhandoff-drain")
    try:
        assert await complete(eng1, P1) == want
        res = eng1.export_kv(budget_s=10.0)
        assert res["exported"] >= 2, res
        assert res["failed"] == 0 and res["dropped"] == 0
        exported = {c: eng1.kv_tier.read(bytes.fromhex(c))
                    for c in eng1.kv_tier.chains()}
    finally:
        await eng1.close()
    eng2 = make_engine(port_module, host_tier_blocks=8, host_tier_dir=d,
                       name="kvhandoff-drain")
    try:
        assert eng2.kv_tier.handoff["adopted"] == len(exported) >= 2
        assert {c: eng2.kv_tier.read(bytes.fromhex(c))
                for c in eng2.kv_tier.chains()} == exported
        assert await complete(eng2, P1) == want
        ht = eng2.stats()["host_tier"]
        assert ht["faulted_blocks"] >= 2
        assert counter("kfserving_tpu_kv_handoff_exported_blocks_total",
                       model="kvhandoff-drain", outcome="exported") >= 2
        assert counter("kfserving_tpu_kv_handoff_reattached_blocks_total",
                       model="kvhandoff-drain", outcome="adopted") >= 2
    finally:
        await eng2.close()


async def test_live_slot_is_exported_mid_stream(tiny, port_module,
                                                tmp_path):
    """A stream still decoding has its blocks exported (live slots come
    first), over prompt + output: the chains its return visit probes."""
    eng = make_engine(port_module, host_tier_blocks=8,
                      host_tier_dir=str(tmp_path / "kv"),
                      name="kvhandoff-live")
    try:
        req = eng.submit(P1, max_new_tokens=20)
        got = []
        async for tok, _fin in eng.stream(req):
            got.append(tok)
            if len(got) == 3:
                loop = asyncio.get_running_loop()
                res = await loop.run_in_executor(None, eng.export_kv, 10.0)
                break
        eng.cancel(req)
        assert res["exported"] >= 2 and res["failed"] == 0
    finally:
        await eng.close()


async def test_export_budget_drops_are_counted(port_module, tmp_path):
    """A spent budget drops every candidate, counted, and exports
    nothing."""
    eng = make_engine(port_module, host_tier_blocks=8,
                      host_tier_dir=str(tmp_path / "kv"),
                      name="kvhandoff-budget")
    try:
        await complete(eng, P1)
        res = eng.export_kv(budget_s=0.0)
        assert res["exported"] == 0 and res["dropped"] >= 2
        assert eng.kv_tier.debug()["used_blocks"] == 0
        assert counter("kfserving_tpu_kv_handoff_exported_blocks_total",
                       model="kvhandoff-budget", outcome="dropped") == \
            res["dropped"]
    finally:
        await eng.close()


async def test_export_fault_degrades_to_no_handoff(tiny, port_module,
                                                   tmp_path):
    want = tiny.greedy(P1, 3)
    d = str(tmp_path / "kv")
    faults.configure({"engine.kv_export": {"fail_first": 1000}})
    eng1 = make_engine(port_module, host_tier_blocks=8, host_tier_dir=d,
                       name="kvhandoff-exfault")
    try:
        assert await complete(eng1, P1) == want
        res = eng1.export_kv(budget_s=10.0)
        assert res["exported"] == 0 and res["failed"] >= 2
        assert eng1.kv_tier.debug()["used_blocks"] == 0
    finally:
        await eng1.close()
    faults.reset()
    eng2 = make_engine(port_module, host_tier_blocks=8, host_tier_dir=d,
                       name="kvhandoff-exfault")
    try:
        assert eng2.kv_tier.handoff["adopted"] == 0
        assert await complete(eng2, P1) == want
        assert eng2.stats()["host_tier"]["faulted_blocks"] == 0
    finally:
        await eng2.close()


async def test_import_fault_rejects_the_batch(tiny, port_module):
    want = tiny.greedy(P1, 3)
    eng = make_engine(port_module, host_tier_blocks=8,
                      name="kvhandoff-imfault")
    try:
        payload = b"\x5a" * eng.kv_tier.block_bytes
        pairs = [(b"p" * 16, payload), (b"q" * 16, payload)]
        faults.configure({"engine.kv_import": {"fail_first": 1}})
        assert eng.kv_import(pairs) == {"imported": 0, "skipped": 0,
                                        "failed": 2}
        assert eng.kv_tier.debug()["used_blocks"] == 0
        assert await complete(eng, P1) == want
        assert eng.kv_import(pairs)["imported"] == 2
        assert eng.kv_import(pairs[:1])["skipped"] == 1
        assert counter("kfserving_tpu_kv_handoff_peer_blocks_total",
                       model="kvhandoff-imfault", outcome="failed") == 2
        assert counter("kfserving_tpu_kv_handoff_peer_blocks_total",
                       model="kvhandoff-imfault", outcome="imported") == 2
    finally:
        await eng.close()


# ------------------------------------------------ servers: peer pull

async def _serve(models):
    server = ModelServer(http_port=0)
    await server.start_async(models, host="127.0.0.1")
    return server


async def test_peer_pull_between_two_servers(tmp_path, monkeypatch):
    """Replica A holds a conversation's chains in its tier; replica B gets
    a generate with the router's x-kfs-kv-peer hint naming A, pulls A's
    chains (one payload corrupted on the wire: discarded, counted) and
    serves the return visit by fault-back with A's output.  The routes
    answer as the JAX server's: 400 for a non-hex chain, 404 for one not
    resident, a bare /kv/reattach re-scan, a skipped re-pull."""
    model_a = GenerativeModel("gen", write_model(tmp_path, "a"),
                              device="cpu")
    model_b = GenerativeModel("gen", write_model(tmp_path, "b"),
                              device="cpu")
    model_a.load()
    model_b.load()
    server_a = await _serve([model_a])
    server_b = await _serve([model_b])
    pa, pb = server_a.http_port, server_b.http_port
    base_a = f"http://127.0.0.1:{pa}"
    try:
        body = {"text_input": PROMPT, "parameters": {"max_tokens": 4}}
        status, _, raw = await arequest(pa, "POST",
                                        "/v2/models/gen/generate", body)
        assert status == 200, raw
        out_a = json.loads(raw)["text_output"]
        loop = asyncio.get_running_loop()
        res = await loop.run_in_executor(None, model_a.engine.export_kv,
                                         10.0)
        assert res["exported"] >= 2, res
        status, _, raw = await arequest(pa, "GET", "/kv/chains")
        index = json.loads(raw)["models"]["gen"]
        assert status == 200 and len(index["chains"]) >= 2
        assert index["block_bytes"] == model_a.engine.kv_tier.block_bytes
        status, headers, payload = await arequest(
            pa, "GET", f"/kv/chains/{index['chains'][0]}")
        assert status == 200 and len(payload) == index["block_bytes"]
        assert headers["x-kfs-kv-model"] == "gen"
        assert headers["x-kfs-kv-block-bytes"] == str(index["block_bytes"])
        assert headers["x-kfs-kv-digest"]
        assert (await arequest(pa, "GET", "/kv/chains/zz-not-hex"))[0] == 400
        assert (await arequest(pa, "GET",
                               f"/kv/chains/{'00' * 16}"))[0] == 404

        # One extra chain on A whose payload the wire corrupts.
        bad = b"\x01" * 16
        assert model_a.engine.kv_tier.put(bad, b"\x07" * index["block_bytes"])
        real_get = app_module._http_get

        def flaky_get(base, path, timeout):
            status, headers, body = real_get(base, path, timeout)
            if bad.hex() in path:
                body = b"\x00" + body[1:]
            return status, headers, body

        monkeypatch.setattr(app_module, "_http_get", flaky_get)
        status, _, raw = await arequest(
            pb, "POST", "/v2/models/gen/generate", body,
            headers={"x-kfs-kv-peer": base_a})
        assert status == 200, raw
        assert json.loads(raw)["text_output"] == out_a
        ht = model_b.engine.stats()["host_tier"]
        assert ht["faulted_blocks"] >= 2
        assert not model_b.engine.kv_tier.contains(bad)
        assert counter("kfserving_tpu_kv_handoff_peer_blocks_total",
                       model="gen", outcome="imported") >= 2
        assert counter("kfserving_tpu_kv_handoff_peer_blocks_total",
                       model="gen", outcome="digest_mismatch") == 1

        # An explicit pull finds everything resident but the bad chain.
        status, _, raw = await arequest(pb, "POST", "/kv/reattach",
                                        {"peer": base_a})
        res = json.loads(raw)["models"]["gen"]
        assert status == 200
        assert res["imported"] == 0 and res["digest_mismatch"] == 1
        # A bare re-attach re-scans an ephemeral tier: nothing to adopt.
        status, _, raw = await arequest(pb, "POST", "/kv/reattach")
        assert status == 200 and json.loads(raw) == {"models": {"gen": {}}}
        assert (await arequest(pb, "POST", "/kv/reattach", b"{"))[0] == 400
        # The hint is single-flight per peer, and a dead peer never
        # fails the request.
        status, _, _ = await arequest(
            pb, "POST", "/v2/models/gen/generate", body,
            headers={"x-kfs-kv-peer": "http://127.0.0.1:9"})
        assert status == 200
        status, _, raw = await arequest(pb, "GET", "/debug/cache")
        cache = json.loads(raw)
        assert set(cache["host_tier"]) == {"gen"}
        assert cache["host_tier"]["gen"]["faulted_blocks"] >= 2
    finally:
        await server_b.stop_async()
        await server_a.stop_async()
        await model_b.close()
        await model_a.close()


async def test_tier_families_and_exposition(tmp_path):
    """Spills, fault-backs, tier evictions, adoption and the export on a
    served model publish the eleven tier and handoff families under the
    JAX package's names, kinds and buckets (with the capacity_spilled
    eviction cause and the host_hit lookup outcome), and the scrape
    passes the JAX package's linter."""
    kv = tmp_path / "kv"
    block_bytes = 2 * 2 * BS * 2 * 32 * 4
    pred = HostKVTier(block_bytes=block_bytes, capacity_blocks=2,
                      directory=str(kv), model="gen")
    assert pred.put(b"\x02" * 16, b"\x03" * block_bytes)
    pred.close()
    model = GenerativeModel("gen", write_model(
        tmp_path, "m", max_slots=1, cache_blocks=4, host_tier_blocks=3,
        host_tier_dir=str(kv)), device="cpu")
    model.load()
    server = await _serve([model])
    port = server.http_port
    try:
        for text in (PROMPT, "t" * 48, PROMPT):
            status, _, raw = await arequest(
                port, "POST", "/v2/models/gen/generate",
                {"text_input": text, "parameters": {"max_tokens": 3}})
            assert status == 200, raw
        assert (await server.export_kv(10.0))["gen"]["failed"] == 0
        # A peer's pair, as /kv/reattach admits it.
        assert model.engine.kv_import(
            [(b"\x04" * 16, b"\x05" * block_bytes)])["imported"] == 1
        _, _, scrape = await arequest(port, "GET", "/metrics")
        _, _, om = await arequest(
            port, "GET", "/metrics",
            headers={"accept": "application/openmetrics-text"})
    finally:
        await server.stop_async()
        await model.close()
    text = scrape.decode()
    types = {line.split()[2]: line.split()[3] for line in text.splitlines()
             if line.startswith("# TYPE ")}
    for accessor in TIER_FAMILIES:
        jax_fam = getattr(jax_obs, accessor)()
        port_fam = getattr(obs, accessor)()
        assert port_fam.name == jax_fam.name
        assert port_fam.kind == jax_fam.kind
        assert port_fam.buckets == jax_fam.buckets
        assert types.get(port_fam.name) == port_fam.kind, port_fam.name
    for family, label in (
            ("kfserving_tpu_generator_block_evictions_total",
             'cause="capacity_spilled"'),
            ("kfserving_tpu_generator_prefix_lookups_total",
             'outcome="host_hit"')):
        assert any(line.startswith(family + "{") and label in line
                   for line in text.splitlines()), (family, label)
    assert lint_exposition(text) == []
    assert lint_exposition(om.decode()) == []


# ------------------------------------------------ standby and phases

async def test_standby_activation_and_startup_phases(tmp_path):
    model = GenerativeModel("gen", write_model(tmp_path, "m"),
                            device="cpu")
    server = ModelServer(http_port=0)
    server.standby_model(lambda: (model.load(), model)[1])
    plain = ModelServer(http_port=0)
    await server.start_async([], host="127.0.0.1")
    await plain.start_async([], host="127.0.0.1")
    port = server.http_port
    try:
        assert (await arequest(plain.http_port, "POST",
                               "/standby/activate"))[0] == 409
        status, _, raw = await arequest(port, "GET", "/v2/models")
        assert status == 200 and json.loads(raw) == []
        status, _, raw = await arequest(port, "POST", "/standby/activate")
        body = json.loads(raw)
        assert status == 200, body
        assert body["activated"] is True and body["model"] == "gen"
        assert body["param_source"] == "init"
        assert {"load_start", "download", "standby_activate"} <= \
            set(body["phases"])
        status, _, raw = await arequest(port, "POST", "/standby/activate")
        assert json.loads(raw) == {"activated": True, "already": True}
        status, _, raw = await arequest(
            port, "POST", "/v2/models/gen/generate",
            {"text_input": "hi", "parameters": {"max_tokens": 2}})
        assert status == 200, raw
        status, _, raw = await arequest(port, "GET", "/startup_phases")
        phases = json.loads(raw)
        assert status == 200 and phases == startup.phases()
        assert phases["interpreter_imports"] <= phases["serving"] <= \
            phases["standby_activate"]
    finally:
        await plain.stop_async()
        await server.stop_async()
        await model.close()


# ------------------------------------------------ SIGTERM -> successor

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(model_dir: str, port: int, env) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "kfserving_tpu_torch.predictors.llmserver",
         "--model_name", "gen", "--model_dir", model_dir,
         "--http_port", str(port), "--device", "cpu"],
        env=env, cwd=REPO_ROOT, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE)


def _wait_live(proc, port: int, timeout_s: float = 60.0) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        assert proc.poll() is None, proc.stderr.read().decode()[-2000:]
        try:
            if request(port, "GET", "/")[0] == 200:
                return
        except OSError:
            pass
        time.sleep(0.1)
    raise AssertionError("server never came up")


def test_sigterm_exports_and_the_standby_successor_adopts(tmp_path):
    """SIGTERM runs drain -> export -> stop in the llmserver process; a
    successor booted in standby on the same tier directory adopts the
    generation on activation and answers the return visit by fault-back
    with the incumbent's output."""
    model_dir = write_model(tmp_path, "m")
    env = dict(os.environ, KFS_KV_TIER_DIR=str(tmp_path / "kv"),
               KFS_DRAIN_GRACE_S="5", KFS_KV_EXPORT_BUDGET_S="10")
    body = {"text_input": PROMPT, "parameters": {"max_tokens": 4}}
    port1, port2 = _free_port(), _free_port()
    proc1 = _spawn(model_dir, port1, env)
    proc2 = None
    try:
        _wait_live(proc1, port1)
        status, _, raw = request(port1, "POST", "/v2/models/gen/generate",
                                 body)
        assert status == 200, raw
        out1 = json.loads(raw)["text_output"]
        # A successor in standby boots beside the incumbent.
        proc2 = _spawn(model_dir, port2, dict(env, KFS_STANDBY="1"))
        _wait_live(proc2, port2)
        proc1.send_signal(signal.SIGTERM)
        assert proc1.wait(timeout=60) == 0
        status, _, raw = request(port2, "POST", "/standby/activate")
        assert status == 200, raw
        _, _, raw = request(port2, "GET", "/debug/cache")
        tier = json.loads(raw)["host_tier"]["gen"]
        assert tier["persistent"] and tier["handoff"]["adopted"] >= 2
        status, _, raw = request(port2, "POST", "/v2/models/gen/generate",
                                 body)
        assert status == 200 and json.loads(raw)["text_output"] == out1
        _, _, raw = request(port2, "GET", "/debug/cache")
        assert json.loads(raw)["host_tier"]["gen"]["faulted_blocks"] >= 2
        _, _, raw = request(port2, "GET", "/startup_phases")
        assert "standby_activate" in json.loads(raw)
        proc2.send_signal(signal.SIGTERM)
        assert proc2.wait(timeout=60) == 0
    finally:
        for proc in (proc1, proc2):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
            if proc is not None:
                proc.stderr.close()
