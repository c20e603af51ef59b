"""The port's generator in every mode under a mesh, on the CPU.

``decoder_tiny`` (2 heads) served by ``GenerativeModel`` under ``{"tp":
2}``: this process is rank 0, one follower process holds the other head,
the ranks talk over gloo (``parallel/follower.py``).  Each of the five
modes the single-device engine serves besides bucketed paged decoding
(dense slots, chunked prefill, speculative decoding with the n-gram head
and with a draft model, the host KV tier, KV handoff) gives every token
the JAX decoder's greedy choice teacher-forced
(``tests/torch_generation.py``) and the unsharded port engine's tokens.
Tier payloads gathered from both ranks equal the unsharded engine's
within ``KV_ATOL`` (fp32; the ranks' partial products sum in another
order), handoff directories cross between a tp2 and an unsharded engine
both ways, and a 3-head decoder, whose heads ``tp`` does not divide,
replicates its pool and still faults back.  Collectives time out after
``COLLECTIVE_TIMEOUT_S`` here, so a rank left waiting fails the test
instead of hanging it.  The JAX GenerationEngine is never driven.
"""

import asyncio
import json
import os

import numpy as np
import pytest
import torch
from flax import serialization

from kfserving_tpu_torch.engine.generator import GenerationEngine
from kfserving_tpu_torch.engine.hbm import HBMManager
from kfserving_tpu_torch.engine.residency import ResidencyManager
from kfserving_tpu_torch.observability import REGISTRY
from kfserving_tpu_torch.parallel import follower
from kfserving_tpu_torch.predictors.llm import GenerativeModel
from kfserving_tpu_torch.reliability.faults import faults
from torch_generation import ARCH, TinyDecoder, prompt

MAX_SEQ = 64
BS = 16
BUCKETS = [16, 32, 64]
# fp32 k/v of a rank's heads vs the unsharded engine's: layer 1's input
# is an all-reduced sum.
KV_ATOL = 1e-5
COLLECTIVE_TIMEOUT_S = 60
# The three-turn return visit of tests/test_torch_kv_tier.py.
P1 = list(range(1, 2 * BS + 1))
P2 = list(range(40, 40 + 3 * BS))
# A 3-head decoder: tp 2 leaves a remainder, so the heads replicate.
ODD_ARCH = dict(ARCH, hidden_size=48, num_heads=3)


@pytest.fixture(autouse=True)
def _clean_slate(monkeypatch):
    monkeypatch.setattr(follower, "COLLECTIVE_TIMEOUT_S",
                        COLLECTIVE_TIMEOUT_S)
    REGISTRY.reset()
    faults.reset()
    yield
    faults.reset()
    REGISTRY.reset()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Rank 0 computes on one thread: its idle intra-op threads spin
    beside the follower's on the same cores while a gloo collective
    waits, which makes a spec wave ~10x slower here."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny():
    return TinyDecoder()


@pytest.fixture(scope="module")
def port_module(tiny):
    return tiny.port()


def _config(arch=ARCH, **extra) -> dict:
    config = {"architecture": "decoder_tiny", "arch_kwargs": arch,
              "max_slots": 2, "max_seq": MAX_SEQ, "prefill_buckets": BUCKETS,
              "block_size": BS, "cache_blocks": 16, "steps_per_call": 2,
              "tokenizer": "byte"}
    config.update(extra)
    return {k: v for k, v in config.items() if v is not None}


def _engine_kwargs(config: dict) -> dict:
    """The GenerationEngine arguments of a config (no draft)."""
    keys = ("max_slots", "max_seq", "prefill_buckets", "block_size",
            "cache_blocks", "steps_per_call", "prefill_chunk_tokens",
            "host_tier_blocks", "host_tier_dir")
    out = {k: config[k] for k in keys if k in config}
    if "speculative" in config:
        out["speculative"] = {"tokens": config["speculative"]["tokens"]}
    return out


def _load(tmp_path, tiny, name: str, mesh=None, hbm=None, residency=None,
          **config) -> GenerativeModel:
    """A GenerativeModel on the tiny decoder's weights (its own
    directory, its checkpoint) with ``config``, under ``mesh``."""
    d = os.path.join(str(tmp_path), name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(dict(config, mesh=mesh or {}), f)
    with open(os.path.join(d, "checkpoint.msgpack"), "wb") as f:
        f.write(serialization.to_bytes(tiny.variables))
    model = GenerativeModel(name, d, device="cpu", hbm=hbm,
                            residency=residency)
    model.load()
    return model


async def _close(model: GenerativeModel) -> None:
    """Close and unload; the follower must be gone."""
    pids = list(model.engine._leader.pids) if model.engine._leader else []
    await model.close()
    model.unload()
    assert all(not _alive(pid) for pid in pids)


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


async def _run(engine, requests):
    """(prompt, max_new_tokens) requests at once -> their tokens."""
    done = await asyncio.wait_for(asyncio.gather(*[
        engine.complete(p, max_new_tokens=n) for p, n in requests]),
        timeout=120)
    for _, reason in done:
        assert reason == "length"
    return [t for t, _ in done]


async def _settle(engine, timeout_s: float = 10.0):
    """Wait until every capacity eviction's spill has been accounted and
    the pool is idle."""
    for _ in range(int(timeout_s / 0.02)):
        st = engine.stats()
        ev, ht = st["paged"]["evictions"], st.get("host_tier")
        idle = (st["paged"]["free_blocks"] + st["paged"]["reclaimable_blocks"]
                == st["paged"]["pool_blocks"])
        spilled = ht is None or (
            ht["spills"] + ht["spill_failures"] + ht["spill_duplicates"]
            >= ev["capacity_spilled"] + ev["capacity_dropped"]
            and not engine._spill_pending)
        if idle and spilled:
            return st
        await asyncio.sleep(0.02)
    raise AssertionError(f"engine never settled: {engine.stats()}")


async def _turns(engine, turns=(P1, P2, P1), n: int = 3):
    out = []
    for p in turns:
        out += await _run(engine, [(p, n)])
        await _settle(engine)
    return out


def _report(model) -> dict:
    return model.engine._leader.ask(("report",))[0]


async def _both(tmp_path, tiny, port_module, name, requests, arch=ARCH,
                mesh=None, **extra):
    """The requests through a model under ``mesh`` (tp2 by default) and
    an unsharded engine of the same config: (mesh tokens, unsharded
    tokens, mesh stats, the follower's report with both engines' cache
    bytes)."""
    config = _config(arch, **extra)
    model = await asyncio.to_thread(_load, tmp_path, tiny, name,
                                    mesh=mesh or {"tp": 2}, **config)
    try:
        got = await _run(model.engine, requests)
        stats, report = model.engine.stats(), _report(model)
        report["rank0_cache_bytes"] = model.engine.cache_bytes()
    finally:
        await _close(model)
    plain = GenerationEngine(port_module, name=f"{name}-plain",
                             **_engine_kwargs(config))
    try:
        want = await _run(plain, requests)
        report["plain_cache_bytes"] = plain.cache_bytes()
    finally:
        await plain.close()
    return got, want, stats, report


# ------------------------------------------------------------ dense slots

@pytest.mark.parametrize("mesh,split", [({"tp": 2}, 2), ({"dp": 2}, 1)])
async def test_dense_slots_under_a_mesh(tmp_path, tiny, port_module, mesh,
                                        split):
    """Dense slot rows (no block_size) shard on the heads under tp (and
    replicate under dp): every token the JAX greedy choice and the
    unsharded engine's; each rank's caches hold 1/split of the
    unsharded bytes."""
    requests = [(prompt(s, n), 8) for s, n in ((1, 5), (2, 20), (3, 40))]
    got, want, _, report = await _both(
        tmp_path, tiny, port_module, "dense", requests, mesh=mesh,
        block_size=None, cache_blocks=None)
    assert got == want == [tiny.greedy(p, n) for p, n in requests]
    assert report["cache_bytes"] * split == report["plain_cache_bytes"]
    assert report["rank0_cache_bytes"] == report["cache_bytes"]


# --------------------------------------------------------- chunked prefill

async def test_chunked_prefill_under_a_mesh(tmp_path, tiny, port_module):
    """Cold prompts land in chunks beside a live stream: the JAX greedy
    tokens and the unsharded engine's; the chunks ran."""
    requests = [(prompt(4, 10), 20), (prompt(5, 50), 6), (prompt(6, 40), 6)]
    got, want, stats, _ = await _both(
        tmp_path, tiny, port_module, "chunked", requests,
        prefill_chunk_tokens=32)
    assert got == want == [tiny.greedy(p, n) for p, n in requests]
    assert stats["chunked_prefill"]["chunks_dispatched"] >= 4


async def test_preempted_and_cancelled_chunks_leave_no_rank_waiting(
        tmp_path, tiny):
    """A mid-prefill slot yields its blocks to a live stream that cannot
    grow and restarts; another cold prompt is cancelled between its
    chunks.  Every stream after them still gets the JAX greedy tokens
    (a rank left inside a collective would time the next one out)."""
    model = _load(tmp_path, tiny, "preempt", mesh={"tp": 2},
                  **_config(max_seq=128, prefill_buckets=[16, 32, 128],
                            cache_blocks=9, prefill_chunk_tokens=16))
    engine = model.engine
    live, cold = prompt(41, 20), prompt(42, 112)
    try:
        got = await _run(engine, [(live, 40), (cold, 8)])
        assert engine.stats()["paged"]["preemptions"] >= 1
        assert engine.stats()["chunked_prefill"]["admissions"] >= 2
        chunks = engine.prefill_chunks
        req = engine.submit(prompt(43, 100), max_new_tokens=4)
        for _ in range(2000):
            if engine.prefill_chunks > chunks:
                break
            await asyncio.sleep(0.005)
        engine.cancel(req)
        after = await _run(engine, [(prompt(44, 30), 6)])
    finally:
        await _close(model)
    assert got == [tiny.greedy(live, 40), tiny.greedy(cold, 8)]
    assert after == [tiny.greedy(prompt(44, 30), 6)]


# ---------------------------------------------------- speculative decoding

def _repetitive(seed: int, n: int):
    head = prompt(seed, 6)
    return (head + [5, 9, 2, 7] * n)[:n]


@pytest.mark.parametrize("proposer", ["ngram", "draft"])
async def test_speculative_decoding_under_a_mesh(tmp_path, tiny,
                                                 port_module, proposer):
    """K = 3 proposals a wave, from the n-gram head (in the spec
    command's host input) or a self-draft on rank 0 alone, its proposals
    broadcast into the follower's verify: the JAX greedy tokens and the
    unsharded non-speculative engine's, with accepted proposals; the
    draft is booked and pinned as "<name>:draft" on rank 0, and the
    follower holds none."""
    spec = {"tokens": 3}
    if proposer == "draft":
        spec["draft"] = {"architecture": "decoder_tiny", "arch_kwargs": ARCH,
                         "window": 16}
    requests = [(_repetitive(s, 30), 16) for s in (7, 8)]
    hbm = HBMManager(budget_bytes=1 << 30)
    residency = ResidencyManager(hbm)
    model = _load(tmp_path, tiny, f"spec-{proposer}", mesh={"tp": 2},
                  hbm=hbm, residency=residency,
                  **_config(speculative=spec, prefill_chunk_tokens=32))
    try:
        engine = model.engine
        got = await _run(engine, requests)
        st = engine.stats()["speculative"]
        report = _report(model)
        booked = hbm.used_bytes
        rank0 = (engine.param_bytes() + engine.cache_bytes()
                 + engine.draft_param_bytes())
        draft_bytes = engine.draft_param_bytes()
        pinned = residency.state_of(f"spec-{proposer}:draft")
    finally:
        await _close(model)
        residency.close()
    plain = GenerationEngine(port_module, name="spec-plain",
                             **_engine_kwargs(_config()))
    try:
        want = await _run(plain, requests)
    finally:
        await plain.close()
    assert got == want == [tiny.greedy(p, n) for p, n in requests]
    assert st["waves"] > 0 and st["accepted_tokens"] > 0
    assert booked == rank0
    assert report["draft_param_bytes"] == 0
    if proposer == "draft":
        assert draft_bytes > 0 and pinned == "resident"
        assert st["proposer"] == "draft"
    else:
        assert draft_bytes == 0 and pinned is None


# ------------------------------------------------------------ host KV tier

async def test_host_tier_under_a_mesh(tmp_path, tiny, port_module):
    """P1, P2 evicting P1's blocks from a 4-block pool, P1 again: the
    spills gather both ranks' heads into rank 0's tier, the return visit
    faults both blocks back with each rank's heads, and the tokens are
    the JAX greedy rule's.  The spilled payloads equal the unsharded
    engine's within KV_ATOL; no follower holds a tier."""
    want = [tiny.greedy(p, 3) for p in (P1, P2, P1)]
    config = _config(max_slots=1, cache_blocks=4, host_tier_blocks=8)
    model = _load(tmp_path, tiny, "tier", mesh={"tp": 2}, **config)
    try:
        engine = model.engine
        assert await _turns(engine) == want
        st = await _settle(engine)
        tp2 = {c: engine.kv_tier.read(bytes.fromhex(c))
               for c in engine.kv_tier.chains()}
        report = _report(model)
        rank0_cache = engine.cache_bytes()
    finally:
        await _close(model)
    ht, ev = st["host_tier"], st["paged"]["evictions"]
    assert ev["capacity_spilled"] >= 2 and ev["capacity_dropped"] == 0
    assert ht["faulted_blocks"] == 2 and ht["fault_failures"] == 0
    assert st["paged"]["host_tier_tokens_saved"] == 2 * BS
    assert report["cache_bytes"] == rank0_cache
    plain = GenerationEngine(port_module, name="tier-plain",
                             **_engine_kwargs(config))
    try:
        assert await _turns(plain) == want
        await _settle(plain)
        ref = {c: plain.kv_tier.read(bytes.fromhex(c))
               for c in plain.kv_tier.chains()}
        block_bytes = plain.kv_tier.block_bytes
        assert plain.cache_bytes() == 2 * rank0_cache
    finally:
        await plain.close()
    assert set(tp2) == set(ref) and len(ref) >= 2
    for chain, payload in ref.items():
        assert len(tp2[chain]) == len(payload) == block_bytes
        np.testing.assert_allclose(np.frombuffer(tp2[chain], np.float32),
                                   np.frombuffer(payload, np.float32),
                                   atol=KV_ATOL, rtol=0)


async def test_heads_that_do_not_divide_replicate(tmp_path):
    """3 heads over tp 2: the pool replicates (each rank holds every
    head), the spill's gather is rank 0's own snapshot and a fault-back
    gives every rank the whole payload; the tokens are the JAX greedy
    rule's."""
    odd = TinyDecoder(ODD_ARCH)
    want = [odd.greedy(p, 3) for p in (P1, P2, P1)]
    config = _config(ODD_ARCH, max_slots=1, cache_blocks=4,
                     host_tier_blocks=8)
    model = _load(tmp_path, odd, "odd", mesh={"tp": 2}, **config)
    try:
        engine = model.engine
        assert not engine._heads_sharded
        assert await _turns(engine) == want
        st = await _settle(engine)
        report = _report(model)
        plain = GenerationEngine(odd.port(), name="odd-plain",
                                 **_engine_kwargs(config))
        full = plain.cache_bytes()
        await plain.close()
    finally:
        await _close(model)
    assert st["host_tier"]["faulted_blocks"] == 2
    assert report["cache_bytes"] == engine.cache_bytes() == full


# ------------------------------------------------------------- KV handoff

@pytest.mark.parametrize("writer", ["tp2", "unsharded"])
async def test_handoff_crosses_between_mesh_and_unsharded(
        tmp_path, tiny, port_module, writer):
    """The incumbent (tp2 or unsharded) exports P1's chains into a
    persistent tier; a successor of the other kind adopts the same bytes
    and serves the return visit by fault-back with the JAX greedy
    tokens (a tier is adopted by a model of its name)."""
    want = tiny.greedy(P1, 3)
    d = str(tmp_path / "kv")
    config = _config(max_slots=1, host_tier_blocks=8, host_tier_dir=d)

    async def mesh_turn():
        model = await asyncio.to_thread(_load, tmp_path, tiny, "handoff",
                                        mesh={"tp": 2}, **config)
        try:
            engine = model.engine
            adopted = engine.kv_tier.handoff["adopted"]
            toks = await _turns(engine, (P1,))
            faulted = engine.stats()["host_tier"]["faulted_blocks"]
            res = await asyncio.to_thread(engine.export_kv, 10.0)
            chains = {c: engine.kv_tier.read(bytes.fromhex(c))
                      for c in engine.kv_tier.chains()}
        finally:
            await _close(model)
        return toks, adopted, faulted, res, chains

    async def plain_turn():
        engine = GenerationEngine(port_module, name="handoff",
                                  **_engine_kwargs(config))
        try:
            adopted = engine.kv_tier.handoff["adopted"]
            toks = await _turns(engine, (P1,))
            faulted = engine.stats()["host_tier"]["faulted_blocks"]
            res = await asyncio.to_thread(engine.export_kv, 10.0)
            chains = {c: engine.kv_tier.read(bytes.fromhex(c))
                      for c in engine.kv_tier.chains()}
        finally:
            await engine.close()
        return toks, adopted, faulted, res, chains

    first, second = ((mesh_turn(), plain_turn()) if writer == "tp2"
                     else (plain_turn(), mesh_turn()))
    toks1, _, _, res, exported = await first
    assert toks1 == [want]
    assert res["exported"] >= 2 and res["failed"] == 0, res
    toks2, adopted, faulted, _, held = await second
    assert adopted == len(exported) >= 2
    assert {c: held[c] for c in exported} == exported
    assert toks2 == [want] and faulted >= 2
