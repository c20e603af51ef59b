"""The port's per-request cost attribution against the JAX package's, on
the CPU: the same records give the same lookups, top-K rankings and
registry families in both packages; on decoder_tiny the port's generator
finalizes one record per request on every terminal path (eos, length,
timeout, cancel), and the records' device ms sum to the engine's device
seconds (the additive decomposition).  The JAX GenerationEngine is not
driven.
"""

import asyncio
import contextvars

import numpy as np
import pytest
from torch_generation import MAX_SEQ, RNG_SEED, TinyDecoder

from kfserving_tpu.observability import REGISTRY as JAX_REGISTRY
from kfserving_tpu.observability import attribution as jax_attribution
from kfserving_tpu_torch import tracing
from kfserving_tpu_torch.engine.generator import GenerationEngine
from kfserving_tpu_torch.observability import REGISTRY, attribution
from kfserving_tpu_torch.reliability.deadline import Deadline, deadline_scope

FAMILIES = ("kfserving_tpu_request_device_ms",
            "kfserving_tpu_request_phase_tokens",
            "kfserving_tpu_request_held_blocks",
            "kfserving_tpu_request_cache_saved_tokens",
            "kfserving_tpu_request_host_tier_saved_tokens",
            "kfserving_tpu_generator_pool_occupancy_ratio",
            "kfserving_tpu_generator_pool_fragmentation_ratio")


@pytest.fixture(autouse=True)
def _clean():
    for mod in (attribution, jax_attribution):
        mod.clear()
    REGISTRY.reset()
    yield
    for mod in (attribution, jax_attribution):
        mod.clear()
    REGISTRY.reset()


def _records(seed: int, n: int):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        rec = {"trace_id": None if i % 5 == 4 else f"t{i}",
               "finish_reason": ("length", "eos", "timeout")[i % 3],
               "device_ms": {"prefill": round(float(rng.uniform(0, 9)), 3),
                             "decode": round(float(rng.uniform(0, 40)), 3)},
               "prefill_tokens": int(rng.integers(1, 4000)),
               "decode_tokens": int(rng.integers(0, 300)),
               "blocks_held": int(rng.integers(0, 40)),
               "cache_hit_blocks": int(rng.integers(0, 4)),
               "cache_saved_tokens": int(rng.integers(0, 400)),
               "host_tier_hit_blocks": 0,
               "host_tier_saved_tokens": int(rng.integers(0, 200)),
               "ts": 1.7e9 + i}
        out.append((("gen", "other")[i % 2], rec["trace_id"], rec))
    return out


def _family_lines(registry):
    return [line for line in registry.render_lines(exemplars=False)
            if any(family in line for family in FAMILIES)]


@pytest.mark.parametrize("capacity", [None, "16"])
def test_same_records_same_queries_and_families(capacity, monkeypatch):
    """observe, lookup, recent and top (by device ms and by held blocks,
    in and out of a window), the cost families and the pool-ratio gauges
    equal the JAX package's; past KFS_ATTRIBUTION_RECORDS the oldest
    record rotates out."""
    if capacity is not None:
        monkeypatch.setenv("KFS_ATTRIBUTION_RECORDS", capacity)
    for model, trace, rec in _records(3, 40):
        assert attribution.observe(model, trace, rec) == \
            jax_attribution.observe(model, trace, rec)
    for i in range(40):
        assert attribution.lookup(f"t{i}") == \
            jax_attribution.lookup(f"t{i}")
    assert (attribution.lookup("t0") is None) == (capacity is not None)
    assert attribution.recent(7) == jax_attribution.recent(7)
    for by in ("device_ms", "held_blocks"):
        for window in (None, 10.0):
            assert attribution.top(5, window_s=window, by=by,
                                   now=1.7e9 + 40) == \
                jax_attribution.top(5, window_s=window, by=by,
                                    now=1.7e9 + 40)
    with pytest.raises(ValueError):
        attribution.top(3, by="tokens")
    stats = {"paged": {"pool_occupancy_ratio": 1.3,
                       "fragmentation_ratio": 0.25}}
    assert attribution.publish_cache_gauges("gen", stats) == \
        jax_attribution.publish_cache_gauges("gen", stats) == set()
    port, ref = _family_lines(REGISTRY), _family_lines(JAX_REGISTRY)
    assert port == ref and len(port) > 40


@pytest.fixture(scope="module")
def tiny():
    ref = TinyDecoder()
    return ref, ref.port()


async def _run(eng, prompts):
    """Four requests, one per terminal path, each under its own trace
    id: "length" (the longest, so it outlives the others and no wave is
    left without a live row), "eos", a 30 ms budget ("timeout") and one
    cancelled after its second token."""
    async def traced(name, fn):
        tracing.current_request_id.set(name)
        return await fn()

    async def length():
        return await eng.complete(prompts["length"], max_new_tokens=40)

    async def eos():
        return await eng.complete(prompts["eos"], max_new_tokens=20)

    async def timeout():
        with deadline_scope(Deadline(0.03)):
            req = eng.submit(prompts["timeout"], max_new_tokens=60)
        return [e async for e in eng.stream(req)][-1]

    async def cancel():
        req = eng.submit(prompts["cancel"], max_new_tokens=30)
        seen = 0
        async for token, reason in eng.stream(req):
            seen += 1
            if seen == 2:
                eng.cancel(req)
            if reason is not None:
                return reason

    loop = asyncio.get_running_loop()
    tasks = [loop.create_task(traced(name, fn),
                              context=contextvars.copy_context())
             for name, fn in (("length", length), ("eos", eos),
                              ("timeout", timeout), ("cancel", cancel))]
    try:
        return await asyncio.wait_for(asyncio.gather(*tasks), timeout=120)
    finally:
        await eng.close()


def test_one_record_per_request_on_every_terminal_path(tiny):
    """One cost record per request with the reason its stream ended; the
    tokens and blocks it counts; prefill plus decode device ms summed over
    the records equals the engine's prefill and decode device seconds."""
    ref, port = tiny
    # Seed 13: the eos stream's sixth greedy token appears in no other
    # stream's tokens, so only that stream ends on it.
    rng = np.random.default_rng(13)
    prompts = {name: [int(t) for t in rng.integers(1, 96, n)]
               for name, n in (("length", 20), ("eos", 9),
                               ("timeout", 14), ("cancel", 30))}
    eos_id = ref.greedy(prompts["eos"], 6)[5]
    eng = GenerationEngine(port, max_slots=4, max_seq=MAX_SEQ,
                           prefill_buckets=[16, 32, 64], block_size=16,
                           steps_per_call=1, pipeline_depth=1,
                           rng_seed=RNG_SEED, eos_id=eos_id)
    length, eos, timeout, cancel = asyncio.run(_run(eng, prompts))
    assert length[1] == "length" and eos[1] == "eos"
    assert timeout == (None, "timeout") and cancel == "cancelled"
    records = {r["trace_id"]: r for r in attribution.recent(10)}
    assert set(records) == {"length", "eos", "timeout", "cancel"}
    for name, reason in (("length", "length"), ("eos", "eos"),
                         ("timeout", "timeout"), ("cancel", "cancelled")):
        rec = records[name]
        assert rec["finish_reason"] == reason and rec["model"] == eng.name
        assert rec["prefill_tokens"] == len(prompts[name])
        # (The 30 ms budget may run out before its prefill lands: then
        # the prefill's share goes to the rows still live.)
        assert rec["device_ms"]["prefill"] > 0 or name == "timeout"
        assert rec["blocks_held"] >= -(-len(prompts[name]) // 16)
    assert records["length"]["decode_tokens"] == 40
    assert records["eos"]["decode_tokens"] == 6     # the eos included
    assert records["cancel"]["decode_tokens"] >= 2
    total_ms = sum(r["device_ms"]["prefill"] + r["device_ms"]["decode"]
                   for r in records.values())
    engine_ms = (eng._prefill_device_s + eng._decode_device_s) * 1e3
    assert total_ms == pytest.approx(engine_ms, rel=1e-6, abs=4 * 5e-4)
    counts = {labels["phase"]: child.total for labels, child in
              REGISTRY.histogram(FAMILIES[0]).samples()}
    # One observation per record and phase that spent device time.
    assert counts == {phase: sum(1 for r in records.values()
                                 if r["device_ms"][phase] > 0)
                      for phase in ("prefill", "decode")}
    assert counts["decode"] >= 3
