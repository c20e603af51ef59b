"""The port's chunked prefill (paged GenerationEngine with
``prefill_chunk_tokens``) against the JAX package, on the CPU, in fp32.

A chunk's forward is held against the JAX decoder's paged ``apply`` with
``positions`` and ``logit_positions`` (the reference's
``chunk_prefill_fn``); chunked tokens against the monolithic engine's and
the JAX package's rules, teacher-forced (tests/torch_generation.py); the
reference's preemption restart, whole-hit chunk skip, configuration
errors and metric families.
"""

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfserving_tpu_torch.engine.generator import GenerationEngine
from kfserving_tpu_torch.observability.registry import REGISTRY
from kfserving_tpu_torch.protocol.errors import InvalidInput
from torch_generation import (
    ARCH,
    LOGPROB_ATOL,
    MAX_SEQ,
    RNG_SEED,
    TinyDecoder,
    complete_all,
    prompt,
)

BS = 16
CHUNK = 32


@pytest.fixture(scope="module")
def tiny():
    ref = TinyDecoder()
    return ref, ref.port()


def make_engine(port, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_seq", MAX_SEQ)
    kw.setdefault("prefill_buckets", [16, 32, 64, MAX_SEQ])
    kw.setdefault("block_size", BS)
    kw.setdefault("prefill_chunk_tokens", CHUNK)
    kw.setdefault("rng_seed", RNG_SEED)
    return GenerationEngine(port, **kw)


@pytest.mark.parametrize("start,width", [(0, CHUNK), (CHUNK, 20)])
def test_chunk_matches_jax_paged_apply(tiny, start, width):
    """One chunk over a pool: ids at positions [start, start + width),
    the padding queries of a partial chunk on the max_seq position (their
    writes drop), the head only at the last real query, the table row
    cut to the chunks so far; logits and pools equal the JAX apply's."""
    ref, port = tiny
    rng = np.random.default_rng(4)
    H, D = ARCH["num_heads"], ARCH["hidden_size"] // ARCH["num_heads"]
    NB = 8
    pools = [np.asarray(rng.normal(size=(NB, BS, H, D)), np.float32)
             for _ in range(2 * ARCH["num_layers"])]
    nb = (start + CHUNK) // BS
    table = rng.permutation(NB)[:nb].astype(np.int32)[None]
    ids = np.zeros((1, CHUNK), np.int32)
    ids[0, :width] = rng.integers(1, ARCH["vocab_size"], size=width)
    qpos = np.full((1, CHUNK), MAX_SEQ, np.int32)
    qpos[0, :width] = np.arange(start, start + width)
    last = np.asarray([width - 1], np.int32)
    want_logits, want_pools = ref.apply(
        ref.variables, jnp.asarray(ids), positions=jnp.asarray(qpos),
        kv_cache=[(jnp.asarray(pools[i]), jnp.asarray(pools[i + 1]),
                   jnp.asarray(table))
                  for i in range(0, len(pools), 2)],
        logit_positions=jnp.asarray(last))
    sink = [(0, 1), (0, 0), (0, 0), (0, 0)]
    port_pools = [torch.from_numpy(np.pad(p, sink)) for p in pools]
    with torch.inference_mode():
        got_logits, got_pools = port(
            torch.from_numpy(ids), positions=torch.from_numpy(qpos),
            kv_cache=[(port_pools[i], port_pools[i + 1],
                       torch.from_numpy(table))
                      for i in range(0, len(pools), 2)],
            logit_positions=torch.from_numpy(last))
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               atol=LOGPROB_ATOL, rtol=0)
    for (gk, gv), (wk, wv) in zip(got_pools, want_pools):
        np.testing.assert_allclose(gk[:NB].numpy(), np.asarray(wk),
                                   atol=LOGPROB_ATOL, rtol=0)
        np.testing.assert_allclose(gv[:NB].numpy(), np.asarray(wv),
                                   atol=LOGPROB_ATOL, rtol=0)


@pytest.mark.parametrize("sampling", [{}, {"temperature": 0.8, "seed": 3}])
async def test_chunked_tokens_equal_monolithic_and_jax(tiny, sampling):
    """Cold prompts (one past a chunk, block-aligned, a partial final
    chunk) beside live short streams: chunked tokens equal the monolithic
    engine's and the JAX rule, greedy and seeded."""
    ref, port = tiny
    cold = [prompt(31, 33), prompt(32, 64), prompt(33, 90)]
    live = [prompt(34, 7), prompt(35, 12)]
    requests = ([(p, 10, sampling) for p in cold]
                + [(p, 24, {}) for p in live])
    chunked = make_engine(port, steps_per_call=2)
    got = await complete_all(chunked, requests)
    stats = chunked.stats()["chunked_prefill"]
    mono = await complete_all(make_engine(port, prefill_chunk_tokens=None,
                                          steps_per_call=2), requests)
    assert [t for t, _ in got] == [t for t, _ in mono]
    for (tokens, _), (p, n, kw) in zip(got, requests):
        if kw:
            assert tokens == ref.sampled(p, n, kw["temperature"],
                                         kw["seed"])
        else:
            assert tokens == ref.greedy(p, n)
    assert stats["admissions"] == 3
    # ceil(33/32) + ceil(64/32) + ceil(90/32) chunks, none shared.
    assert stats["chunks_dispatched"] == 2 + 2 + 3
    assert stats["chunks_skipped_shared"] == 0


async def test_mid_prefill_preemption_restarts(tiny):
    """A cold prompt mid-prefill yields its blocks when a live stream
    cannot grow: it re-queues at the front, restarts its chunks later
    (a second chunked admission of the same request) and still decodes
    the JAX tokens, as does the stream it yielded to."""
    ref, port = tiny
    live, cold = prompt(41, 20), prompt(42, 112)
    eng = make_engine(port, max_slots=2, cache_blocks=9,
                      prefill_chunk_tokens=16, steps_per_call=2)
    try:
        live_task = asyncio.ensure_future(
            eng.complete(live, max_new_tokens=40))
        await asyncio.sleep(0)
        (cold_tokens, _), (live_tokens, _) = await asyncio.wait_for(
            asyncio.gather(eng.complete(cold, max_new_tokens=8), live_task),
            timeout=120)
        stats = eng.stats()
    finally:
        await eng.close()
    assert live_tokens == ref.greedy(live, 40)
    assert cold_tokens == ref.greedy(cold, 8)
    assert stats["paged"]["preemptions"] >= 1
    assert stats["chunked_prefill"]["admissions"] >= 2


async def test_whole_hit_chunks_are_skipped(tiny):
    """The same cold prompt again: every chunk but the final one is a
    whole-block prefix hit and skips its dispatch; the tokens do not
    change."""
    ref, port = tiny
    cold = prompt(51, 70)          # chunks of 32, 32 and 6 tokens
    eng = make_engine(port, steps_per_call=2)
    try:
        first, _ = await eng.complete(cold, max_new_tokens=6)
        before = eng.stats()["chunked_prefill"]
        again, _ = await eng.complete(cold, max_new_tokens=6)
        after = eng.stats()["chunked_prefill"]
        debug = eng.cache_debug()
    finally:
        await eng.close()
    assert first == again == ref.greedy(cold, 6)
    assert after["chunks_skipped_shared"] - before["chunks_skipped_shared"] \
        == 2
    assert after["chunks_dispatched"] - before["chunks_dispatched"] == 1
    # The four full blocks were each hit once.
    assert debug["index_entries"] == 4
    assert debug["reuse_depth"]["max"] == 1
    assert [c["hits"] for c in debug["hot_chains"]] == [1, 1, 1, 1]


@pytest.mark.parametrize("kwargs,message", [
    (dict(block_size=None), "prefill_chunk_tokens requires the paged "
     "cache"),
    (dict(prefill_chunk_tokens=24), "prefill_chunk_tokens 24 must be a "
     "multiple of block_size 16"),
    (dict(prefill_chunk_tokens=2 * MAX_SEQ), "prefill_chunk_tokens 256 "
     "exceeds max_seq 128"),
    (dict(prefill_buckets=[16, 32], prefill_chunk_tokens=64),
     "prefill_chunk_tokens 64 must not exceed the largest prefill bucket "
     "32"),
])
def test_chunk_config_errors_keep_the_jax_messages(tiny, kwargs, message):
    _, port = tiny
    with pytest.raises(InvalidInput, match=message):
        make_engine(port, **kwargs)


def test_cold_prompts_ride_no_bucket(tiny):
    """A cold prompt longer than the largest bucket is taken (chunked);
    max_seq bounds it, and a non-chunked engine refuses it."""
    _, port = tiny
    eng = make_engine(port, prefill_buckets=[16, 32, 64])
    mono = make_engine(port, prefill_buckets=[16, 32, 64],
                       prefill_chunk_tokens=None)
    try:
        with pytest.raises(InvalidInput, match="leaves no room"):
            eng.submit(prompt(61, MAX_SEQ))
        with pytest.raises(InvalidInput,
                           match="exceeds the largest prefill bucket"):
            mono.submit(prompt(61, 100))
    finally:
        eng.shutdown_nowait()
        mono.shutdown_nowait()

    async def run():
        e = make_engine(port, prefill_buckets=[16, 32, 64])
        return await complete_all(e, [(prompt(62, 100), 4, {})])

    tokens, reason = asyncio.run(run())[0]
    assert reason == "length" and len(tokens) == 4


async def test_chunk_families_are_published(tiny):
    """kfserving_tpu_generator_prefill_chunks_total{outcome} and the
    chunk stall histogram, one observation per dispatched chunk."""
    _, port = tiny
    REGISTRY.reset()
    cold = prompt(71, 70)
    eng = make_engine(port)
    try:
        await eng.complete(cold, max_new_tokens=3)
        await eng.complete(cold, max_new_tokens=3)
    finally:
        await eng.close()
    text = "\n".join(REGISTRY.render_lines(exemplars=False))
    REGISTRY.reset()
    assert ('kfserving_tpu_generator_prefill_chunks_total'
            '{outcome="dispatched"} 4') in text
    assert ('kfserving_tpu_generator_prefill_chunks_total'
            '{outcome="skipped_shared"} 2') in text
    assert "kfserving_tpu_generator_prefill_chunk_stall_ms_count 4" in text
    assert "kfserving_tpu_generator_prefix_reuse_depth_hits_count" in text
