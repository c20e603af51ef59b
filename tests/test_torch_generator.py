"""The port's paged GenerationEngine (kfserving_tpu_torch.engine.generator)
against the JAX decoder, on the CPU, in fp32.

The reference is the JAX package's DecoderLM forward on the same weights
(``jax.jit(module.apply)`` compiled once at a fixed padded length; causal
attention makes the padding inert), run greedily token by token.  The
JAX GenerationEngine itself is not driven here: the port's engine must
produce the decoder's greedy tokens whatever its scheduling does —
block boundaries, concurrency, prefix hits, pool pressure, growth
preemption and cancel.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfserving_tpu.models.decoder import DecoderLM, decoder_tiny
from kfserving_tpu_torch.engine.generator import GenerationEngine
from kfserving_tpu_torch.models import create_model
from kfserving_tpu_torch.models import weights
from kfserving_tpu_torch.protocol.errors import InvalidInput

MAX_SEQ = 64
BS = 16
ARCH = dict(num_layers=2, hidden_size=64, num_heads=2,
            intermediate_size=128, max_seq=MAX_SEQ, vocab_size=96)
# Engine logprobs vs log_softmax of the JAX full forward (fp32; the
# cached decode and the full forward sum in another order).
LOGPROB_ATOL = 1e-4


@pytest.fixture(scope="module")
def tiny():
    module = DecoderLM(decoder_tiny(**ARCH))
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(module.init)(jax.random.PRNGKey(0),
                                         jnp.zeros((1, 8), jnp.int32)))
    spec = create_model("decoder_tiny", **ARCH)
    port = weights.materialize(
        spec.module, torch.device("cpu"),
        state_dict=weights.decoder_params_from_flax(variables))
    apply = jax.jit(module.apply)
    cache = {}

    def logits(seq):
        """JAX full-forward logits [len(seq), V] of one sequence."""
        key = tuple(seq)
        if key not in cache:
            buf = np.zeros((1, MAX_SEQ), np.int32)
            buf[0, :len(seq)] = seq
            cache[key] = np.asarray(apply(variables,
                                          jnp.asarray(buf)))[0, :len(seq)]
        return cache[key]

    def greedy(prompt, steps):
        ids = [int(t) for t in prompt]
        for _ in range(steps):
            ids.append(int(np.argmax(logits(ids)[-1])))
        return ids[len(prompt):]

    return port, greedy, logits


def make_engine(port, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_seq", MAX_SEQ)
    kw.setdefault("prefill_buckets", [16, 32, MAX_SEQ])
    kw.setdefault("block_size", BS)
    return GenerationEngine(port, **kw)


async def _complete_all(eng, prompts, budget, **kw):
    try:
        return await asyncio.wait_for(asyncio.gather(*[
            eng.complete(p, max_new_tokens=budget, **kw)
            for p in prompts]), timeout=120)
    finally:
        await eng.close()


@pytest.mark.parametrize("steps_per_call,depth", [(1, 1), (3, 2)])
async def test_greedy_matches_jax_across_block_boundaries(
        tiny, steps_per_call, depth):
    """Concurrent prompts on and across block boundaries, budgets that
    cross them, at single-step and pipelined multi-step waves."""
    port, greedy, _ = tiny
    prompts = [[5, 9, 2, 7, 11],
               list(range(1, BS + 1)),          # exactly one block
               list(range(3, BS + 4)),          # just past a block
               [3, 1, 4]]
    budgets = [12, 5, 2 * BS, BS + 3]
    eng = make_engine(port, steps_per_call=steps_per_call,
                      pipeline_depth=depth)
    try:
        got = await asyncio.wait_for(asyncio.gather(*[
            eng.complete(p, max_new_tokens=n)
            for p, n in zip(prompts, budgets)]), timeout=120)
    finally:
        await eng.close()
    for (tokens, reason), p, n in zip(got, prompts, budgets):
        assert tokens == greedy(p, n), (p, n)
        assert reason == "length"


async def test_prefix_hit_preserves_output(tiny):
    port, greedy, _ = tiny
    shared = list(range(1, 2 * BS + 1))          # two full blocks
    p1, p2 = shared + [7, 7], shared + [9]
    eng = make_engine(port, max_slots=2)
    try:
        got1, _ = await eng.complete(p1, max_new_tokens=6)
        hits0 = eng.stats()["paged"]["prefix_hits"]
        got2, _ = await eng.complete(p2, max_new_tokens=6)
        hits1 = eng.stats()["paged"]["prefix_hits"]
    finally:
        await eng.close()
    assert got1 == greedy(p1, 6) and got2 == greedy(p2, 6)
    assert hits1 - hits0 == 2


async def test_pool_pressure_queues_not_fails(tiny):
    port, greedy, _ = tiny
    prompts = [[i + 1, i + 2, i + 3] for i in range(5)]
    eng = make_engine(port, cache_blocks=3, steps_per_call=1,
                      pipeline_depth=1)
    got = await _complete_all(eng, prompts, 6)
    assert [t for t, _ in got] == [greedy(p, 6) for p in prompts]


async def test_growth_preemption_resumes_exactly(tiny):
    port, greedy, _ = tiny
    prompts = [[(i * 7 + j) % 90 + 1 for j in range(42)]
               for i in range(3)]
    eng = make_engine(port, cache_blocks=10)
    try:
        got = await asyncio.wait_for(asyncio.gather(*[
            eng.complete(p, max_new_tokens=20) for p in prompts]),
            timeout=120)
        stats = eng.stats()["paged"]
    finally:
        await eng.close()
    assert [t for t, _ in got] == [greedy(p, 20) for p in prompts]
    assert stats["preemptions"] >= 1


async def test_cancel_releases_blocks(tiny):
    port, _, _ = tiny
    eng = make_engine(port, max_slots=2)
    try:
        req = eng.submit([1, 2, 3], max_new_tokens=50)
        stream = eng.stream(req)
        await asyncio.wait_for(stream.__anext__(), timeout=30)
        eng.cancel(req)
        # Tokens already queued drain first; the stream then ends.
        reason = None
        while reason is None:
            _, reason = await asyncio.wait_for(stream.__anext__(),
                                               timeout=30)
        assert reason == "cancelled"
        total = eng.stats()["paged"]["pool_blocks"]
        for _ in range(100):
            await asyncio.sleep(0.02)
            st = eng.stats()["paged"]
            if st["free_blocks"] + st["reclaimable_blocks"] == total:
                break
        assert st["free_blocks"] + st["reclaimable_blocks"] == total
    finally:
        await eng.close()


async def test_seeded_sampling_is_schedule_independent(tiny):
    """A seeded temperature request draws the same tokens alone, beside
    greedy requests, and when preempted and resumed; top_k=1 is
    greedy."""
    port, greedy, _ = tiny
    prompt = [(j * 3) % 90 + 1 for j in range(42)]
    sampling = dict(temperature=1.1, seed=9)
    alone = make_engine(port, max_slots=1)
    try:
        want, _ = await alone.complete(prompt, max_new_tokens=18,
                                       **sampling)
        top1, _ = await alone.complete(prompt, max_new_tokens=18,
                                       temperature=1.0, top_k=1, seed=3)
    finally:
        await alone.close()
    assert top1 == greedy(prompt, 18)
    assert want != greedy(prompt, 18)     # the noise did something
    beside = make_engine(port, max_slots=4)
    crowd = await _complete_all(beside, [prompt, [1, 2, 3], [4, 5]], 18,
                                **sampling)
    assert crowd[0][0] == want
    tight = make_engine(port, max_slots=4, cache_blocks=10)
    try:
        results = await asyncio.wait_for(asyncio.gather(
            tight.complete(prompt, max_new_tokens=18, **sampling),
            tight.complete([(j * 5) % 90 + 1 for j in range(42)],
                           max_new_tokens=18),
            tight.complete([(j * 11) % 90 + 1 for j in range(42)],
                           max_new_tokens=18)), timeout=120)
        preemptions = tight.stats()["paged"]["preemptions"]
    finally:
        await tight.close()
    assert results[0][0] == want
    assert preemptions >= 1


async def test_top_p_and_top_k_sampling_stays_in_support(tiny):
    port, _, logits = tiny
    prompt = [7, 3, 9, 1]
    eng = make_engine(port, max_slots=2)
    try:
        tokens, _ = await eng.complete(prompt, max_new_tokens=8,
                                       temperature=2.0, top_k=3,
                                       top_p=0.9, seed=1)
    finally:
        await eng.close()
    seq = list(prompt)
    for t in tokens:
        assert t in np.argsort(logits(seq)[-1])[::-1][:3]
        seq.append(t)


async def test_logprobs_equal_log_softmax_of_full_forward(tiny):
    port, greedy, logits = tiny
    prompt = [11, 2, 33, 4, 5, 6]
    eng = make_engine(port, max_slots=2, steps_per_call=2)
    try:
        req = eng.submit(prompt, max_new_tokens=7, logprobs=3)
        tokens = [t async for t, _ in eng.stream(req) if t is not None]
    finally:
        await eng.close()
    assert tokens == greedy(prompt, 7)
    assert len(req.lp_chosen) == len(req.lp_top) == 7
    seq = list(prompt)
    for t, chosen, top in zip(tokens, req.lp_chosen, req.lp_top):
        lg = logits(seq)[-1].astype(np.float64)
        lps = lg - np.log(np.sum(np.exp(lg - lg.max()))) - lg.max()
        assert abs(chosen - lps[t]) < LOGPROB_ATOL
        want_ids = list(np.argsort(lps)[::-1][:3])
        assert [i for i, _ in top] == want_ids
        np.testing.assert_allclose([p for _, p in top], lps[want_ids],
                                   atol=LOGPROB_ATOL, rtol=0)
        seq.append(t)


@pytest.mark.parametrize("kwargs,message", [
    (dict(steps_per_call=0), "steps_per_call must be >= 1"),
    (dict(pipeline_depth=0), "pipeline_depth must be >= 1"),
    (dict(max_seq=128), "exceeds the model's position table"),
    (dict(prefill_buckets=[16, 128]), "prefill bucket 128 exceeds max_seq"),
    (dict(block_size=None, prefill_chunk_tokens=32),
     "prefill_chunk_tokens requires the paged cache"),
    (dict(block_size=24, prefill_buckets=[48]), "must be a multiple of "
     "block_size 24"),
    (dict(block_size=32, prefill_buckets=[16, 64]), "prefill bucket 16 "
     "must be a multiple of block_size 32"),
])
def test_engine_config_validation(tiny, kwargs, message):
    port, _, _ = tiny
    with pytest.raises(InvalidInput, match=message):
        make_engine(port, **kwargs)


@pytest.mark.parametrize("prompt,kwargs,message", [
    ([], {}, "empty prompt"),
    (list(range(1, 70)), {}, "exceeds the largest prefill bucket"),
    ([1, 96], {}, r"token ids must be in \[0, 96\)"),
    (list(range(1, 40)), {}, "prompt needs 3 cache blocks but the pool "
     "holds 2"),
    ([1, 2], dict(max_new_tokens=0), "max_new_tokens must be >= 1"),
    ([1, 2], dict(top_p=0.0), r"top_p must be in \(0, 1\]"),
    ([1, 2], dict(top_k=-1), "top_k must be >= 0"),
    ([1, 2], dict(logprobs=9), r"logprobs must be in \[0, 5\]"),
    (list(range(64)), {}, "leaves no room to generate"),
])
def test_submit_validation(tiny, prompt, kwargs, message):
    port, _, _ = tiny
    eng = make_engine(port, cache_blocks=2 if "pool" in message else None)
    try:
        with pytest.raises(InvalidInput, match=message):
            eng.submit(prompt, **kwargs)
    finally:
        eng.shutdown_nowait()


def test_cache_bytes_count_the_pool_not_the_sink(tiny):
    port, _, _ = tiny
    eng = make_engine(port, cache_blocks=6)
    try:
        per_block = BS * 2 * 32 * 4           # BS x H x D x fp32
        assert eng.cache_bytes() == 6 * per_block * 2 * 2
        assert eng.stats()["paged"]["pool_blocks"] == 6
        assert eng._caches[0][0].shape[0] == 7
    finally:
        eng.shutdown_nowait()
