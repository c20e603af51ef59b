"""The port's dense slot mode (a GenerationEngine without ``block_size``)
against the JAX package, on the CPU, in fp32.

A dense step is held against the JAX decoder's 2-tuple-cache ``apply``
(its writes with ``mode="drop"``); the engine's greedy and seeded tokens
against the JAX package's rules, teacher-forced (tests/torch_generation.
py), at several concurrencies and with a cancel; and the engine holds one
cache, written in place.
"""

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfserving_tpu_torch.engine.generator import GenerationEngine
from torch_generation import (
    ARCH,
    LOGPROB_ATOL,
    MAX_SEQ,
    RNG_SEED,
    TinyDecoder,
    complete_all,
    prompt,
)

S = 4


@pytest.fixture(scope="module")
def tiny():
    ref = TinyDecoder()
    return ref, ref.port()


def make_engine(port, **kw):
    kw.setdefault("max_slots", S)
    kw.setdefault("max_seq", MAX_SEQ)
    kw.setdefault("prefill_buckets", [16, 64])
    kw.setdefault("rng_seed", RNG_SEED)
    return GenerationEngine(port, **kw)


@pytest.mark.parametrize("lq", [1, 3])
def test_dense_step_matches_jax_two_tuple_apply(tiny, lq):
    """One step over the engine's own caches: live rows at the window's
    start and end, a row one past the window and a parked row (the
    max_seq sentinel), at Lq = 1 (decode) and Lq = 3 (a verify): the
    live rows' logits and the whole window of every cache equal the JAX
    apply's, written in place."""
    ref, port = tiny
    eng = make_engine(port)
    try:
        rng = np.random.default_rng(3)
        H, D = ARCH["num_heads"], ARCH["hidden_size"] // ARCH["num_heads"]
        start = [np.asarray(rng.normal(size=(S, MAX_SEQ, H, D)), np.float32)
                 for _ in range(2 * ARCH["num_layers"])]
        with torch.inference_mode():
            for (kc, vc), i in zip(eng._caches, range(0, len(start), 2)):
                kc[:, :MAX_SEQ] = torch.from_numpy(start[i])
                vc[:, :MAX_SEQ] = torch.from_numpy(start[i + 1])
        ptrs = [(kc.data_ptr(), vc.data_ptr()) for kc, vc in eng._caches]
        first = np.asarray([3, MAX_SEQ - lq, MAX_SEQ - 1, MAX_SEQ])
        positions = (first[:, None] + np.arange(lq)).astype(np.int32)
        ids = rng.integers(1, ARCH["vocab_size"], size=(S, lq)).astype(
            np.int32)
        want_logits, want_caches = ref.apply(
            ref.variables, jnp.asarray(ids), positions=jnp.asarray(positions),
            kv_cache=[(jnp.asarray(start[i]), jnp.asarray(start[i + 1]))
                      for i in range(0, len(start), 2)])
        with torch.inference_mode():
            got_logits, got_caches = port(
                torch.from_numpy(ids), positions=torch.from_numpy(positions),
                kv_cache=eng._kv(None))
        live = first < MAX_SEQ
        np.testing.assert_allclose(got_logits.numpy()[live],
                                   np.asarray(want_logits)[live],
                                   atol=LOGPROB_ATOL, rtol=0)
        for (gk, gv), (wk, wv), ptr in zip(got_caches, want_caches, ptrs):
            assert (gk.data_ptr(), gv.data_ptr()) == ptr   # in place
            np.testing.assert_allclose(gk[:, :MAX_SEQ].numpy(),
                                       np.asarray(wk), atol=LOGPROB_ATOL,
                                       rtol=0)
            np.testing.assert_allclose(gv[:, :MAX_SEQ].numpy(),
                                       np.asarray(wv), atol=LOGPROB_ATOL,
                                       rtol=0)
    finally:
        eng.shutdown_nowait()


@pytest.mark.parametrize("slots,steps_per_call,depth",
                         [(1, 1, 1), (2, 3, 2), (4, 4, 2)])
async def test_dense_greedy_matches_jax_at_concurrencies(tiny, slots,
                                                         steps_per_call,
                                                         depth):
    """More requests than slots (queued admission), prompts in both
    buckets, budgets that run to the end of a slot's row."""
    ref, port = tiny
    prompts = [prompt(i, n) for i, n in enumerate([5, 16, 17, 40, 3])]
    budgets = [12, 9, 20, MAX_SEQ - 40, 6]
    eng = make_engine(port, max_slots=slots, steps_per_call=steps_per_call,
                      pipeline_depth=depth)
    got = await complete_all(eng, [(p, n, {})
                                   for p, n in zip(prompts, budgets)])
    for (tokens, reason), p, n in zip(got, prompts, budgets):
        assert tokens == ref.greedy(p, n), (p, n)
        assert reason == "length"


async def test_dense_seeded_and_logprobs_follow_the_jax_rule(tiny):
    ref, port = tiny
    p1, p2 = prompt(11, 9), prompt(12, 20)
    eng = make_engine(port, steps_per_call=2)
    try:
        req = eng.submit(p2, max_new_tokens=7, logprobs=3)
        (sampled, _), (plain, _), lp_tokens = await asyncio.wait_for(
            asyncio.gather(
                eng.complete(p1, max_new_tokens=14, temperature=0.9,
                             seed=5),
                eng.complete(p2, max_new_tokens=10),
                _collect(eng, req)), timeout=120)
    finally:
        await eng.close()
    assert sampled == ref.sampled(p1, 14, 0.9, 5)
    assert sampled != ref.greedy(p1, 14)       # the noise did something
    assert plain == ref.greedy(p2, 10)
    assert lp_tokens == ref.greedy(p2, 7)
    seq = list(p2)
    for t, chosen in zip(lp_tokens, req.lp_chosen):
        lg = ref.logits(seq)[-1].astype(np.float64)
        lps = lg - lg.max() - np.log(np.sum(np.exp(lg - lg.max())))
        assert abs(chosen - lps[t]) < LOGPROB_ATOL
        seq.append(t)


async def _collect(eng, req):
    return [t async for t, _ in eng.stream(req) if t is not None]


async def test_dense_cancel_frees_the_slot_for_the_next(tiny):
    """A cancelled stream frees its slot at the next wave boundary; the
    request queued behind it then runs in that slot, whose row still
    holds the cancelled stream's k/v, and decodes the JAX tokens."""
    ref, port = tiny
    eng = make_engine(port, max_slots=1, steps_per_call=2)
    try:
        first = eng.submit(prompt(21, 30), max_new_tokens=60)
        second = eng.submit(prompt(22, 6), max_new_tokens=12)
        stream = eng.stream(first)
        await asyncio.wait_for(stream.__anext__(), timeout=60)
        eng.cancel(first)
        reason = None
        while reason is None:
            _, reason = await asyncio.wait_for(stream.__anext__(), timeout=60)
        assert reason == "cancelled"
        tokens = await asyncio.wait_for(_collect(eng, second), timeout=60)
        assert eng.tokens_generated < 60 + 12
    finally:
        await eng.close()
    assert tokens == ref.greedy(prompt(22, 6), 12)
    assert all(s is None for s in eng._slots)


def test_dense_engine_holds_one_cache(tiny):
    """cache_bytes is one [S, max_seq, H, D] k and v cache per layer (the
    sink position not counted); the engine allocates exactly that plus
    one sink position, and no paged state."""
    _, port = tiny
    eng = make_engine(port)
    try:
        H, D = ARCH["num_heads"], ARCH["hidden_size"] // ARCH["num_heads"]
        per_cache = S * MAX_SEQ * H * D * 4
        assert eng.cache_bytes() == per_cache * 2 * ARCH["num_layers"]
        assert len(eng._caches) == ARCH["num_layers"]
        for kc, vc in eng._caches:
            assert kc.shape == vc.shape == (S, MAX_SEQ + 1, H, D)
        stats = eng.stats()
        assert stats["cache_bytes"] == eng.cache_bytes()
        assert "paged" not in stats
        assert eng.cache_debug() == {"paged": False}
        assert eng._wave_table.shape == (S, 0)
    finally:
        eng.shutdown_nowait()


@pytest.mark.parametrize("kwargs,message", [
    (dict(prefill_chunk_tokens=32),
     "prefill_chunk_tokens requires the paged cache"),
    (dict(prefill_buckets=[16, 256]), "prefill bucket 256 exceeds max_seq"),
])
def test_dense_config_validation(tiny, kwargs, message):
    from kfserving_tpu_torch.protocol.errors import InvalidInput

    _, port = tiny
    with pytest.raises(InvalidInput, match=message):
        make_engine(port, **kwargs)
