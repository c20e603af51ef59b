"""The port's speculative decoding (``engine/speculative.py`` and the
engine's spec waves) against the JAX package, on the CPU, in fp32.

The proposers are held against the JAX package's (``NGramProposer`` and
``rolling_windows`` on seeded histories; the draft proposer against the
jitted ``make_draft_proposer`` on the same weights); the verify forward
against the JAX decoder's K + 1-position ``apply``; the n-gram and draft
arms' tokens against non-speculative decode and the JAX rules
(tests/torch_generation.py), the fault sites' fallback, ``spec_debug``'s
keys, and the draft's pinned registration and ledger booking.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfserving_tpu.engine import speculative as jax_spec
from kfserving_tpu_torch.engine import speculative
from kfserving_tpu_torch.engine.generator import GenerationEngine
from kfserving_tpu_torch.engine.hbm import HBMManager
from kfserving_tpu_torch.engine.residency import ResidencyManager
from kfserving_tpu_torch.observability.registry import REGISTRY
from kfserving_tpu_torch.predictors.llm import GenerativeModel
from kfserving_tpu_torch.reliability.faults import faults
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
K = 3
WINDOW = 16


@pytest.fixture(scope="module")
def tiny():
    ref = TinyDecoder()
    return ref, ref.port()


def make_engine(port, draft=None, **kw):
    kw.setdefault("max_slots", 3)
    kw.setdefault("max_seq", MAX_SEQ)
    kw.setdefault("prefill_buckets", [16, 32, 64])
    kw.setdefault("block_size", BS)
    kw.setdefault("steps_per_call", 2)
    kw.setdefault("rng_seed", RNG_SEED)
    spec = {"tokens": K}
    if draft is not None:
        spec.update(draft_module=draft, draft_window=WINDOW)
    kw.setdefault("speculative", spec)
    return GenerationEngine(port, **kw)


def _repetitive(seed: int, n: int):
    """A prompt whose tail repeats: what the n-gram head exploits."""
    head = prompt(seed, 6)
    return (head + [5, 9, 2, 7] * n)[:n]


@pytest.mark.parametrize("seed", range(6))
def test_ngram_and_windows_equal_jax(seed):
    rng = np.random.default_rng(seed)
    hist = [int(t) for t in rng.integers(0, 6, size=rng.integers(0, 40))]
    for k in (1, 3, 5):
        assert speculative.NGramProposer(k).propose(hist) == \
            jax_spec.NGramProposer(k).propose(hist)
    hists = [[int(t) for t in rng.integers(0, 90, size=n)]
             for n in (0, 3, 17, 40)]
    rows = [2, 0, 4, 3]
    np.testing.assert_array_equal(
        speculative.rolling_windows(hists, 5, rows, 16),
        jax_spec.rolling_windows(hists, 5, rows, 16))


def test_draft_proposer_equals_jax(tiny):
    ref, port = tiny
    rng = np.random.default_rng(8)
    ids = rng.integers(0, ARCH["vocab_size"], size=(3, WINDOW)).astype(
        np.int32)
    ids[1, :5] = 0                         # a left-padded window
    want = np.asarray(jax_spec.make_draft_proposer(
        jax, ref.jax_module, 3, WINDOW, 4)(ref.variables, jnp.asarray(ids)))
    propose = speculative.make_draft_proposer(port, 3, WINDOW, 4)
    with torch.inference_mode():
        got = propose(torch.from_numpy(ids)).numpy()
    assert got.dtype == np.int32 and got.shape == (3, 4)
    np.testing.assert_array_equal(got, want)


def test_verify_logits_equal_jax_k_plus_1_apply(tiny):
    """The verify dispatch's forward (the decoder's stepwise mode, each
    position at the decode step's shapes): rows at [L, L + K] over a
    paged pool (one parked on max_seq), logits at all K + 1 positions,
    against the JAX Lq = K + 1 apply with multi-position
    logit_positions; the stepwise logits equal the port's plain Lq > 1
    forward too."""
    ref, port = tiny
    rng = np.random.default_rng(9)
    H, D = ARCH["num_heads"], ARCH["hidden_size"] // ARCH["num_heads"]
    NB, S, MB = 10, 3, MAX_SEQ // BS
    pools = [np.asarray(rng.normal(size=(NB, BS, H, D)), np.float32)
             for _ in range(2 * ARCH["num_layers"])]
    table = np.full((S, MB), -1, np.int32)
    table[0, :2] = [3, 7]
    table[1, :3] = [1, 4, 9]
    tokens = rng.integers(1, ARCH["vocab_size"], size=(S, K + 1)).astype(
        np.int32)
    qpos = np.asarray([[14], [30], [MAX_SEQ]], np.int32) + np.arange(K + 1)
    gather = np.broadcast_to(np.arange(K + 1, dtype=np.int32), (S, K + 1))
    want, _ = ref.apply(
        ref.variables, jnp.asarray(tokens), positions=jnp.asarray(qpos),
        kv_cache=[(jnp.asarray(pools[i]), jnp.asarray(pools[i + 1]),
                   jnp.asarray(table)) for i in range(0, len(pools), 2)],
        logit_positions=jnp.asarray(gather))
    sink = [(0, 1), (0, 0), (0, 0), (0, 0)]

    def run(**kw):
        port_pools = [torch.from_numpy(np.pad(p, sink)) for p in pools]
        with torch.inference_mode():
            return port(
                torch.from_numpy(tokens), positions=torch.from_numpy(qpos),
                kv_cache=[(port_pools[i], port_pools[i + 1],
                           torch.from_numpy(table))
                          for i in range(0, len(pools), 2)], **kw)[0]

    got = run(stepwise=True)
    plain = run(logit_positions=torch.from_numpy(
        np.ascontiguousarray(gather)))
    assert got.shape == plain.shape == (S, K + 1, ARCH["vocab_size"])
    np.testing.assert_allclose(got.numpy()[:2], np.asarray(want)[:2],
                               atol=LOGPROB_ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy()[:2], plain.numpy()[:2],
                               atol=LOGPROB_ATOL, rtol=0)


def _requests():
    return [(_repetitive(1, 40), 20, {}),
            (_repetitive(2, 28), 16, {"temperature": 0.8, "seed": 4}),
            (prompt(3, 9), 12, {})]


@pytest.mark.parametrize("arm", ["ngram", "draft"])
async def test_spec_arms_equal_plain_decode_and_jax(tiny, arm):
    ref, port = tiny
    draft = port if arm == "draft" else None
    eng = make_engine(port, draft)
    got = await complete_all(eng, _requests())
    spec = eng.spec_debug()
    plain = await complete_all(make_engine(port, speculative={}),
                               _requests())
    assert [t for t, _ in got] == [t for t, _ in plain]
    for (tokens, _), (p, n, kw) in zip(got, _requests()):
        want = (ref.sampled(p, n, kw["temperature"], kw["seed"]) if kw
                else ref.greedy(p, n))
        assert tokens == want
    assert spec["proposer"] == arm and spec["waves"] > 0
    assert spec["accepted_tokens"] > 0      # the proposals paid off
    # Prefills emit each stream's first token, and a plain (re-synced)
    # wave decodes a slot whose first token is still in flight.
    assert spec["accepted_tokens"] < spec["emitted_tokens"] <= sum(
        n for _, n, _ in _requests()) - len(_requests())


async def test_dense_spec_equals_plain(tiny):
    ref, port = tiny
    eng = make_engine(port, block_size=None)
    got = await complete_all(eng, _requests())
    for (tokens, _), (p, n, kw) in zip(got, _requests()):
        want = (ref.sampled(p, n, kw["temperature"], kw["seed"]) if kw
                else ref.greedy(p, n))
        assert tokens == want


@pytest.mark.parametrize("site", ["draft", "verify"])
async def test_fault_sites_fall_back_with_the_same_tokens(tiny, site):
    ref, port = tiny
    REGISTRY.reset()
    faults.configure({f"engine.spec_{site}": {"fail_first": 3}})
    try:
        eng = make_engine(port, port)
        got = await complete_all(eng, _requests())
    finally:
        faults.reset()
    for (tokens, _), (p, n, kw) in zip(got, _requests()):
        want = (ref.sampled(p, n, kw["temperature"], kw["seed"]) if kw
                else ref.greedy(p, n))
        assert tokens == want
    assert eng.spec_fallbacks == {site: 3}
    text = "\n".join(REGISTRY.render_lines(exemplars=False))
    REGISTRY.reset()
    assert (f'kfserving_tpu_specdec_fallbacks_total{{model="decoder",'
            f'site="{site}"}} 3') in text
    assert eng.spec_waves > 0


async def test_spec_debug_has_the_jax_keys(tiny):
    _, port = tiny
    REGISTRY.reset()
    eng = make_engine(port)
    await complete_all(eng, _requests())
    debug = eng.spec_debug()
    assert set(debug) == {
        "tokens", "proposer", "waves", "proposed_tokens",
        "accepted_tokens", "emitted_tokens", "acceptance_rate",
        "accepted_length_p50", "accepted_length_p99", "draft_device_s",
        "verify_device_s", "draft_param_bytes", "fallbacks"}
    assert debug["tokens"] == K and debug["draft_param_bytes"] == 0
    assert 1 <= debug["accepted_length_p50"] <= K + 1
    assert eng.stats()["speculative"] == debug
    assert eng.cache_debug()["speculative"] == debug
    text = "\n".join(REGISTRY.render_lines(exemplars=False))
    REGISTRY.reset()
    for family in ("proposed_tokens_total", "accepted_tokens_total",
                   "accepted_length_tokens_count", "draft_ms_count",
                   "acceptance_ratio"):
        assert f"kfserving_tpu_specdec_{family}" in text


def test_draft_registers_pinned_and_booked(tmp_path):
    """A self-draft (no model_dir of its own) materializes through the
    param cache on the target's weights, registers as "<name>:draft",
    resident and pinned, and the ledger books target + cache + draft;
    unload deregisters and releases it."""
    arch = dict(ARCH)
    config = {"architecture": "decoder_tiny", "arch_kwargs": arch,
              "max_slots": 2, "max_seq": MAX_SEQ,
              "prefill_buckets": [32, 64], "block_size": BS,
              "cache_blocks": 16, "prefill_chunk_tokens": 32,
              "speculative": {"tokens": K, "draft": {
                  "architecture": "decoder_tiny", "arch_kwargs": arch,
                  "window": WINDOW}}}
    model_dir = os.path.join(str(tmp_path), "gen")
    os.makedirs(model_dir)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(config, f)
    hbm = HBMManager(budget_bytes=1 << 30)
    residency = ResidencyManager(hbm)
    model = GenerativeModel("gen", model_dir, device="cpu", hbm=hbm,
                            residency=residency)
    try:
        model.load()
        engine = model.engine
        draft = model._draft_handle
        assert draft.name == "gen:draft" and not draft.offloadable
        assert residency.state_of("gen:draft") == "resident"
        assert engine.draft_param_bytes() == draft.param_bytes() > 0
        assert engine.draft_param_bytes() == engine.param_bytes()
        assert hbm.used_bytes == (engine.param_bytes()
                                    + engine.cache_bytes()
                                    + engine.draft_param_bytes())
        for a, b in zip(draft.module.parameters(),
                        model.module.parameters()):
            assert torch.equal(a, b)       # self-draft: the same weights
        with pytest.raises(RuntimeError, match="pinned"):
            draft.offload()
        assert engine.stats()["speculative"]["proposer"] == "draft"
        model.unload()
        assert residency.state_of("gen:draft") is None
        assert draft.offloadable and hbm.used_bytes == 0
    finally:
        residency.close()
