"""The port's threefry noise (kfserving_tpu_torch.engine.threefry) against
``jax.random``, and the seeded sampling of the port's GenerationEngine
against the JAX generator's sampling rule, on the CPU.

jax 0.9 draws with threefry2x32 in the partitionable layout: keys,
folds, bits and uniforms must be equal bit for bit.  Gumbel values go
through a logarithm, whose float32 rounding differs between XLA and
torch by an ulp or two of the inner ``-log(u)``; near 0 the outer
logarithm turns that into many ulps of the (tiny) result, so the limit
is 4 ulps at the scale max(|g|, 1).  What sampling needs is the argmax
of ``logits / T + noise``: equal, with no near-tie at these seeds.

The generation check is teacher-forced: the JAX decoder's full forward
over prompt + the port's tokens gives each position's logits, and the
JAX rule (the reference's support mask, then the argmax of
``masked / T + jax.random.gumbel(fold_in(fold_in(PRNGKey(rng_seed),
seed), position))``) must pick the port's token at every position.  The
JAX GenerationEngine itself is not driven.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfserving_tpu.models.decoder import DecoderLM, decoder_tiny
from kfserving_tpu_torch.engine import threefry
from kfserving_tpu_torch.engine.generator import GenerationEngine
from kfserving_tpu_torch.models import create_model
from kfserving_tpu_torch.models import weights

SEEDS = [0, 1, 2 ** 31 - 1]
# Positions up to 4096 (the generate_4k context), folded after a seed.
POSITIONS = np.array([0, 1, 7, 128, 2047, 3021, 4095, 4096], np.int32)
GUMBEL_ULPS = 4
# A sampled argmax whose top two scores lie closer than this could flip
# on the logarithm's rounding or on cached-decode vs full-forward logits.
NEAR_TIE = 1e-3


def _keys(seed):
    """JAX and port keys [P, 2]: fold_in(fold_in(PRNGKey(seed), 977),
    position) for every position."""
    base = jax.random.fold_in(jax.random.PRNGKey(seed), 977)
    jax_keys = jax.vmap(lambda p: jax.random.fold_in(base, p))(
        jnp.asarray(POSITIONS))
    port_base = threefry.fold_in(threefry.prng_key(seed), 977)
    port_keys = threefry.fold_in(port_base, torch.from_numpy(POSITIONS))
    return jax_keys, port_keys


def _u32(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_folds_equal_jax(seed):
    assert _u32(jax.random.PRNGKey(seed)).tolist() == \
        threefry.prng_key(seed).tolist()
    jax_keys, port_keys = _keys(seed)
    np.testing.assert_array_equal(_u32(jax_keys), port_keys.numpy())


@pytest.mark.parametrize("n", [7, 1000, 50257])
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniforms_equal_jax(seed, n):
    jax_keys, port_keys = _keys(seed)
    bits = jax.vmap(lambda k: jax.random.bits(k, (n,)))(jax_keys)
    np.testing.assert_array_equal(_u32(bits),
                                  threefry.random_bits(port_keys, n).numpy())
    tiny = jnp.finfo(jnp.float32).tiny
    for lo, hi in ((tiny, 1.0), (0.0, 1.0)):
        want = jax.vmap(lambda k: jax.random.uniform(
            k, (n,), minval=lo, maxval=hi))(jax_keys)
        got = threefry.uniform(port_keys, n, float(lo), hi).numpy()
        np.testing.assert_array_equal(np.asarray(want).view(np.int32),
                                      got.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_and_sampled_argmax_match_jax(seed):
    n = 50257
    jax_keys, port_keys = _keys(seed)
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (n,)))(
        jax_keys)).astype(np.float64)
    got = threefry.gumbel(port_keys, n).numpy().astype(np.float64)
    ulp = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    assert np.all(np.abs(got - want) <= GUMBEL_ULPS * ulp)
    # The sampler's use: argmax of logits / T + noise, row by row.
    logits = np.random.default_rng(seed % 97).normal(
        0, 3, (len(POSITIONS), n)).astype(np.float32)
    for temp in (0.7, 1.0, 1.5):
        scores = logits / np.float32(temp) + want.astype(np.float32)
        top2 = np.sort(scores, axis=-1)[:, -2:]
        near_ties = int(np.sum(top2[:, 1] - top2[:, 0] < NEAR_TIE))
        assert near_ties == 0
        port_scores = logits / np.float32(temp) + got.astype(np.float32)
        np.testing.assert_array_equal(port_scores.argmax(-1),
                                      scores.argmax(-1))


# -- seeded generation, teacher-forced against the JAX rule ------------------
MAX_SEQ = 64
ARCH = dict(num_layers=2, hidden_size=64, num_heads=2,
            intermediate_size=128, max_seq=MAX_SEQ, vocab_size=96)
RNG_SEED = 7


def _jax_mask(logits, top_k, top_p):
    """The reference sampler's support mask (kfserving_tpu/engine/
    generator.py, mask_to_support) for one row."""
    logits = logits[None]
    top_ks, top_ps = jnp.asarray([top_k]), jnp.asarray([top_p])
    v = logits.shape[-1]
    sorted_desc = jnp.sort(logits, axis=-1)[:, ::-1]
    k_eff = jnp.where((top_ks <= 0) | (top_ks >= v), v, top_ks)
    kth = jnp.take_along_axis(sorted_desc, (k_eff - 1)[:, None], axis=-1)
    keep = logits >= kth
    probs = jax.nn.softmax(sorted_desc, axis=-1)
    cum = jnp.cumsum(probs, axis=-1)
    n_keep = jnp.maximum(jnp.sum((cum - probs) < top_ps[:, None], axis=-1),
                         1)
    p_thresh = jnp.take_along_axis(sorted_desc, (n_keep - 1)[:, None],
                                   axis=-1)
    keep &= logits >= p_thresh
    return jnp.where(keep, logits, jnp.finfo(logits.dtype).min)[0]


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

    def logits(seq):
        buf = np.zeros((1, MAX_SEQ), np.int32)
        buf[0, :len(seq)] = seq
        return np.asarray(apply(variables, jnp.asarray(buf)))[0, :len(seq)]

    return port, logits


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.9, 0, 1.0), (1.3, 5, 1.0), (0.8, 0, 0.85)])
async def test_seeded_generation_follows_the_jax_rule(tiny, temperature,
                                                      top_k, top_p):
    port, logits = tiny
    prompt, seed, steps = [5, 9, 2, 7, 11, 3], 11, 12
    eng = GenerationEngine(port, max_slots=2, max_seq=MAX_SEQ,
                           prefill_buckets=[16, MAX_SEQ], block_size=16,
                           steps_per_call=4, rng_seed=RNG_SEED)
    try:
        tokens, _ = await asyncio.wait_for(eng.complete(
            prompt, max_new_tokens=steps, temperature=temperature,
            top_k=top_k, top_p=top_p, seed=seed), timeout=120)
    finally:
        await eng.close()
    assert len(tokens) == steps
    base = jax.random.fold_in(jax.random.PRNGKey(RNG_SEED), seed)
    full = logits(prompt + tokens[:-1])
    near_ties = 0
    for i, token in enumerate(tokens):
        pos = len(prompt) + i       # the length the sampled token extends
        masked = _jax_mask(jnp.asarray(full[pos - 1]), top_k, top_p)
        noise = jax.random.gumbel(jax.random.fold_in(base, pos),
                                  (ARCH["vocab_size"],))
        scores = np.asarray(masked / max(temperature, 1e-6) + noise)
        top2 = np.sort(scores)[-2:]
        near_ties += int(top2[1] - top2[0] < NEAR_TIE)
        assert token == int(np.argmax(scores)), (i, token)
    assert near_ties == 0
    greedy = [int(np.argmax(logits(prompt + tokens[:i])[-1]))
              for i in range(steps)]
    assert tokens != greedy           # the noise did something
