"""The head dims the port's kernels take beyond 16-128: 80 and 96 (ViT-H/14,
Phi-2, GPT-NeoX-20B) and the TPU kernels' 192 and 256 (Gemma-2B), against
the JAX package on the CPU.

K1's and K2's plain versions (what their CUDA kernels are held against on
the card by chip_smoke.py) run against the Pallas kernels in interpret
mode where the JAX dispatchers would run them (D % 64 == 0) and against
the XLA paths those dispatchers take otherwise.  Then a decoder at D = 256
generates through the port's paged engine on the CPU (the JAX greedy rule,
teacher-forced, is the reference), and a ViT at D = 80 gives the JAX
ViT's logits.  Inputs come from numpy with fixed seeds.
"""

import asyncio
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from torch_generation import TinyDecoder, complete_all, prompt
from torch_parity import randomized

from kfserving_tpu.models import create_model as jax_create_model
from kfserving_tpu.ops import paged_attention as jax_paged
from kfserving_tpu.ops import pallas_attention
from kfserving_tpu.ops.attention import _xla_attention
from kfserving_tpu_torch.engine.generator import GenerationEngine
from kfserving_tpu_torch.models import create_model
from kfserving_tpu_torch.models import weights
from kfserving_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
)
from kfserving_tpu_torch.ops.paged_attention import paged_attention_kernel

# K1 plain vs Pallas interpret and XLA, fp32 on both sides: the sums run
# in another order (tests/test_torch_attention.py's bound).
FLASH_ATOL = FLASH_RTOL = 2e-3
# K2 plain vs Pallas interpret and XLA, fp32 (tests/test_torch_paged.py's).
PAGED_ATOL = PAGED_RTOL = 2e-5
# ViT logits, fp32 on both sides: summation order only (test_torch_vit.py).
VIT_ATOL = 1e-4


def _qkv(seed, B, L, H, D):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, L, H, D)).astype(np.float32)
                 for _ in range(3))


def _pallas_flash(q, k, v, causal, lengths):
    orig = pl.pallas_call
    try:
        pl.pallas_call = functools.partial(orig, interpret=True)
        out = pallas_attention.flash_attention.__wrapped__(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            block_q=32, block_k=32,
            kv_lengths=jnp.asarray(lengths, jnp.int32))
    finally:
        pl.pallas_call = orig
    return np.asarray(out)


def _xla_flash(q, k, v, causal, lengths):
    """The JAX dispatcher's XLA path: the suffix mask of the lengths, and
    the causal triangle."""
    L = q.shape[1]
    mask = (jnp.arange(L)[None, :]
            < jnp.asarray(lengths)[:, None])[:, None, None, :]
    if causal:
        mask = mask & jnp.tril(jnp.ones((L, L), jnp.bool_))[None, None]
    return np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), mask))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [80, 96, 192, 256])
def test_flash_plain_matches_jax_at_head_dim(D, causal):
    """B = 2, L = 64, H = 2, a full row and a 37-key row; the wrapper on a
    CPU tensor is the plain version."""
    q, k, v = _qkv(D, 2, 64, 2, D)
    lengths = [64, 37]
    t = [torch.from_numpy(a) for a in (q, k, v)]
    kw = dict(causal=causal, kv_lengths=torch.tensor(lengths))
    got = flash_attention_plain(*t, **kw).numpy()
    np.testing.assert_array_equal(flash_attention(*t, **kw).numpy(), got)
    xla = _xla_flash(q, k, v, causal, lengths)
    np.testing.assert_allclose(got, xla, atol=FLASH_ATOL, rtol=FLASH_RTOL)
    if D % 64 == 0:      # the JAX dispatcher's Pallas domain
        pallas = _pallas_flash(q, k, v, causal, lengths)
        np.testing.assert_allclose(got, pallas, atol=FLASH_ATOL,
                                   rtol=FLASH_RTOL)


# B = 4 rows over BS = 128, MB = 3, NB = 12: a full row, a row ending in a
# -1 tail, a row sharing row 0's first block, and a row of length 0.
PAGED_TABLE = [[0, 1, 2], [3, 4, -1], [0, 5, 6], [7, -1, -1]]
PAGED_LENGTHS = [384, 200, 129, 0]


@pytest.mark.parametrize("D", [80, 96, 192, 256])
def test_paged_plain_matches_jax_at_head_dim(D):
    rng = np.random.default_rng(D)
    q = rng.normal(size=(4, 1, 2, D)).astype(np.float32)
    pool_k, pool_v = (rng.normal(size=(12, 128, 2, D)).astype(np.float32)
                      for _ in range(2))
    table = np.asarray(PAGED_TABLE, np.int32)
    lengths = np.asarray(PAGED_LENGTHS, np.int32)
    got = paged_attention_kernel(
        torch.from_numpy(q), torch.from_numpy(pool_k),
        torch.from_numpy(pool_v), torch.from_numpy(table),
        torch.from_numpy(lengths)).numpy()
    assert np.all(got[3] == 0.0)       # length 0 gives exactly 0
    jax_args = [jnp.asarray(a) for a in (q, pool_k, pool_v, table, lengths)]
    # The XLA path averages V over an empty row instead: rows 0-2 only.
    xla = np.asarray(jax_paged.paged_attention_xla(*jax_args))
    np.testing.assert_allclose(got[:3], xla[:3], atol=PAGED_ATOL,
                               rtol=PAGED_RTOL)
    if D % 64 == 0:      # the JAX dispatcher's Pallas domain
        pallas = np.asarray(jax_paged.paged_attention_tpu.__wrapped__(
            *jax_args, interpret=True))
        np.testing.assert_allclose(got, pallas, atol=PAGED_ATOL,
                                   rtol=PAGED_RTOL)
        assert np.all(pallas[3] == 0.0)


# Gemma-2B's head dim at a test's size: 2 heads of 256, fp32.
D256_ARCH = dict(num_layers=2, hidden_size=512, num_heads=2,
                 intermediate_size=256, max_seq=128, vocab_size=96)


def test_decoder_at_head_dim_256_generates_the_jax_greedy_tokens():
    """The paged engine (prefill through K1's dispatcher, decode through
    K2's wrapper, both plain on the CPU) across block boundaries, against
    the JAX DecoderLM's greedy rule teacher-forced."""
    ref = TinyDecoder(D256_ARCH)
    port = ref.port()
    assert port.config.head_dim == 256
    engine = GenerationEngine(port, max_slots=4, max_seq=128,
                              prefill_buckets=[16, 32, 128], block_size=16)
    requests = [(prompt(1, 5), 14), (prompt(2, 16), 6), (prompt(3, 21), 12)]
    got = asyncio.run(complete_all(engine, [(p, n, {})
                                            for p, n in requests]))
    for (tokens, reason), (p, n) in zip(got, requests):
        assert tokens == ref.greedy(p, n), p
        assert reason == "length"


def test_vit_at_head_dim_80_matches_jax():
    """Patch 14 (ViT-H/14's), hidden 160 over 2 heads (D = 80), 42 px: L =
    (42 / 14)^2 + 1 = 10.  Randomized JAX variables carried across by
    vit_params_from_flax; the port through its dispatcher and through the
    plain version of K1 (the function its kernel computes on the card)."""
    arch = dict(image_size=42, patch_size=14, hidden_size=160, num_heads=2)
    spec = jax_create_model("vit_tiny", dtype="float32", **arch)
    variables = randomized(jax.eval_shape(lambda: spec.module.init(
        jax.random.PRNGKey(0), spec.example)), seed=3)
    images = np.random.default_rng(0).uniform(
        0.0, 1.0, (3, 42, 42, 3)).astype(np.float32)
    expect = np.asarray(jax.jit(spec.module.apply)(variables, images))
    model = weights.materialize(
        create_model("vit_tiny", dtype="float32", **arch).module,
        torch.device("cpu"),
        state_dict=weights.vit_params_from_flax(variables))
    assert model.config.head_dim == 80 and model.config.seq_len == 10
    x = torch.from_numpy(images)
    with torch.inference_mode():
        got = model(x).numpy()
        model.config.attn_fn = \
            lambda q, k, v, mask: flash_attention_plain(q, k, v)
        plain = model(x).numpy()
    assert got.shape == expect.shape == (3, 10)
    np.testing.assert_allclose(got, expect, atol=VIT_ATOL, rtol=0)
    np.testing.assert_allclose(plain, expect, atol=VIT_ATOL, rtol=0)
