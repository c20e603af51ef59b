"""Parity of the port's decoder (kfserving_tpu_torch.models.decoder) with
the JAX package's, on shared weights, in every cache mode.

Weights come from the JAX package's ``init_params(spec, seed)`` and reach
the port through ``decoder_params_from_flax``; token ids, pools and
positions come from numpy with fixed seeds.  Both sides run on the CPU.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from kfserving_tpu.models import create_model as jax_create_model
from kfserving_tpu.models import init_params
from kfserving_tpu_torch.models import create_model
from kfserving_tpu_torch.models import weights

# fp32: both sides compute in float32; summation order differs.
FP32_ATOL = 1e-4
# bf16: both sides round activations to bf16 after every dense layer
# (8 mantissa bits) in different places over 2 layers and the tied head;
# logits are O(1) and compared at a few bf16 ulps of that.
BF16_ATOL = 0.1

ARCH = dict(num_layers=2, hidden_size=64, num_heads=2,
            intermediate_size=128, max_seq=64, vocab_size=96)
B, L, H, D, BS, NB, MB = 3, 16, 2, 32, 8, 12, 4


@pytest.fixture(scope="module")
def jax_side():
    spec = jax_create_model("decoder_tiny", **ARCH)
    variables = jax.tree_util.tree_map(np.asarray, init_params(spec, 0))
    return spec.module, variables


def _port(variables, dtype="float32"):
    spec = create_model("decoder_tiny", dtype=dtype, **ARCH)
    sd = weights.decoder_params_from_flax(variables)
    return weights.materialize(spec.module, torch.device("cpu"),
                               state_dict=sd)


def _jax_module(dtype):
    return jax_create_model("decoder_tiny", dtype=dtype, **ARCH).module


def _jit_cached(module):
    """The JAX module's cache-mode forward, jitted: one compile per
    shape instead of one per primitive in eager mode."""
    return jax.jit(lambda v, i, p, c: module.apply(v, i, positions=p,
                                                   kv_cache=c))


def _ids(seed=0, shape=(B, L)):
    rng = np.random.default_rng(seed)
    return rng.integers(0, ARCH["vocab_size"], size=shape).astype(np.int32)


@pytest.mark.parametrize("dtype,atol", [("float32", FP32_ATOL),
                                        ("bfloat16", BF16_ATOL)])
def test_full_mode_logits_match_jax(jax_side, dtype, atol):
    _, variables = jax_side
    ids = _ids()
    want = np.asarray(jax.jit(_jax_module(dtype).apply)(
        variables, jnp.asarray(ids)))
    with torch.no_grad():
        got = _port(variables, dtype)(torch.from_numpy(ids))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


@pytest.mark.parametrize("logit_shape", ["rows", "positions"])
def test_prefill_logits_and_caches_match_jax(jax_side, logit_shape):
    module, variables = jax_side
    ids = _ids(1)
    lengths = np.asarray([16, 9, 1], np.int32)
    if logit_shape == "rows":
        logit_pos = lengths - 1
    else:
        logit_pos = np.asarray([[0, 15], [3, 8], [0, 0]], np.int32)
    want_logits, want_caches = jax.jit(
        lambda v, i, n, p: module.apply(v, i, kv_lengths=n,
                                        return_cache=True,
                                        logit_positions=p))(
        variables, jnp.asarray(ids), jnp.asarray(lengths),
        jnp.asarray(logit_pos))
    with torch.no_grad():
        got_logits, got_caches = _port(variables)(
            torch.from_numpy(ids), kv_lengths=torch.from_numpy(lengths),
            return_cache=True, logit_positions=torch.from_numpy(logit_pos))
    assert got_logits.shape == (B, 1 if logit_shape == "rows" else 2,
                                ARCH["vocab_size"])
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               atol=FP32_ATOL, rtol=0)
    for (gk, gv), (wk, wv) in zip(got_caches, want_caches):
        np.testing.assert_allclose(gk.numpy(), np.asarray(wk),
                                   atol=FP32_ATOL, rtol=0)
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv),
                                   atol=FP32_ATOL, rtol=0)


def _paged_state(seed):
    rng = np.random.default_rng(seed)
    pools = [(rng.normal(size=(NB, BS, H, D)).astype(np.float32),
              rng.normal(size=(NB, BS, H, D)).astype(np.float32))
             for _ in range(ARCH["num_layers"])]
    table = np.asarray([[0, 1, 2, -1], [3, 4, -1, -1], [5, 0, 6, 7]],
                       np.int32)    # rows 0 and 2 share block 0
    return pools, table


def _run_paged(module, variables, port_model, ids, positions, seed):
    pools, table = _paged_state(seed)
    want_logits, want_pools = _jit_cached(module)(
        variables, jnp.asarray(ids), jnp.asarray(positions),
        [(jnp.asarray(k), jnp.asarray(v), jnp.asarray(table))
         for k, v in pools])
    sink = np.zeros((1, BS, H, D), np.float32)
    port_pools = [(torch.from_numpy(np.concatenate([k, sink])),
                   torch.from_numpy(np.concatenate([v, sink])))
                  for k, v in pools]
    shared_table = torch.from_numpy(table)     # one table for all layers
    with torch.no_grad():
        got_logits, got_pools = port_model(
            torch.from_numpy(ids), positions=torch.from_numpy(positions),
            kv_cache=[(k, v, shared_table) for k, v in port_pools])
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               atol=FP32_ATOL, rtol=0)
    for (gk, gv), (wk, wv) in zip(got_pools, want_pools):
        np.testing.assert_allclose(gk[:NB].numpy(), np.asarray(wk),
                                   atol=FP32_ATOL, rtol=0)
        np.testing.assert_allclose(gv[:NB].numpy(), np.asarray(wv),
                                   atol=FP32_ATOL, rtol=0)


def test_paged_decode_step_matches_jax(jax_side):
    """Lq == 1: the step's k/v land through the table (row 1 writes past
    its allocated blocks and drops), then attention over the pool."""
    module, variables = jax_side
    ids = _ids(2, (B, 1))
    positions = np.asarray([[20], [17], [29]], np.int32)
    _run_paged(module, variables, _port(variables), ids, positions, 3)


def test_paged_multi_token_step_matches_jax(jax_side):
    """Lq > 1: per-query causal attention over the pool after the
    chunk's writes."""
    module, variables = jax_side
    ids = _ids(4, (B, 4))
    positions = np.asarray([[8, 9, 10, 11], [12, 13, 14, 15],
                            [24, 25, 26, 27]], np.int32)
    _run_paged(module, variables, _port(variables), ids, positions, 5)


def test_dense_cache_step_matches_jax(jax_side):
    """The dense 2-tuple cache: writes at or past max_seq drop.  The
    port's cache carries one sink position past the window, which the
    dropped writes land in; the step writes the given tensors in place
    and returns them."""
    module, variables = jax_side
    rng = np.random.default_rng(6)
    caches = [(rng.normal(size=(B, 64, H, D)).astype(np.float32),
               rng.normal(size=(B, 64, H, D)).astype(np.float32))
              for _ in range(ARCH["num_layers"])]
    ids = _ids(7, (B, 1))
    positions = np.asarray([[5], [63], [64]], np.int32)
    want_logits, want_caches = _jit_cached(module)(
        variables, jnp.asarray(ids), jnp.asarray(positions),
        [(jnp.asarray(k), jnp.asarray(v)) for k, v in caches])
    sink = [(0, 0), (0, 1), (0, 0), (0, 0)]
    port_caches = [(torch.from_numpy(np.pad(k, sink)),
                    torch.from_numpy(np.pad(v, sink))) for k, v in caches]
    with torch.no_grad():
        got_logits, got_caches = _port(variables)(
            torch.from_numpy(ids), positions=torch.from_numpy(positions),
            kv_cache=port_caches)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               atol=FP32_ATOL, rtol=0)
    for (gk, gv), (pk, pv), (wk, wv) in zip(got_caches, port_caches,
                                            want_caches):
        assert gk is pk and gv is pv
        np.testing.assert_allclose(gk[:, :64].numpy(), np.asarray(wk),
                                   atol=FP32_ATOL, rtol=0)
        np.testing.assert_allclose(gv[:, :64].numpy(), np.asarray(wv),
                                   atol=FP32_ATOL, rtol=0)


def test_state_dict_covers_every_parameter(jax_side):
    _, variables = jax_side
    sd = weights.decoder_params_from_flax(variables)
    module = create_model("decoder_tiny", **ARCH).module
    assert set(sd) == set(module.state_dict())
    n_jax = sum(np.asarray(x).size
                for x in jax.tree_util.tree_leaves(variables))
    assert sum(v.size for v in sd.values()) == n_jax
    assert weights.FLAX_CONVERTERS["decoder"] is \
        weights.decoder_params_from_flax
    assert weights.FLAX_CONVERTERS["decoder_tiny"] is \
        weights.decoder_params_from_flax


def test_checkpoint_msgpack_round_trip(jax_side, tmp_path):
    _, variables = jax_side
    path = os.path.join(str(tmp_path), "checkpoint.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(variables))
    got = weights.decoder_params_from_flax(weights.read_flax_msgpack(path))
    want = weights.decoder_params_from_flax(variables)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])


def test_position_clamp_and_seeded_init():
    """Positions past the table clamp to its last row (no gather error);
    a seeded init covers the decoder's norms (scale 1, bias 0)."""
    spec = create_model("decoder_tiny", **ARCH)
    model = weights.materialize(spec.module, torch.device("cpu"), seed=1)
    ids = torch.zeros((1, 1), dtype=torch.int64)
    with torch.no_grad():
        far = model(ids, positions=torch.tensor([[500]]),
                    kv_cache=[(torch.zeros((3, BS, H, D)),
                               torch.zeros((3, BS, H, D)),
                               torch.full((1, 2), -1, dtype=torch.int32))]
                    * ARCH["num_layers"])[0]
        last = model(ids, positions=torch.tensor([[63]]),
                     kv_cache=[(torch.zeros((3, BS, H, D)),
                                torch.zeros((3, BS, H, D)),
                                torch.full((1, 2), -1, dtype=torch.int32))]
                     * ARCH["num_layers"])[0]
    assert torch.equal(far, last)
    assert torch.equal(model.final_norm.weight,
                       torch.ones(ARCH["hidden_size"]))
    assert torch.equal(model.layers[0].attn_norm.bias,
                       torch.zeros(ARCH["hidden_size"]))
    assert model.flops(1, 8) > 0
