"""Parity of the port's paged-cache ops (kfserving_tpu_torch.ops.
paged_attention) and of K1's causal + kv_lengths case with the JAX
package's, on the CPU.

The JAX Pallas kernels run in interpret mode, as the JAX package's own
tests run them; the port's kernel wrappers on CPU tensors run their plain
versions, the functions the CUDA kernels are held against on the card by
chip_smoke.py.  Inputs come from numpy with fixed seeds.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from kfserving_tpu.ops import pallas_attention
from kfserving_tpu.ops import paged_attention as jax_paged
from kfserving_tpu_torch.ops import attention as torch_attention
from kfserving_tpu_torch.ops import paged_attention as port
from kfserving_tpu_torch.ops.flash_attention import flash_attention

# fp32 on both sides; the Pallas interpreter, XLA and torch sum in
# another order (the JAX package's own paged tests use the same bound).
ATOL = RTOL = 2e-5
# K1 plain vs Pallas interpret, as in tests/test_torch_attention.py.
FLASH_ATOL = 2e-3


def _pools(seed, B, H, D, BS, NB):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    pool_k = rng.normal(size=(NB, BS, H, D)).astype(np.float32)
    pool_v = rng.normal(size=(NB, BS, H, D)).astype(np.float32)
    return q, pool_k, pool_v


def _jax(name, *arrays, **kw):
    fn = getattr(jax_paged, name)
    return np.asarray(fn(*(jnp.asarray(a) for a in arrays), **kw))


def _pallas(q, pool_k, pool_v, table, lengths):
    return np.asarray(jax_paged.paged_attention_tpu.__wrapped__(
        jnp.asarray(q), jnp.asarray(pool_k), jnp.asarray(pool_v),
        jnp.asarray(table, jnp.int32), jnp.asarray(lengths, jnp.int32),
        interpret=True))


def _port_attention(q, pool_k, pool_v, table, lengths):
    return port.paged_attention_kernel(
        torch.from_numpy(q), torch.from_numpy(pool_k),
        torch.from_numpy(pool_v),
        torch.tensor(table, dtype=torch.int32),
        torch.tensor(lengths, dtype=torch.int32)).numpy()


# (table, lengths) cases of tests/test_paged.py:481-519, plus a row
# parked past the table (lengths = MB * BS + 1), over B=3, H=4, D=64,
# BS=128, NB=8, MB=4 (boundary cases use MB=3).
PAGED_CASES = {
    "partial, shared and -1 tails": (
        [[0, 1, 2, -1], [3, -1, -1, -1], [0, 4, -1, -1]], [300, 40, 200]),
    "block boundaries 128/256": ([[0, 1, 2], [3, 4, 5]], [128, 256]),
    "block boundaries 1/384": ([[0, 1, 2], [3, 4, 5]], [1, 384]),
    "block boundaries 127/129": ([[0, 1, 2], [3, 4, 5]], [127, 129]),
    "parked row": ([[0, 1, 2, 5], [3, 6, -1, -1], [7, 4, 1, 0]],
                   [4 * 128 + 1, 100, 512]),
}


@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_paged_plain_matches_pallas_and_xla(case):
    table, lengths = PAGED_CASES[case]
    q, pool_k, pool_v = _pools(0, len(table), 4, 64, 128, 8)
    got = _port_attention(q, pool_k, pool_v, table, lengths)
    want_xla = _jax("paged_attention_xla", q, pool_k, pool_v,
                    np.asarray(table, np.int32),
                    np.asarray(lengths, np.int32))
    np.testing.assert_allclose(got, want_xla, atol=ATOL, rtol=RTOL)
    want_pallas = _pallas(q, pool_k, pool_v, table, lengths)
    np.testing.assert_allclose(got, want_pallas, atol=ATOL, rtol=RTOL)


def test_paged_zero_length_row_is_zero_like_the_kernel():
    """A row of length 0 gives 0 in the Pallas kernel and the port (the
    XLA gather path averages V there instead, so it is not compared)."""
    table = [[0, 1], [2, -1]]
    lengths = [0, 77]
    q, pool_k, pool_v = _pools(1, 2, 2, 64, 128, 4)
    got = _port_attention(q, pool_k, pool_v, table, lengths)
    want = _pallas(q, pool_k, pool_v, table, lengths)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert np.all(got[0] == 0.0) and np.all(want[0] == 0.0)


def _with_sink(pool):
    """The port's pools carry one more block: the sink dropped writes
    land in."""
    return torch.from_numpy(np.concatenate(
        [pool, np.zeros_like(pool[:1])]))


@pytest.mark.parametrize("shape", ["decode", "chunk"])
def test_paged_write_matches_jax_and_drops(shape):
    B, H, D, BS, NB, MB = 3, 2, 8, 4, 6, 3
    rng = np.random.default_rng(2)
    pool_k = rng.normal(size=(NB, BS, H, D)).astype(np.float32)
    pool_v = rng.normal(size=(NB, BS, H, D)).astype(np.float32)
    table = np.asarray([[0, 1, -1], [2, 3, 4], [5, -1, -1]], np.int32)
    if shape == "decode":
        # Row 0 lands on a -1 entry, row 1 past the table: both drop.
        positions = np.asarray([9, 12, 2], np.int32)
        step = (B, H, D)
    else:
        positions = np.asarray([[3, 4, 8, 9], [10, 11, 12, 13],
                                [0, 1, 2, 3]], np.int32)
        step = (B, 4, H, D)
    k_step = rng.normal(size=step).astype(np.float32)
    v_step = rng.normal(size=step).astype(np.float32)
    want_k, want_v = jax_paged.paged_write(
        jnp.asarray(pool_k), jnp.asarray(pool_v), jnp.asarray(k_step),
        jnp.asarray(v_step), jnp.asarray(table), jnp.asarray(positions))
    got_k, got_v = _with_sink(pool_k), _with_sink(pool_v)
    port.paged_write(got_k, got_v, torch.from_numpy(k_step),
                     torch.from_numpy(v_step), torch.from_numpy(table),
                     torch.from_numpy(positions))
    np.testing.assert_array_equal(got_k[:NB].numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_v[:NB].numpy(), np.asarray(want_v))


def test_paged_insert_matches_jax_and_drops():
    B, L, H, D, BS, NB = 3, 8, 2, 8, 4, 5
    rng = np.random.default_rng(3)
    pool = rng.normal(size=(NB, BS, H, D)).astype(np.float32)
    k_new = rng.normal(size=(B, L, H, D)).astype(np.float32)
    v_new = rng.normal(size=(B, L, H, D)).astype(np.float32)
    dest = np.asarray([[4, -1], [0, 2], [-1, -1]], np.int32)
    want_k, want_v = jax_paged.paged_insert(
        jnp.asarray(pool), jnp.asarray(pool), jnp.asarray(k_new),
        jnp.asarray(v_new), jnp.asarray(dest), None)
    got_k, got_v = _with_sink(pool), _with_sink(pool)
    port.paged_insert(got_k, got_v, torch.from_numpy(k_new),
                      torch.from_numpy(v_new), torch.from_numpy(dest))
    np.testing.assert_array_equal(got_k[:NB].numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_v[:NB].numpy(), np.asarray(want_v))
    with pytest.raises(ValueError, match="multiple of the block size"):
        port.paged_insert(got_k, got_v, torch.zeros((1, 6, H, D)),
                          torch.zeros((1, 6, H, D)),
                          torch.zeros((1, 2), dtype=torch.int64))


def test_paged_prefill_attention_matches_jax():
    B, L, H, D, BS, NB = 2, 4, 2, 16, 8, 6
    rng = np.random.default_rng(4)
    q = rng.normal(size=(B, L, H, D)).astype(np.float32)
    pool_k = rng.normal(size=(NB, BS, H, D)).astype(np.float32)
    pool_v = rng.normal(size=(NB, BS, H, D)).astype(np.float32)
    table = np.asarray([[1, 0, -1], [2, 3, 5]], np.int32)
    # Row 1's last query is parked on an out-of-range position.
    qpos = np.asarray([[5, 6, 7, 8], [17, 18, 19, 64]], np.int32)
    want = _jax("paged_prefill_attention_xla", q, pool_k, pool_v, table,
                qpos)
    got = port.paged_prefill_attention(
        torch.from_numpy(q), torch.from_numpy(pool_k),
        torch.from_numpy(pool_v), torch.from_numpy(table),
        torch.from_numpy(qpos)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_paged_dispatcher_on_cpu_and_kill_switch(monkeypatch):
    """The decoder's entry, ``paged_attention``, is the kernel wrapper: a
    CPU tensor runs the plain version and launches nothing.  There is no
    gate and no kill switch that reroutes a card call to the plain version:
    KFS_DISABLE_PAGED_KERNEL changes nothing, and what the kernel is not
    built for (dtype, head dim, Lq) raises before a launch."""
    assert port.paged_attention is port.paged_attention_kernel
    monkeypatch.setenv("KFS_DISABLE_PAGED_KERNEL", "1")
    table, lengths = PAGED_CASES["partial, shared and -1 tails"]
    q, pool_k, pool_v = _pools(5, 3, 4, 64, 128, 8)
    args = (torch.from_numpy(q), torch.from_numpy(pool_k),
            torch.from_numpy(pool_v), torch.tensor(table, dtype=torch.int32),
            torch.tensor(lengths, dtype=torch.int32))
    before = port.paged_attention_kernel.launches
    got = port.paged_attention(*args)
    assert port.paged_attention_kernel.launches == before
    assert got.shape == (3, 1, 4, 64)
    assert torch.equal(got, port.paged_attention_plain(*args))
    for shape, dtype, ok in [((8, 1, 12, 64), torch.bfloat16, True),
                             ((8, 1, 4, 32), torch.float32, True),
                             ((8, 1, 4, 128), torch.bfloat16, True),
                             ((8, 2, 12, 64), torch.bfloat16, False),
                             ((8, 1, 12, 48), torch.bfloat16, False),
                             ((8, 1, 12, 64), torch.float16, False)]:
        B, _, H, D = shape
        q = torch.zeros(shape, dtype=dtype)
        pool = torch.zeros((4, 16, H, D), dtype=dtype)
        operands = (q, pool, pool, torch.zeros((B, 2), dtype=torch.int32),
                    torch.zeros((B,), dtype=torch.int32), D)
        if ok:
            port._check_cuda_operands(*operands)
        else:
            with pytest.raises(ValueError, match="paged_attention kernel"):
                port._check_cuda_operands(*operands)


def test_paged_wrapper_refuses_other_devices():
    t = torch.zeros((1, 1, 2, 64), device="meta")
    pool = torch.zeros((2, 4, 2, 64), device="meta")
    table = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    lengths = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="runs on cuda"):
        port.paged_attention_kernel(t, pool, pool, table, lengths)


def test_flash_causal_kv_lengths_plain_matches_pallas():
    """K1 with causal and kv_lengths together (the decoder's bucketed
    prefill): the port's plain version against the Pallas kernel."""
    rng = np.random.default_rng(6)
    q, k, v = (rng.normal(size=(3, 64, 2, 32)).astype(np.float32)
               for _ in range(3))
    lengths = [64, 23, 1]
    orig = pl.pallas_call
    try:
        pl.pallas_call = functools.partial(orig, interpret=True)
        want = np.asarray(pallas_attention.flash_attention.__wrapped__(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
            block_q=32, block_k=32,
            kv_lengths=jnp.asarray(lengths, jnp.int32)))
    finally:
        pl.pallas_call = orig
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True,
                          kv_lengths=torch.tensor(lengths)).numpy()
    np.testing.assert_allclose(got, want, atol=FLASH_ATOL,
                               rtol=FLASH_ATOL)


@pytest.mark.parametrize("causal,lq,lk,has_mask,has_lengths,kernel", [
    (True, 64, 64, False, True, True),    # bucketed prefill: kernel
    (True, 64, 64, False, False, True),   # causal alone
    (True, 16, 64, False, False, False),  # shifted triangle: plain
    (True, 64, 64, True, False, False),   # causal + arbitrary mask
    (False, 64, 64, False, True, True),   # suffix padding
    (False, 64, 64, True, True, True),    # prefix_padding-derived
    (False, 64, 64, True, False, False),  # arbitrary mask: plain
    (False, 64, 64, False, False, True),  # no mask
])
def test_flash_routing(causal, lq, lk, has_mask, has_lengths, kernel):
    assert torch_attention.flash_handles_mask(
        causal, lq, lk, has_mask, has_lengths) is kernel


def test_dispatcher_sends_causal_kv_lengths_to_kernel(monkeypatch):
    """On the card, causal + kv_lengths reaches the flash wrapper with
    both; the CPU result is unchanged."""
    seen = []

    def fake_flash(q, k, v, causal=False, kv_lengths=None):
        seen.append((causal, kv_lengths))
        return torch.zeros_like(q)

    q = torch.randn((2, 16, 2, 8))
    lengths = torch.tensor([16, 5])
    plain = torch_attention.dot_product_attention(q, q, q, causal=True,
                                                  kv_lengths=lengths)
    monkeypatch.setattr(torch_attention, "flash_attention", fake_flash)
    monkeypatch.setattr(torch_attention, "_on_card", lambda q: True)
    torch_attention.dot_product_attention(q, q, q, causal=True,
                                          kv_lengths=lengths)
    assert len(seen) == 1 and seen[0][0] is True
    assert torch.equal(seen[0][1], lengths)
    assert torch.isfinite(plain).all()
