"""Parity of the port's attention (kfserving_tpu_torch.ops) with the JAX
package's, on the CPU.

The JAX flash kernel runs in Pallas interpret mode (as in
tests/test_models.py); the port's ``flash_attention`` on a CPU tensor runs
its plain PyTorch version, the function the CUDA kernel is held against
on the card by chip_smoke.py.  Inputs come from numpy with a fixed seed.
"""

import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from kfserving_tpu.ops import pallas_attention
from kfserving_tpu.ops.attention import (
    dot_product_attention as jax_dot_product_attention,
)
from kfserving_tpu_torch.csrc import build
from kfserving_tpu_torch.ops import attention as torch_attention
from kfserving_tpu_torch.ops import paged_attention as paged_port
from kfserving_tpu_torch.ops.attention import dot_product_attention
from kfserving_tpu_torch.ops.flash_attention import (
    _check_cuda_operands as flash_operands,
    flash_attention,
    flash_attention_plain,
)

# fp32 on both sides; the Pallas interpreter and torch sum in another
# order, as in the JAX package's own interpret-mode tests.
ATOL = RTOL = 2e-3
# The head dims K1 and K2 are built for on the card, as their refusals
# print them.
HEAD_DIMS = (16, 32, 64, 80, 96, 128, 192, 256)
HEAD_DIMS_RE = re.escape(str(HEAD_DIMS))


def _qkv(seed, B, L, H, D, Lk=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, L, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Lk or L, H, D)).astype(np.float32)
    v = rng.normal(size=(B, Lk or L, H, D)).astype(np.float32)
    return q, k, v


def _jax_flash_interpret(q, k, v, causal=False, kv_lengths=None):
    orig = pl.pallas_call
    try:
        pl.pallas_call = functools.partial(orig, interpret=True)
        out = pallas_attention.flash_attention.__wrapped__(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            block_q=32, block_k=32,
            kv_lengths=(None if kv_lengths is None
                        else jnp.asarray(kv_lengths, jnp.int32)))
    finally:
        pl.pallas_call = orig
    return np.asarray(out)


@pytest.mark.parametrize("causal,lengths,L,Lk", [
    (False, None, 64, None),
    (True, None, 64, None),
    (False, [64, 37, 0], 64, None),
    # The card kernel's tile edges (128 keys, 128 queries a tile): rows
    # of 0, 127, 128 and 129 keys, L not a multiple of 128.
    (False, [0, 127, 128, 129], 136, None),
    (False, [0, 127, 128, 129, 200], 200, None),
    (True, [0, 127, 128, 129, 136], 136, None),
    (False, [200, 129, 0], 64, 200),          # Lq != Lk
])
def test_flash_plain_matches_pallas_interpret(causal, lengths, L, Lk):
    B = 3 if lengths is None else len(lengths)
    q, k, v = _qkv(0, B, L, 2, 32, Lk=Lk)
    expect = _jax_flash_interpret(q, k, v, causal=causal,
                                  kv_lengths=lengths)
    got = flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal,
        kv_lengths=None if lengths is None else torch.tensor(lengths))
    got = got.numpy()
    np.testing.assert_allclose(got, expect, atol=ATOL, rtol=RTOL)
    for b, n in enumerate(lengths or []):
        if n == 0:
            # A row with no keys is 0, never NaN, on both sides.
            assert np.all(got[b] == 0.0) and np.all(expect[b] == 0.0)


@pytest.mark.parametrize("case", ["decoder_tiny", "bert_tiny",
                                  "vit_tiny"])
def test_small_head_dims_plain_matches_pallas_interpret(case):
    """The head dims K1 gained for the tiny models: decoder_tiny's causal
    + lengths prefill at D = 32, bert_tiny's lengths at D = 32, and
    vit_tiny's L = 17 at D = 16.  The Pallas kernel needs a power-of-two
    block divisor of L, so L = 17 runs there padded to 32 with the 15
    padding keys masked by lengths (and its first 17 query rows kept)."""
    if case == "decoder_tiny":
        L, D, causal, lengths = 64, 32, True, [64, 17, 1, 0]
    elif case == "bert_tiny":
        L, D, causal, lengths = 32, 32, False, [32, 5, 0]
    else:
        L, D, causal, lengths = 17, 16, False, None
    B = 2 if lengths is None else len(lengths)
    q, k, v = _qkv(5, B, L, 4, D)
    if L % 8:
        pad = [(0, 0), (0, 32 - L), (0, 0), (0, 0)]
        expect = _jax_flash_interpret(
            *(np.pad(a, pad, constant_values=3.0) for a in (q, k, v)),
            kv_lengths=[L] * B)[:, :L]
    else:
        expect = _jax_flash_interpret(q, k, v, causal=causal,
                                      kv_lengths=lengths)
    got = flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal,
        kv_lengths=None if lengths is None else torch.tensor(lengths))
    assert got.shape == (B, L, 4, D)
    np.testing.assert_allclose(got.numpy(), expect, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("head_dim,dtype,ok", [
    (16, "float32", True), (32, "float32", True), (16, "bfloat16", True),
    (32, "bfloat16", True), (64, "bfloat16", True), (128, "float32", True),
    (48, "bfloat16", False), (8, "float32", False),
    (80, "bfloat16", True), (96, "float32", True), (192, "bfloat16", True),
    (256, "float32", True), (272, "bfloat16", False)])
def test_kernel_shapes_at_every_built_head_dim(head_dim, dtype, ok):
    """On the card ``check_kernel_shapes`` takes exactly the head dims
    K1 is instantiated for (16, 32, 64, 80, 96, 128, 192, 256), in bf16
    and fp32, and its refusal names them."""
    from kfserving_tpu_torch.models import create_model
    from kfserving_tpu_torch.ops.flash_attention import (
        SUPPORTED_HEAD_DIMS,
        check_kernel_shapes,
    )
    from kfserving_tpu_torch.protocol.errors import InvalidInput

    assert SUPPORTED_HEAD_DIMS == HEAD_DIMS
    module = create_model("bert_tiny", num_heads=2,
                          hidden_size=2 * head_dim, dtype=dtype).module
    assert module.config.head_dim == head_dim
    check_kernel_shapes(module, torch.device("cpu"))
    if ok:
        check_kernel_shapes(module, torch.device("cuda"))
    else:
        with pytest.raises(InvalidInput, match=f"head dims {HEAD_DIMS_RE}"
                           f".*head dim {head_dim}"):
            check_kernel_shapes(module, torch.device("cuda"))


def test_flash_rejects_seq_len_without_block_divisor():
    """The Pallas kernel refuses L = 12 (its blocks need a power-of-two
    divisor >= 8, from the TPU's lane tiling).  The port takes any L: at
    L = 12 its wrapper and plain version equal the masked reference, the
    same rows padded to 16 with the 4 padding keys masked by lengths."""
    q, k, v = _qkv(4, 2, 12, 2, 32)
    with pytest.raises(ValueError, match="power-of-two block divisor"):
        pallas_attention.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v))
    pad = [(0, 0), (0, 4), (0, 0), (0, 0)]
    padded = [torch.from_numpy(np.pad(a, pad, constant_values=9.0))
              for a in (q, k, v)]
    expect = flash_attention_plain(
        *padded, kv_lengths=torch.tensor([12, 12]))[:, :12].numpy()
    t = [torch.from_numpy(a) for a in (q, k, v)]
    for fn in (flash_attention, flash_attention_plain):
        got = fn(*t)
        assert got.shape == (2, 12, 2, 32)
        np.testing.assert_allclose(got.numpy(), expect, atol=1e-6, rtol=0)


def test_flash_wrapper_refuses_other_devices():
    """Only CPU tensors take the plain version; anything that is not
    CUDA or CPU is refused rather than computed some other way."""
    t = torch.zeros((1, 8, 1, 32), device="meta")
    with pytest.raises(ValueError, match="runs on cuda"):
        flash_attention(t, t, t)


def _compare_rows(got, expect, lengths):
    """Rows with real keys only: on the CPU the JAX einsum path averages
    V over a fully masked row, while the kernel semantics give 0 (such
    rows are batch padding and are sliced away by the server)."""
    for b, n in enumerate(lengths):
        if n > 0:
            np.testing.assert_allclose(got[b], expect[b], atol=ATOL,
                                       rtol=RTOL)


@pytest.mark.parametrize("case", ["mask", "kv_lengths", "prefix_padding",
                                  "causal_short_q", "causal_padded"])
def test_dot_product_attention_matches_jax(case):
    B, L, H, D = 3, 16, 2, 8
    lengths = [16, 9, 0]
    q, k, v = _qkv(1, B, L, H, D)
    suffix = (np.arange(L)[None, :]
              < np.asarray(lengths)[:, None])[:, None, None, :]
    kw_jax, kw_torch = {}, {}
    if case == "mask":
        # An arbitrary (non-suffix) pattern, per query row.
        mask = np.random.default_rng(2).random((B, 1, L, L)) < 0.7
        mask[..., 0] = True
        kw_jax["mask"], kw_torch["mask"] = jnp.asarray(mask), \
            torch.from_numpy(mask)
        lengths = [L] * B
    elif case == "kv_lengths":
        kw_jax["kv_lengths"] = jnp.asarray(lengths, jnp.int32)
        kw_torch["kv_lengths"] = torch.tensor(lengths, dtype=torch.int32)
    elif case == "prefix_padding":
        kw_jax.update(mask=jnp.asarray(suffix), prefix_padding=True)
        kw_torch.update(mask=torch.from_numpy(suffix), prefix_padding=True)
    elif case == "causal_short_q":
        q = q[:, :4]   # Lq < Lk: the shifted triangle
        kw_jax["causal"] = kw_torch["causal"] = True
        lengths = [L] * B
    else:              # causal composed with a key-padding mask
        kw_jax.update(mask=jnp.asarray(suffix), causal=True)
        kw_torch.update(mask=torch.from_numpy(suffix), causal=True)
    expect = np.asarray(jax_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw_jax))
    got = dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), **kw_torch).numpy()
    assert got.shape == expect.shape
    _compare_rows(got, expect, lengths)


def test_mask_and_kv_lengths_mutually_exclusive():
    q = torch.zeros((2, 16, 2, 8))
    lengths = torch.tensor([8, 16])
    mask = (torch.arange(16)[None, :] < lengths[:, None])[:, None, None, :]
    with pytest.raises(ValueError, match="mutually exclusive"):
        dot_product_attention(q, q, q, mask=mask, kv_lengths=lengths)


def test_cpu_dispatch_takes_plain_path(monkeypatch):
    """On the CPU the dispatcher never reaches the kernel wrapper; only a
    call on the card does."""
    calls = []
    monkeypatch.setattr(torch_attention, "flash_attention",
                        lambda *a, **k: calls.append(1))
    q = torch.zeros((1, 64, 2, 64))
    dot_product_attention(q, q, q)
    assert calls == []
    assert not torch_attention._on_card(q)


class _OnCard:
    """A CPU tensor that reports itself on the card: enough for the
    dispatcher and for the wrapper's checks, which all run before a
    launch."""

    is_cuda = True
    device = torch.device("cuda", 0)
    requires_grad = False

    def __init__(self, t: torch.Tensor):
        self._t, self.shape, self.dtype = t, t.shape, t.dtype

    def dim(self):
        return self._t.dim()

    def stride(self, i):
        return self._t.stride(i)

    def data_ptr(self):
        return self._t.data_ptr()

    def is_contiguous(self):
        return self._t.is_contiguous()

    def contiguous(self):
        return self


def _paged_gate(monkeypatch, shape, dtype, expect):
    """K2's wrapper on operands that report themselves on the card: the
    path it launches (the launchers recorded, not run), or its refusal."""
    routed = []
    monkeypatch.setattr(paged_port, "_sm_count", lambda device: 132)
    monkeypatch.setattr(paged_port, "launch_hopper",
                        lambda *a, **k: routed.append("hopper"))
    monkeypatch.setattr(paged_port, "_launch_simple",
                        lambda *a, **k: routed.append("simple"))
    monkeypatch.setattr(paged_port.paged_attention_kernel, "launches", 0)
    B, _, H, D = shape
    q = _OnCard(torch.zeros(shape, dtype=dtype))
    pool = _OnCard(torch.zeros((4, 16, H, D), dtype=dtype))
    table = _OnCard(torch.zeros((B, 2), dtype=torch.int32))
    lengths = _OnCard(torch.ones(B, dtype=torch.int32))
    if expect in ("hopper", "simple"):
        paged_port.paged_attention_kernel(q, pool, pool, table, lengths)
        assert routed == [expect]
        assert paged_port.kernel_path(dtype, D) == expect
    else:
        with pytest.raises(ValueError, match=expect):
            paged_port.paged_attention_kernel(q, pool, pool, table, lengths)
        assert routed == []


@pytest.mark.parametrize("shape,dtype,mask,expect", [
    ((1, 64, 2, 64), torch.bfloat16, None, "kernel"),
    ((1, 64, 2, 128), torch.float32, "lengths", "kernel"),
    ((1, 64, 2, 64), torch.bfloat16, "causal", "kernel"),
    ((1, 64, 2, 64), torch.float16, None, "bfloat16 or float32"),
    ((1, 64, 2, 48), torch.bfloat16, None, "head dims"),
    ((1, 60, 2, 64), torch.bfloat16, None, "kernel"),   # any L
    ((1, 64, 2, 64), torch.bfloat16, "arbitrary", "plain"),
    ((1, 64, 2, 64), torch.bfloat16, "causal_short_q", "plain"),
] + [
    # K1's gate at every head dim it is built for, both dtypes, and its
    # refusals naming the set.
    ((1, 64, 2, D), dtype, "lengths", "kernel")
    for D in HEAD_DIMS for dtype in (torch.bfloat16, torch.float32)
] + [
    ((1, 64, 2, D), torch.bfloat16, None, f"head dims {HEAD_DIMS_RE}")
    for D in (48, 272)
] + [
    # K2's gate ("paged"): the path each (dtype, D) launches, and its
    # refusals naming the set.
    ((3, 1, 2, D), dtype, "paged",
     "hopper" if dtype == torch.bfloat16 and D % 64 == 0 else "simple")
    for D in HEAD_DIMS for dtype in (torch.bfloat16, torch.float32)
] + [
    ((3, 1, 2, D), dtype, "paged", f"head dims {HEAD_DIMS_RE}")
    for D in (48, 272) for dtype in (torch.bfloat16, torch.float32)
])
def test_kernel_gate_is_what_the_kernel_accepts(monkeypatch, shape, dtype,
                                                mask, expect):
    """On the card, a mask case the kernel handles always goes to the
    kernel wrapper, which raises for a dtype or head dim it does not
    take (any length is taken): no plain fallback and no kill switch
    (the environment variable the first port read is ignored).  Mask
    cases the kernel does not handle take the plain path.  K2's wrapper
    ("paged") likewise launches one of its two paths at every head dim
    of the set, in bf16 and fp32, and refuses the others."""
    if mask == "paged":
        _paged_gate(monkeypatch, shape, dtype, expect)
        return
    monkeypatch.setenv("KFS_DISABLE_FLASH", "1")
    routed = []
    monkeypatch.setattr(torch_attention, "_torch_attention",
                        lambda *a: routed.append("plain"))
    if expect == "kernel":
        monkeypatch.setattr(torch_attention, "flash_attention",
                            lambda *a, **k: routed.append("kernel"))
    t = torch.zeros(shape, dtype=dtype)
    q = k = v = _OnCard(t)
    if expect == "plain":
        # The plain path builds its masks on q's device: real CPU
        # tensors, with the dispatcher told they are on the card.
        monkeypatch.setattr(torch_attention, "_on_card", lambda q: True)
        q = k = v = t
    kw = {}
    if mask == "lengths":
        kw["kv_lengths"] = torch.tensor([shape[1]], dtype=torch.int32)
    elif mask == "causal":
        kw["causal"] = True
    elif mask == "arbitrary":
        kw["mask"] = torch.rand((1, 1, shape[1], shape[1])) < 0.5
    elif mask == "causal_short_q":
        q = t[:, :8]
        kw["causal"] = True
    if expect in ("kernel", "plain"):
        dot_product_attention(q, k, v, **kw)
        assert routed == [expect]
        if expect == "kernel":
            # The wrapper's own checks, which run before its launch, take
            # the operands too.
            flash_operands(q, k, v, shape[3])
    else:
        with pytest.raises(ValueError, match=expect):
            dot_product_attention(q, k, v, **kw)
        assert routed == []


def test_bf16_plain_matches_fp32_within_bf16():
    """The plain version keeps fp32 statistics for bf16 inputs."""
    q, k, v = _qkv(3, 2, 32, 2, 64)
    lengths = torch.tensor([32, 5])
    t32 = [torch.from_numpy(x) for x in (q, k, v)]
    t16 = [x.to(torch.bfloat16) for x in t32]
    ref = flash_attention_plain(*(x.float() for x in t16),
                                kv_lengths=lengths)
    got = flash_attention_plain(*t16, kv_lengths=lengths)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(),
                               atol=2e-2, rtol=2e-2)


def test_kernel_build_command_targets_hopper(monkeypatch):
    """The nvcc line builds a plain-C shared library for sm_90a; without
    nvcc the build fails with a clear error instead of falling back."""
    cmd = build.nvcc_command("nvcc", "flash_attention", "/tmp/x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert {"-shared", "-O3"} <= set(cmd) and "-fPIC" in cmd
    assert cmd[-1].endswith("flash_attention.cu")
    assert "flash_attention" in build.sources()
    assert build.library_path("flash_attention").startswith(build.BUILD_DIR)
    monkeypatch.setattr(build, "find_nvcc", lambda: None)
    monkeypatch.setattr(build, "library_path",
                        lambda name: "/nonexistent/lib.so")
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.build_all(["flash_attention"])
