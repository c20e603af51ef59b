"""Parity of the port's ViT (kfserving_tpu_torch.models.vit) with the JAX
package's on shared randomized variables, of its attention at ViT's
ragged sequence lengths with the einsum attention the JAX package runs
there, its Flax converter, and its refusal on the card of a head dim the
flash kernel is not built for.  Everything runs on the CPU.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from torch_parity import randomized

from kfserving_tpu.models import create_model as jax_create_model
from kfserving_tpu.ops.attention import _xla_attention
from kfserving_tpu_torch.models import create_model
from kfserving_tpu_torch.models import weights
from kfserving_tpu_torch.models.vit import ViTConfig
from kfserving_tpu_torch.ops import dot_product_attention
from kfserving_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
)
from kfserving_tpu_torch.predictors.torch_model import (
    TorchModel,
    check_kernel_shapes,
)
from kfserving_tpu_torch.protocol.errors import InvalidInput

# fp32 on both sides; summation order differs.
FP32_ATOL = 1e-4
# bf16 on both sides: the residual stream and every dense output are
# rounded to bf16 (8 mantissa bits) at other places, over 2 blocks; the
# logits are O(1), so a few bf16 ulps of them.
BF16_ATOL = 0.05
# Attention in fp32 against the JAX einsum path: order of sums only.
ATTENTION_ATOL = 2e-5


def _variables(seed: int = 1, **overrides):
    spec = jax_create_model("vit_tiny", dtype="float32", **overrides)
    shapes = jax.eval_shape(lambda: spec.module.init(
        jax.random.PRNGKey(0), spec.example))
    return randomized(shapes, seed)


def _images(n: int, size: int = 32, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).uniform(
        0.0, 1.0, (n, size, size, 3)).astype(np.float32)


def _port(variables, dtype: str):
    spec = create_model("vit_tiny", dtype=dtype)
    return weights.materialize(
        spec.module, torch.device("cpu"),
        state_dict=weights.vit_params_from_flax(variables))


@pytest.mark.parametrize("dtype,atol", [("float32", FP32_ATOL),
                                        ("bfloat16", BF16_ATOL)])
def test_vit_tiny_logits_match_jax(dtype, atol):
    """vit_tiny: L = (32 / 8)^2 + 1 = 17 tokens, a randomized CLS token
    (the JAX init's is 0) and position table."""
    variables = _variables()
    assert np.abs(variables["params"]["cls_token"]).max() > 0.5
    spec = jax_create_model("vit_tiny", dtype=dtype)
    x = _images(3)
    expect = np.asarray(jax.jit(spec.module.apply)(variables, x))
    model = _port(variables, dtype)
    assert model.config.seq_len == 17
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == expect.shape == (3, 10)
    np.testing.assert_allclose(got, expect, atol=atol, rtol=0)


def test_cls_token_reaches_the_logits():
    """The head reads token 0: a changed CLS token changes the answer."""
    variables = _variables()
    model = _port(variables, "float32")
    x = torch.from_numpy(_images(1))
    with torch.inference_mode():
        before = model(x)
        model.cls_token.add_(torch.from_numpy(np.random.default_rng(
            0).normal(size=model.cls_token.shape).astype(np.float32)))
        after = model(x)
    assert float((before - after).abs().max()) > 1e-3


@pytest.mark.parametrize("B,L,H,D", [(2, 17, 4, 16), (2, 197, 3, 64),
                                     (1, 13, 2, 64)])
def test_attention_at_ragged_lengths_matches_jax(B, L, H, D):
    """The lengths ViT runs (17 for vit_tiny, 197 for ViT-B/16) and a
    short ragged one, with no mask: the port's plain kernel version, its
    flash wrapper (plain on a CPU tensor) and its dispatcher against the
    JAX package's einsum attention, which is what the JAX dispatcher
    runs at these shapes."""
    rng = np.random.default_rng(L)
    q, k, v = (rng.normal(size=(B, L, H, D)).astype(np.float32)
               for _ in range(3))
    expect = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), None))
    t = [torch.from_numpy(a) for a in (q, k, v)]
    for fn in (flash_attention_plain, flash_attention,
               dot_product_attention):
        got = fn(*t).numpy()
        np.testing.assert_allclose(got, expect, atol=ATTENTION_ATOL, rtol=0,
                                   err_msg=fn.__name__)


def test_attn_fn_hook_replaces_the_dispatcher():
    variables = _variables()
    model = _port(variables, "float32")
    calls = []

    def plain(q, k, v, mask):
        calls.append((tuple(q.shape), mask))
        return flash_attention_plain(q, k, v)

    x = torch.from_numpy(_images(2))
    with torch.inference_mode():
        default = model(x)
        model.config.attn_fn = plain
        hooked = model(x)
    assert calls == [((2, 17, 4, 16), None)] * 2
    np.testing.assert_allclose(hooked.numpy(), default.numpy(),
                               atol=FP32_ATOL, rtol=0)


def test_state_dict_and_checkpoint_round_trip(tmp_path):
    variables = _variables()
    sd = weights.vit_params_from_flax(variables)
    module = create_model("vit_tiny").module
    assert set(sd) == set(module.state_dict())
    for name, tensor in module.state_dict().items():
        assert tuple(sd[name].shape) == tuple(tensor.shape), name
    kernel = variables["params"]["patch_embed"]["kernel"]     # HWIO
    np.testing.assert_array_equal(sd["patch_embed.weight"],
                                  kernel.transpose(3, 2, 0, 1))
    path = os.path.join(str(tmp_path), "checkpoint.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(variables))
    read = weights.vit_params_from_flax(weights.read_flax_msgpack(path))
    assert set(read) == set(sd)
    for name in sd:
        np.testing.assert_array_equal(read[name], sd[name])


def test_flops_and_sequence_length():
    cfg = create_model("vit_b16").module.config
    assert (cfg.seq_len, cfg.head_dim) == (197, 64)
    flops = create_model("vit_b16").module.flops(1, None)
    assert abs(flops / 2 - 17.56e9) < 0.05e9
    assert create_model("vit_b16").module.flops(4) == 4 * flops


def test_head_dim_outside_the_kernel_is_refused_on_the_card(tmp_path):
    """A head dim the flash kernel is not built for (48; it takes 16, 32,
    64 and 128) is refused at load on a CUDA device, before anything is
    allocated, rather than sent to the plain version.  vit_tiny (16) and
    ViT-B/16 (64) pass; on the CPU every head dim serves."""
    model_dir = os.path.join(str(tmp_path), "vit")
    os.makedirs(model_dir)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump({"architecture": "vit_tiny", "warmup": False,
                   "arch_kwargs": {"hidden_size": 96, "num_heads": 2}}, f)
    model = TorchModel("vit", model_dir, device="cpu")
    model.device = torch.device("cuda")       # as a CUDA-built model
    with pytest.raises(InvalidInput, match="head dim 48"):
        model.load()
    assert model.engine is None and not model.ready
    cuda = torch.device("cuda")
    check_kernel_shapes(create_model("vit_b16").module, cuda)
    check_kernel_shapes(create_model("vit_tiny").module, cuda)
    check_kernel_shapes(create_model("mlp").module, cuda)   # no attention
    with pytest.raises(InvalidInput, match="float16"):
        check_kernel_shapes(create_model("vit_b16", dtype="float16").module,
                            cuda)
    cpu = TorchModel("vit", model_dir, device="cpu")
    assert cpu.load() and cpu.ready
    cpu.unload()


def test_config_dtype_names():
    assert ViTConfig(dtype="float32").dtype == torch.float32
    assert ViTConfig(dtype=torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.slow
def test_vit_b16_full_width_matches_jax():
    """vit_b16 itself (224 px, L = 197) on randomized variables, fp32."""
    spec = jax_create_model("vit_b16", dtype="float32")
    shapes = jax.eval_shape(lambda: spec.module.init(
        jax.random.PRNGKey(0), spec.example))
    variables = randomized(shapes, seed=2)
    x = _images(2, 224)
    expect = np.asarray(jax.jit(spec.module.apply)(variables, x))
    model = weights.materialize(
        create_model("vit_b16", dtype="float32").module,
        torch.device("cpu"),
        state_dict=weights.vit_params_from_flax(variables))
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, expect, atol=1e-3, rtol=1e-3)
