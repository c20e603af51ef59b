"""Parity of the port's ResNet (kfserving_tpu_torch.models.resnet) with the
JAX package's on shared randomized variables, its Flax converter, its
seeded init, and the served answers of JaxModel and TorchModel on one
uint8 image artifact.  Everything runs on the CPU.

The variables come from ``torch_parity.randomized``: every leaf of the
JAX tree is replaced with seeded numpy values (nonzero BatchNorm scales,
shifts and running means, variances above 0), because the JAX init's
zero scale on each block's last BatchNorm would hide a wrong padding.
"""

import asyncio
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from torch_parity import randomized

from kfserving_tpu.models import registry as jax_registry
from kfserving_tpu.models.resnet import ResNet as JaxResNet
from kfserving_tpu.predictors.jax_model import JaxModel
from kfserving_tpu_torch.models import create_model
from kfserving_tpu_torch.models import registry as port_registry
from kfserving_tpu_torch.models import weights
from kfserving_tpu_torch.models.resnet import ResNet, same_padding
from kfserving_tpu_torch.predictors.torch_model import TorchModel

# fp32 on both sides: the same convolutions summed in another order.
FP32_ATOL = 1e-4
# bf16 on both sides: activations are rounded to bf16 (8 mantissa bits)
# after every conv and BatchNorm, at other places in the two frameworks,
# over 13 convs; the logits are O(0.5), so a few bf16 ulps of them.
BF16_ATOL = 0.03
# The reduced ResNet of the parity tests.
REDUCED = dict(stage_sizes=[1, 1, 1, 1], num_filters=8, num_classes=7)


def _variables(size: int, torch_padding: bool, seed: int = 1):
    module = JaxResNet(**REDUCED, dtype=jnp.float32,
                       torch_padding=torch_padding)
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3))))
    return randomized(shapes, seed)


def _images(n: int, size: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).uniform(
        0.0, 1.0, (n, size, size, 3)).astype(np.float32)


def _port(variables, dtype: str, torch_padding: bool, size: int):
    with torch.device("meta"):
        module = ResNet(**REDUCED, dtype=dtype, torch_padding=torch_padding,
                        image_size=size)
    return weights.materialize(
        module, torch.device("cpu"),
        state_dict=weights.resnet_params_from_flax(variables))


@pytest.mark.parametrize("dtype,atol,size,torch_padding", [
    ("float32", FP32_ATOL, 32, False),
    ("float32", FP32_ATOL, 35, False),
    ("float32", FP32_ATOL, 32, True),
    ("float32", FP32_ATOL, 35, True),
    ("bfloat16", BF16_ATOL, 32, False),
    ("bfloat16", BF16_ATOL, 35, True),
])
def test_reduced_resnet_logits_match_jax(dtype, atol, size, torch_padding):
    """TF "SAME" (asymmetric at stride 2 on even sizes, -inf max-pool
    pad) and the symmetric torch geometry, at an even and an odd size."""
    variables = _variables(size, torch_padding)
    x = _images(3, size)
    jax_module = JaxResNet(**REDUCED, dtype=getattr(jnp, dtype),
                           torch_padding=torch_padding)
    expect = np.asarray(jax.jit(jax_module.apply)(variables, x))
    model = _port(variables, dtype, torch_padding, size)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == expect.shape == (3, 7)
    np.testing.assert_allclose(got, expect, atol=atol, rtol=0)


@pytest.mark.parametrize("size,kernel,stride,pads", [
    (224, 7, 2, (2, 3)), (56, 3, 2, (0, 1)), (35, 3, 2, (1, 1)),
    (56, 1, 2, (0, 0)), (56, 3, 1, (1, 1)), (112, 3, 2, (0, 1)),
])
def test_same_padding_is_tensorflows(size, kernel, stride, pads):
    assert same_padding(size, kernel, stride) == pads


def test_state_dict_covers_every_parameter_and_buffer():
    variables = _variables(32, False)
    sd = weights.resnet_params_from_flax(variables)
    with torch.device("meta"):
        module = ResNet(**REDUCED)
    assert set(sd) == set(module.state_dict())
    assert not any("num_batches_tracked" in k for k in sd)
    for name, tensor in module.state_dict().items():
        assert tuple(sd[name].shape) == tuple(tensor.shape), name
    kernel = variables["params"]["BottleneckBlock_1"]["Conv_1"]["kernel"]
    np.testing.assert_array_equal(sd["blocks.1.conv2.weight"],
                                  kernel.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["blocks.1.norm_proj.var"],
        variables["batch_stats"]["BottleneckBlock_1"]["norm_proj"]["var"])


def test_checkpoint_msgpack_round_trip(tmp_path):
    """A Flax checkpoint of the randomized variables, read back without
    flax and converted, gives the same model as the numpy tree."""
    variables = _variables(32, False)
    path = os.path.join(str(tmp_path), "checkpoint.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(variables))
    sd = weights.resnet_params_from_flax(weights.read_flax_msgpack(path))
    expect = weights.resnet_params_from_flax(variables)
    assert set(sd) == set(expect)
    for name in expect:
        np.testing.assert_array_equal(sd[name], expect[name])


def test_resnet50_seeded_init_and_flops():
    """The registry's resnet50 at full width: every BatchNorm scale is
    nonzero and every variance positive, the weights are a function of
    the seed, conv weights are channels-last, and flops() counts
    2 x 4.09 G multiply-adds per 224 px image."""
    spec = create_model("resnet50", image_size=64)
    module = weights.materialize(spec.module, torch.device("cpu"), seed=5)
    again = weights.materialize(create_model("resnet50", image_size=64
                                             ).module,
                                torch.device("cpu"), seed=5)
    for name, tensor in module.state_dict().items():
        assert torch.equal(tensor, again.state_dict()[name]), name
        assert bool(torch.isfinite(tensor.float()).all()), name
        if name.endswith("var"):
            assert bool((tensor > 0).all()), name
        if ".bn" in name and name.endswith("weight"):
            assert bool((tensor != 0).all()), name
    assert module.conv_init.weight.is_contiguous(
        memory_format=torch.channels_last)
    x = torch.from_numpy(_images(2, 64))
    with torch.inference_mode():
        logits = module(x)
    assert logits.shape == (2, 1000) and bool(torch.isfinite(logits).all())
    flops = create_model("resnet50").module.flops(1)
    assert abs(flops / 2 - 4.09e9) < 0.01e9
    assert create_model("resnet50").module.flops(8, None) == 8 * flops


def test_seeded_init_refuses_unknown_modules():
    """materialize allocates with to_empty: a parameter seeded_init does
    not know would serve uninitialized memory, so it raises instead."""
    with torch.device("meta"):
        module = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3))
    with pytest.raises(ValueError, match="does not know how to initialize"):
        weights.materialize(module, torch.device("cpu"))


def _factory(dtype="float32", image_size=32):
    """The reduced ResNet under one architecture name on both sides."""
    return JaxResNet(**REDUCED, dtype=getattr(jnp, dtype)), \
        jnp.zeros((1, image_size, image_size, 3), jnp.float32)


def _port_factory(dtype="float32", image_size=32):
    with torch.device("meta"):
        module = ResNet(**REDUCED, dtype=dtype, image_size=image_size)
    return module, np.zeros((1, image_size, image_size, 3), np.float32)


def test_served_topk_matches_jax_model(tmp_path, monkeypatch):
    """V1 and V2 uint8 NHWC requests with scale 1/255, top-3 through the
    JAX package's JaxModel and the port's TorchModel on one artifact
    (config.json plus a checkpoint of randomized variables)."""
    arch = "resnet_reduced"
    monkeypatch.setitem(jax_registry._REGISTRY, arch, _factory)
    monkeypatch.setitem(port_registry._REGISTRY, arch, _port_factory)
    monkeypatch.setitem(weights.FLAX_CONVERTERS, arch,
                        weights.resnet_params_from_flax)
    model_dir = os.path.join(str(tmp_path), arch)
    os.makedirs(model_dir)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump({"architecture": arch, "arch_kwargs": {"dtype": "float32"},
                   "batch_buckets": [1, 4], "max_batch_size": 4,
                   "max_latency_ms": 2, "warmup": False,
                   "input_dtype": "uint8", "scale": 1 / 255.0,
                   "output": "topk", "topk": 3}, f)
    with open(os.path.join(model_dir, "checkpoint.msgpack"), "wb") as f:
        f.write(serialization.to_bytes(_variables(32, False, seed=3)))
    images = np.random.default_rng(4).integers(
        0, 256, (3, 32, 32, 3)).astype(np.uint8)
    v2 = {"id": "r", "inputs": [{"name": "images", "shape": [2, 32, 32, 3],
                                 "datatype": "UINT8",
                                 "data": images[:2].ravel().tolist()}]}

    async def run(model):
        v1 = await asyncio.gather(*(
            model.predict({"instances": [img.tolist()]}) for img in images))
        return [r["predictions"][0] for r in v1], await model.predict(v2)

    jax_model = JaxModel(arch, model_dir)
    jax_model.load()
    try:
        expect_v1, expect_v2 = asyncio.run(run(jax_model))
    finally:
        jax_model.unload()
    port_model = TorchModel(arch, model_dir, device="cpu")
    port_model.load()
    try:
        got_v1, got_v2 = asyncio.run(run(port_model))
    finally:
        port_model.unload()
    assert port_model.param_source == "checkpoint"
    for got, expect in zip(got_v1, expect_v1):
        assert got["indices"] == expect["indices"]
        np.testing.assert_allclose(got["values"], expect["values"],
                                   atol=FP32_ATOL, rtol=0)
    got_out = {o["name"]: o for o in got_v2["outputs"]}
    for out in expect_v2["outputs"]:
        assert got_out[out["name"]]["shape"] == out["shape"] == [2, 3]
        np.testing.assert_allclose(got_out[out["name"]]["data"],
                                   out["data"], atol=FP32_ATOL, rtol=0)


@pytest.mark.slow
def test_resnet50_full_width_matches_jax():
    """resnet50 itself (224 px, 1000 classes) on randomized variables."""
    from kfserving_tpu.models import create_model as jax_create_model

    spec = jax_create_model("resnet50", dtype="float32")
    shapes = jax.eval_shape(lambda: spec.module.init(
        jax.random.PRNGKey(0), spec.example))
    variables = randomized(shapes, seed=2)
    x = _images(2, 224)
    expect = np.asarray(jax.jit(spec.module.apply)(variables, x))
    port_spec = create_model("resnet50", dtype="float32")
    model = weights.materialize(
        port_spec.module, torch.device("cpu"),
        state_dict=weights.resnet_params_from_flax(variables))
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, expect, atol=1e-3, rtol=1e-3)
