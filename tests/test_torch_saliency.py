"""The port's SaliencyExplainer against the JAX package's on one artifact,
the flash kernel's autograd Function against autograd of the plain
attention, and the explain routes over HTTP.  Everything runs on the
CPU, in fp32 (float64 for the attention gradient).

Each artifact is a config.json plus a Flax checkpoint of randomized
variables (``torch_parity.randomized``), read by both packages: mlp, the
reduced ResNet of ``test_torch_resnet`` (uint8 config with scale 1/255,
which both explainers apply to the fp32 batch in fp32) and vit_tiny
(L = 17, the attention through the dispatcher).
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
from torch_serving import arequest, write_artifact

from kfserving_tpu.explainers import SaliencyExplainer as JaxSaliency
from kfserving_tpu.models import create_model as jax_create_model
from kfserving_tpu.models import registry as jax_registry
from kfserving_tpu.models.mlp import create_mlp as jax_create_mlp
from kfserving_tpu.models.resnet import ResNet as JaxResNet
from kfserving_tpu_torch.engine.hbm import HBMManager
from kfserving_tpu_torch.engine.residency import ResidencyManager
from kfserving_tpu_torch.explainers import SaliencyExplainer
from kfserving_tpu_torch.models import registry as port_registry
from kfserving_tpu_torch.models import weights
from kfserving_tpu_torch.models.mlp import create_mlp as port_create_mlp
from kfserving_tpu_torch.models.resnet import ResNet
from kfserving_tpu_torch.observability.registry import REGISTRY
from kfserving_tpu_torch.ops import attention as torch_attention
from kfserving_tpu_torch.server.app import ModelServer

# fp32 gradients of the same function summed in another order: within
# 1e-4 of each other, relative to the map's largest magnitude.
RTOL = 1e-4
ATOL_SHARE = 1e-4
# The reduced ResNet of test_torch_resnet.
REDUCED = dict(stage_sizes=[1, 1, 1, 1], num_filters=8, num_classes=7)
MLP_KWARGS = {"input_dim": 6, "features": [16, 16], "num_classes": 4}


def _jax_mlp(**kwargs):
    """The JAX package's MLP in fp32 (its registry entry is bf16 only)."""
    from kfserving_tpu.models.mlp import MLP

    module, example = jax_create_mlp(**kwargs)
    return MLP(features=module.features, num_classes=module.num_classes,
               dtype=jnp.float32), example


def _port_mlp(**kwargs):
    return port_create_mlp(**kwargs, dtype="float32")


def _jax_resnet(dtype="float32", image_size=16):
    return JaxResNet(**REDUCED, dtype=getattr(jnp, dtype)), \
        jnp.zeros((1, image_size, image_size, 3), jnp.float32)


def _port_resnet(dtype="float32", image_size=16):
    with torch.device("meta"):
        module = ResNet(**REDUCED, dtype=dtype, image_size=image_size)
    return module, np.zeros((1, image_size, image_size, 3), np.float32)


@pytest.fixture(autouse=True)
def fp32_architectures(monkeypatch):
    """"mlp_f32" and "resnet_reduced" under one name on both sides."""
    for name, jax_factory, port_factory, convert in (
            ("mlp_f32", _jax_mlp, _port_mlp,
             weights.FLAX_CONVERTERS["mlp"]),
            ("resnet_reduced", _jax_resnet, _port_resnet,
             weights.resnet_params_from_flax)):
        monkeypatch.setitem(jax_registry._REGISTRY, name, jax_factory)
        monkeypatch.setitem(port_registry._REGISTRY, name, port_factory)
        monkeypatch.setitem(weights.FLAX_CONVERTERS, name, convert)


# name: (config, instances)
CASES = {
    "mlp": ({"architecture": "mlp_f32", "arch_kwargs": MLP_KWARGS},
            lambda rng: rng.normal(0, 1, (3, 6))),
    "resnet_reduced": ({"architecture": "resnet_reduced",
                        "arch_kwargs": {"dtype": "float32"},
                        "input_dtype": "uint8", "scale": 1 / 255.0,
                        "output": "topk", "topk": 3},
                       lambda rng: rng.integers(0, 256, (2, 16, 16, 3))),
    "vit_tiny": ({"architecture": "vit_tiny",
                  "arch_kwargs": {"dtype": "float32"}, "output": "argmax"},
                 lambda rng: rng.uniform(0, 1, (2, 32, 32, 3))),
}


def _artifact(root, name, seed=1):
    config, _ = CASES[name]
    config = dict(config, batch_buckets=[1, 4], max_batch_size=4,
                  max_latency_ms=2, warmup=False)
    model_dir = write_artifact(str(root), name, config)
    spec = jax_create_model(config["architecture"],
                            **config.get("arch_kwargs", {}))
    module, example = spec.module, spec.example
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                example))
    with open(os.path.join(model_dir, "checkpoint.msgpack"), "wb") as f:
        f.write(serialization.to_bytes(randomized(shapes, seed)))
    return model_dir


def _explain(model, instances):
    return asyncio.run(model.explain({"instances": instances.tolist()}))


def _maps(response):
    return np.stack([np.asarray(e["saliency"])
                     for e in response["explanations"]])


def _assert_close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_SHARE * np.abs(want).max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_saliency_matches_jax(tmp_path, name):
    """The same winning-logit gradient on the same checkpoint, in fp32;
    the JSON shape and the metadata's explainer alike."""
    model_dir = _artifact(tmp_path, name)
    instances = CASES[name][1](np.random.default_rng(2))
    ref = JaxSaliency(name, model_dir)
    port = SaliencyExplainer(name, model_dir, device="cpu")
    assert ref.load() and port.load()
    try:
        want, got = _explain(ref, instances), _explain(port, instances)
        assert [e["method"] for e in got["explanations"]] == \
            [e["method"] for e in want["explanations"]] == \
            ["gradient_saliency"] * len(instances)
        assert _maps(got).shape == instances.shape
        assert np.abs(_maps(got)).max() > 0
        _assert_close(_maps(got), _maps(want))
        assert port.metadata()["explainer"] == \
            ref.metadata()["explainer"] == "gradient_saliency"
        # The parameters stay outside autograd and inference mode.
        assert not any(p.requires_grad or p.is_inference()
                       for p in port.module.parameters())
    finally:
        port.unload()


def test_saliency_explainer_argmax_config(tmp_path):
    """Argmax serving output (ints, not differentiable): the explainer
    goes through the raw logits, as the JAX one does."""
    model_dir = write_artifact(str(tmp_path), "m", {
        "architecture": "mlp_f32", "output": "argmax", "warmup": False,
        "arch_kwargs": {"input_dim": 4, "features": [8], "num_classes": 3}})
    spec = jax_create_model("mlp_f32", input_dim=4, features=[8],
                            num_classes=3)
    shapes = jax.eval_shape(lambda: spec.module.init(
        jax.random.PRNGKey(0), spec.example))
    with open(os.path.join(model_dir, "checkpoint.msgpack"), "wb") as f:
        f.write(serialization.to_bytes(randomized(shapes, 0)))
    ref, port = JaxSaliency("m", model_dir), \
        SaliencyExplainer("m", model_dir, device="cpu")
    assert ref.load() and port.load()
    instances = np.ones((1, 4))
    got = _maps(_explain(port, instances))
    assert np.abs(got).sum() > 0
    _assert_close(got, _maps(_explain(ref, instances)))
    port.unload()


def test_token_id_model_raises_as_jax(tmp_path):
    """BERT takes token ids: the fp32 cast makes both explainers refuse
    with the JAX package's ValueError."""
    model_dir = write_artifact(str(tmp_path), "b", {
        "architecture": "bert_tiny", "seq_buckets": [16],
        "batch_buckets": [1], "warmup": False})
    errors = []
    for model in (JaxSaliency("b", model_dir),
                  SaliencyExplainer("b", model_dir, device="cpu")):
        model.load()
        with pytest.raises(ValueError) as e:
            _explain(model, np.array([[1, 2, 3, 4]]))
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def _lengths_case(causal: bool):
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (3, 7, 2, 8)))
               for _ in range(3))
    lengths = None if causal else torch.tensor([7, 3, 1], dtype=torch.int32)
    return q, k, v, lengths


@pytest.mark.parametrize("causal", [False, True])
def test_flash_grad_matches_plain_attention_autograd(causal):
    """float64: the Function's gradients equal autograd of the plain
    attention's forward with the same masking, and gradcheck holds its
    backward to finite differences of its forward (on the CPU the
    kernel's plain version)."""
    q, k, v, lengths = _lengths_case(causal)
    grad_out = torch.from_numpy(
        np.random.default_rng(4).normal(0, 1, q.shape))

    def grads(fn):
        ops = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*ops)
        return [out.detach()] + list(torch.autograd.grad(out, ops,
                                                         grad_out))

    mask = torch_attention._plain_mask(7, 7, causal, lengths, q.device)
    got = grads(lambda a, b, c: torch_attention.FlashAttentionGrad.apply(
        a, b, c, causal, lengths))
    want = grads(lambda a, b, c: torch_attention._torch_attention(
        a, b, c, mask))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-12)
    assert torch.autograd.gradcheck(
        lambda a, b, c: torch_attention.FlashAttentionGrad.apply(
            a, b, c, causal, lengths),
        [t.clone().requires_grad_() for t in (q, k, v)])


def test_flash_grad_row_without_keys_is_zero():
    """A row with no valid key is 0 in the kernel's forward: its
    operands get no gradient from it."""
    q, k, v, _ = _lengths_case(False)
    lengths = torch.tensor([0, 3, 7], dtype=torch.int32)
    ops = [t.clone().requires_grad_() for t in (q, k, v)]
    out = torch_attention.FlashAttentionGrad.apply(*ops, False, lengths)
    assert bool((out[0] == 0).all())
    out.sum().backward()
    assert all(bool((t.grad[0] == 0).all()) for t in ops)
    assert all(bool((t.grad[1:] != 0).any()) for t in ops)


def test_dispatcher_takes_the_function_under_grad(monkeypatch):
    """On the card the dispatcher wraps the kernel in the Function only
    when autograd records the call."""
    routed = []
    monkeypatch.setattr(torch_attention, "_on_card", lambda q: True)
    monkeypatch.setattr(torch_attention, "flash_attention",
                        lambda *a, **k: routed.append("kernel") or a[0])
    monkeypatch.setattr(torch_attention.FlashAttentionGrad, "apply",
                        lambda *a: routed.append("function") or a[0])
    q = torch.zeros((1, 8, 2, 16))
    torch_attention.dot_product_attention(q, q, q)
    torch_attention.dot_product_attention(q.requires_grad_(), q, q)
    with torch.no_grad():
        torch_attention.dot_product_attention(q, q, q)
    assert routed == ["kernel", "function", "kernel"]


def test_explain_routes_over_http(tmp_path):
    """Both explain routes of the port's server answer the JAX
    explainer's maps, count under verb "explain" and shed a spent
    budget with 504."""
    model_dir = _artifact(tmp_path, "mlp")
    instances = CASES["mlp"][1](np.random.default_rng(5))
    ref = JaxSaliency("r", model_dir)
    ref.load()
    want = _maps(_explain(ref, instances))
    port = SaliencyExplainer("r", model_dir, device="cpu")
    port.load()
    REGISTRY.reset()
    body = {"instances": instances.tolist()}

    async def drive():
        server = ModelServer(http_port=0)
        await server.start_async([port], host="127.0.0.1")
        try:
            out = []
            for path in ("/v1/models/r:explain", "/v2/models/r/explain"):
                status, _, raw = await arequest(server.http_port, "POST",
                                                path, body)
                assert status == 200, raw
                out.append(_maps(json.loads(raw)))
            status, _, _ = await arequest(
                server.http_port, "POST", "/v1/models/r:explain", body,
                headers={"x-request-timeout-ms": "0.001"})
            out.append(status)
            out.append((await arequest(server.http_port, "GET",
                                       "/metrics"))[2])
            return out
        finally:
            await server.stop_async()

    v1_maps, v2_maps, late, metrics = asyncio.run(drive())
    port.unload()
    _assert_close(v1_maps, want)
    _assert_close(v2_maps, want)
    assert late == 504
    counts = {line.rsplit(" ", 1)[0]: float(line.rsplit(" ", 1)[1])
              for line in metrics.decode().splitlines()
              if line.startswith("kfserving_tpu_request_total{")}
    assert counts == {
        'kfserving_tpu_request_total{model="r",status="200",'
        'verb="explain"}': 2,
        'kfserving_tpu_request_total{model="r",status="504",'
        'verb="explain"}': 1}


def test_gradients_survive_offload_and_restore(tmp_path):
    """A demand-paged explainer: its first explain cold-faults it, an
    eviction offloads it to its mmap host params, and the next explain
    faults it back and gives the same gradients; the restored parameters
    are neither inference tensors nor grad-requiring."""
    model_dir = _artifact(tmp_path, "vit_tiny")
    instances = CASES["vit_tiny"][1](np.random.default_rng(6))
    hbm = HBMManager(budget_bytes=10 ** 9)
    residency = ResidencyManager(hbm)
    model = SaliencyExplainer("v", model_dir, device="cpu", hbm=hbm,
                              residency=residency)
    try:
        model.register()
        assert residency.state_of("v") == "registered"
        before = _maps(_explain(model, instances))
        assert residency.state_of("v") == "resident" and model.offloadable
        assert residency._victim_ok("v")
        hbm.release("v")
        residency._evict("v")
        assert residency.state_of("v") == "host"
        assert all(p.numel() == 0 for p in model.module.parameters())
        after = _maps(_explain(model, instances))
        assert residency.state_of("v") == "resident"
        np.testing.assert_array_equal(after, before)
        assert not any(p.requires_grad or p.is_inference()
                       for p in model.module.parameters())
    finally:
        model.unload()
        residency.close()
