"""The port's mmap param cache (``kfserving_tpu_torch/engine/param_cache.py``)
on the CPU, held against the JAX package's (``kfserving_tpu/engine/
param_cache.py``): the on-disk layout, bf16 without ``ml_dtypes``,
corruption and the disabled cache, the content key, entries the JAX
package wrote, and a ``TorchModel`` that loads through the cache.

Mirrors ``tests/test_lifecycle.py``'s param-cache cases.  Tolerances:
stored and mapped bytes are compared bit for bit, and so are the answers
of two port models; the served top-k of the port against the JAX
package's ``JaxModel`` (the catalog MLP, bf16 on both sides) within 0.02
(one bf16 layer whose output is rounded at other places; logits are
O(1)), indices equal but for a swap of two scores within twice that.
"""

import asyncio
import inspect
import json
import os
import warnings

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization
from torch_parity import randomized

from kfserving_tpu.engine import param_cache as jax_cache
from kfserving_tpu.models import create_model as jax_create_model
from kfserving_tpu.predictors.jax_model import JaxModel
from kfserving_tpu_torch.engine import param_cache
from kfserving_tpu_torch.models import create_model
from kfserving_tpu_torch.observability import metrics as obs
from kfserving_tpu_torch.predictors.torch_model import TorchModel

MLP_KWARGS = {"input_dim": 32, "features": [64], "num_classes": 8}
BF16_ATOL = 0.02


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def test_roundtrip_mixed_dtypes_bit_for_bit():
    """A state dict and a nested tree of fp32, bf16, fp64, int32 and
    bool tensors come back as CPU tensors over the map, bit for bit, in
    4096-aligned leaves, writable and with no warning."""
    gen = torch.Generator().manual_seed(0)
    tree = {
        "dense_0.weight": torch.randn(3, 4, generator=gen),
        "dense_0.bias": torch.randn(4, generator=gen).to(torch.bfloat16),
        "stats": {"mean": torch.zeros(3, dtype=torch.float64),
                  "count": torch.arange(5, dtype=torch.int32),
                  "mask": torch.tensor([True, False])},
        "conv.weight": torch.randn(2, 3, 3, 3, generator=gen).to(
            memory_format=torch.channels_last),
    }
    key = param_cache.content_key("mlp", {"features": [8]})
    assert param_cache.store(key, tree)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = param_cache.load(key)
    assert out is not None
    for path, expect in [
            (("dense_0.weight",), tree["dense_0.weight"]),
            (("dense_0.bias",), tree["dense_0.bias"]),
            (("conv.weight",), tree["conv.weight"]),
            (("stats", "mean"), tree["stats"]["mean"]),
            (("stats", "count"), tree["stats"]["count"]),
            (("stats", "mask"), tree["stats"]["mask"])]:
        got = out
        for part in path:
            got = got[part]
        assert got.dtype == expect.dtype and got.shape == expect.shape
        assert got.device.type == "cpu" and got.is_contiguous()
        assert got.data_ptr() % 4096 == 0
        np.testing.assert_array_equal(_bits(got), _bits(expect.contiguous()))
    out["dense_0.weight"].add_(1.0)            # copy-on-write: the file
    again = param_cache.load(key)              # keeps the stored bytes
    np.testing.assert_array_equal(again["dense_0.weight"].numpy(),
                                  tree["dense_0.weight"].numpy())
    with open(os.path.join(param_cache.cache_dir(), key,
                           param_cache.MANIFEST_NAME)) as f:
        manifest = json.load(f)
    assert manifest["version"] == param_cache.MANIFEST_VERSION == 1
    leaves = {tuple(leaf["path"]): leaf for leaf in manifest["leaves"]}
    assert leaves[("dense_0.bias",)]["dtype"] == "bfloat16"
    assert all(leaf["offset"] % 4096 == 0 for leaf in leaves.values())


def _cache_counts():
    family = obs.param_cache_total()
    return {k: family.labels(outcome=k).value
            for k in ("hit", "miss", "store", "error")}


def test_miss_corruption_and_disable(monkeypatch):
    tree = {"w": torch.ones(8)}
    key = param_cache.content_key("mlp", {})
    counts = _cache_counts()
    assert param_cache.load(key) is None                     # miss
    assert param_cache.store(key, tree)
    entry = os.path.join(param_cache.cache_dir(), key)
    with open(os.path.join(entry, param_cache.MANIFEST_NAME), "w") as f:
        f.write("{not json")
    assert param_cache.load(key) is None                     # corrupt
    assert not os.path.exists(entry)                         # deleted
    # A params.bin shorter than its manifest says is corrupt too.
    assert param_cache.store(key, tree)
    with open(os.path.join(entry, param_cache.DATA_NAME), "r+b") as f:
        f.truncate(8)
    assert param_cache.load(key) is None and not os.path.exists(entry)
    after = _cache_counts()
    assert {k: after[k] - counts[k] for k in counts} == \
        {"hit": 0, "miss": 1, "store": 2, "error": 2}
    for off in ("0", "off"):
        monkeypatch.setenv(param_cache.ENV_VAR, off)
        assert param_cache.cache_dir() is None
        assert not param_cache.store(key, tree)
        assert param_cache.load(key) is None
    monkeypatch.delenv(param_cache.ENV_VAR)
    assert param_cache.cache_dir() == param_cache.DEFAULT_CACHE_DIR
    assert param_cache.DEFAULT_CACHE_DIR.endswith(
        os.path.join(".cache", "kfserving_tpu_torch", "params"))


def test_key_follows_checkpoint_digest(tmp_path):
    ck = tmp_path / "checkpoint.msgpack"
    ck.write_bytes(b"weights-v1")
    d1 = param_cache.file_digest(str(ck))
    assert d1 == jax_cache.file_digest(str(ck))
    k1 = param_cache.content_key("mlp", {"a": 1}, 0, d1)
    assert k1 == param_cache.content_key("mlp", {"a": 1}, 0, d1)
    ck.write_bytes(b"weights-v2")
    assert param_cache.content_key(
        "mlp", {"a": 1}, 0, param_cache.file_digest(str(ck))) != k1
    assert param_cache.content_key("mlp", {"a": 2}, 0, d1) != k1
    assert param_cache.content_key("mlp", {"a": 1}, 7, d1) != k1
    # A seeded init keys the device whose generator drew it.
    assert param_cache.content_key("mlp", {}, init_device="cpu") != \
        param_cache.content_key("mlp", {}, init_device="cuda")
    # So does the port's converter and init code.
    assert param_cache.content_key("mlp", {"a": 1}, 0, d1, code="a") != \
        param_cache.content_key("mlp", {"a": 1}, 0, d1, code="b")
    (tmp_path / "checkpoint.msgpack.sha256").write_text(
        "cafebabe  checkpoint.msgpack\n")
    assert param_cache.file_digest(str(ck)) == "cafebabe"


@pytest.mark.parametrize("digest", [None, "cafebabe"])
def test_key_differs_from_the_jax_package(digest):
    """The layout term: a JAX entry (a Flax tree) and a port entry (a
    torch state dict) never share a key, even in one directory."""
    args = ("bert_tiny", {"seq_len": 16}, 0, digest)
    assert param_cache.content_key(*args) != jax_cache.content_key(*args)
    assert len(param_cache.content_key(*args)) == \
        len(jax_cache.content_key(*args)) == 24


def test_reads_an_entry_the_jax_package_wrote():
    """The JAX package's store (ml_dtypes bf16, nested Flax tree); the
    port's load reads it leaf for leaf with no ml_dtypes."""
    tree = {
        "params": {"Dense_0": {
            "kernel": np.arange(12, dtype=np.float32).reshape(3, 4),
            "bias": np.linspace(-2, 2, 7).astype(ml_dtypes.bfloat16)}},
        "batch_stats": {"mean": np.linspace(0, 1, 3),
                        "steps": np.arange(4, dtype=np.int32)},
    }
    key = jax_cache.content_key("mlp", {"features": [8]})
    assert jax_cache.store(key, tree)
    out = param_cache.load(key)
    assert out is not None
    kernel = out["params"]["Dense_0"]["kernel"]
    assert kernel.dtype == torch.float32
    np.testing.assert_array_equal(kernel.numpy(),
                                  tree["params"]["Dense_0"]["kernel"])
    bias = out["params"]["Dense_0"]["bias"]
    assert bias.dtype == torch.bfloat16 and bias.shape == (7,)
    np.testing.assert_array_equal(
        bias.view(torch.int16).numpy().view(np.uint16),
        tree["params"]["Dense_0"]["bias"].view(np.uint16))
    np.testing.assert_array_equal(out["batch_stats"]["mean"].numpy(),
                                  tree["batch_stats"]["mean"])
    np.testing.assert_array_equal(out["batch_stats"]["steps"].numpy(),
                                  tree["batch_stats"]["steps"])
    # And the other way: the JAX loader reads a port entry's bf16.
    port_key = param_cache.content_key("mlp", {})
    w = torch.randn(5).to(torch.bfloat16)
    assert param_cache.store(port_key, {"w": w})
    back = jax_cache.load(port_key)["w"]
    assert back.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(back.view(np.uint16),
                                  w.view(torch.int16).numpy().view(np.uint16))


def _write_artifact(root, with_checkpoint: bool, seed: int = 2) -> str:
    model_dir = os.path.join(str(root), "mlp")
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump({"architecture": "mlp", "arch_kwargs": MLP_KWARGS,
                   "max_latency_ms": 2, "warmup": False, "output": "topk",
                   "topk": 3}, f)
    if with_checkpoint:
        spec = jax_create_model("mlp", **MLP_KWARGS)
        shapes = jax.eval_shape(lambda: spec.module.init(
            jax.random.PRNGKey(0), spec.example))
        with open(os.path.join(model_dir, "checkpoint.msgpack"), "wb") as f:
            f.write(serialization.to_bytes(randomized(shapes, seed)))
    return model_dir


def _predict(model, x):
    return asyncio.run(model.predict({"instances": x.tolist()}))


def test_second_load_maps_and_serves_bit_for_bit(tmp_path):
    """No checkpoint: the first load is a seeded init that is stored; the
    second maps it (param_source "mmap") and serves the same bits."""
    model_dir = _write_artifact(tmp_path, with_checkpoint=False)
    x = np.random.default_rng(0).normal(size=(3, 32)).astype(np.float32)
    first = TorchModel("m", model_dir, device="cpu")
    first.load()
    second = TorchModel("m", model_dir, device="cpu")
    second.load()
    try:
        assert first.param_source == "init"
        assert second.param_source == "mmap"
        assert second.engine_stats()["param_source"] == "mmap"
        assert first.engine.offloadable and second.engine.offloadable
        assert _predict(first, x) == _predict(second, x)
        for (name, a), (_, b) in zip(first.module.state_dict().items(),
                                     second.module.state_dict().items()):
            assert torch.equal(a, b), name
    finally:
        first.unload()
        second.unload()


def test_a_change_to_the_converter_code_misses(tmp_path, monkeypatch):
    """An entry holds what the port's converters and init made: once
    their source changes, the same artifact no longer hits the old entry
    and is materialized anew."""
    from kfserving_tpu_torch.models import weights

    model_dir = _write_artifact(tmp_path, with_checkpoint=True)
    sources = []
    for _ in range(2):
        model = TorchModel("m", model_dir, device="cpu")
        model.load()
        sources.append(model.param_source)
        model.unload()
    assert sources == ["checkpoint", "mmap"]
    spec = create_model("mlp", **MLP_KWARGS)
    before = param_cache.code_digest(spec.module)
    weights_file = inspect.getsourcefile(weights)
    read = param_cache._read_source
    monkeypatch.setattr(
        param_cache, "_read_source",
        lambda path: read(path) + (b"# fixed" if path == weights_file
                                   else b""))
    assert param_cache.code_digest(spec.module) != before
    model = TorchModel("m", model_dir, device="cpu")
    model.load()
    try:
        assert model.param_source == "checkpoint"
    finally:
        model.unload()


def test_mmap_load_matches_the_jax_model(tmp_path):
    """One checkpoint artifact: the port's first load converts and stores
    it, the second maps it; both serve the JAX package's JaxModel top-k
    (the limits above), and each other's bit for bit."""
    model_dir = _write_artifact(tmp_path, with_checkpoint=True)
    x = np.random.default_rng(1).normal(size=(4, 32)).astype(np.float32)
    jax_model = JaxModel("m", model_dir)
    jax_model.load()
    try:
        expect = _predict(jax_model, x)["predictions"]
    finally:
        jax_model.unload()
    served = []
    for source in ("checkpoint", "mmap"):
        model = TorchModel("m", model_dir, device="cpu")
        model.load()
        try:
            assert model.param_source == source
            served.append(_predict(model, x)["predictions"])
        finally:
            model.unload()
    assert served[0] == served[1]
    for got, want in zip(served[1], expect):
        np.testing.assert_allclose(got["values"], want["values"],
                                   atol=BF16_ATOL, rtol=0)
        for j, (a, b) in enumerate(zip(got["indices"], want["indices"])):
            if a != b:     # only a near-tie may swap
                gaps = np.abs(np.asarray(want["values"]) - want["values"][j])
                assert sorted(gaps)[1] <= 2 * BF16_ATOL


def test_disabled_cache_loads_without_a_host_source(tmp_path, monkeypatch):
    monkeypatch.setenv(param_cache.ENV_VAR, "off")
    model_dir = _write_artifact(tmp_path, with_checkpoint=False)
    model = TorchModel("m", model_dir, device="cpu")
    model.load()
    try:
        assert model.param_source == "init"
        assert not model.offloadable
        assert model.host_bytes() == model.engine.param_bytes() > 0
    finally:
        model.unload()


# The generative target's load (predictors/llm.py), as the JAX one: through
# load_or_materialize, so a second load maps the first's parameters.
GEN_ARCH = {"num_layers": 2, "hidden_size": 64, "num_heads": 2,
            "intermediate_size": 128, "max_seq": 64, "vocab_size": 384}
GEN_CONFIG = {"architecture": "decoder_tiny", "arch_kwargs": GEN_ARCH,
              "max_slots": 2, "max_seq": 64, "prefill_buckets": [16, 64],
              "max_new_tokens": 6, "tokenizer": "byte"}


def _cache_outcomes(registry_family):
    return sorted((labels["outcome"], child.value)
                  for labels, child in registry_family.samples())


@pytest.mark.parametrize("with_checkpoint", [False, True])
def test_generative_second_load_maps_the_target_as_jax(tmp_path, monkeypatch,
                                                       with_checkpoint):
    """Two GenerativeModel.load calls in one KFS_PARAM_CACHE report the
    param_source and cache outcomes that two direct calls of the JAX
    param_cache.load_or_materialize give for the same arch (init or
    checkpoint, then mmap; one store, one hit), and both models generate
    the same greedy tokens."""
    from kfserving_tpu.observability import REGISTRY as JAX_REGISTRY
    from kfserving_tpu.observability import metrics as jax_obs
    from kfserving_tpu_torch.observability import REGISTRY
    from kfserving_tpu_torch.predictors.llm import GenerativeModel

    model_dir = tmp_path / "gen"
    model_dir.mkdir()
    (model_dir / "config.json").write_text(json.dumps(GEN_CONFIG))
    if with_checkpoint:
        spec = jax_create_model("decoder_tiny", **GEN_ARCH)
        shapes = jax.eval_shape(lambda: spec.module.init(
            jax.random.PRNGKey(0), spec.example))
        (model_dir / "checkpoint.msgpack").write_bytes(
            serialization.to_bytes(randomized(shapes, 3)))

    monkeypatch.setenv("KFS_PARAM_CACHE", str(tmp_path / "jax-cache"))
    JAX_REGISTRY.reset()
    jax_spec = jax_create_model("decoder_tiny", **GEN_ARCH)
    want = [jax_cache.load_or_materialize(
        "decoder_tiny", GEN_ARCH, jax_spec, str(model_dir))[1]
        for _ in range(2)]
    want_outcomes = _cache_outcomes(jax_obs.param_cache_total())

    monkeypatch.setenv("KFS_PARAM_CACHE", str(tmp_path / "port-cache"))
    REGISTRY.reset()
    models = [GenerativeModel("gen", str(model_dir), device="cpu")
              for _ in range(2)]
    try:
        for model in models:
            model.load()
        got = [model.param_source for model in models]
        got_outcomes = _cache_outcomes(obs.param_cache_total())

        async def generate(model):
            return await model.generate({
                "text_input": "hello port",
                "parameters": {"max_tokens": 6, "temperature": 0.0}})

        answers = [asyncio.run(generate(model)) for model in models]
    finally:
        for model in models:
            model.unload()
    assert got == want == [
        "checkpoint" if with_checkpoint else "init", "mmap"]
    assert got_outcomes == want_outcomes
    assert answers[0]["text_output"] == answers[1]["text_output"]
    assert answers[0]["details"]["token_count"] == 6
