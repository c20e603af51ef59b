"""Parity of the port's BERT (kfserving_tpu_torch.models.bert) with the JAX
package's, on shared weights, and the Flax checkpoint reader.

Weights come from the JAX package's ``init_params(spec, seed)`` and reach
the port through ``bert_params_from_flax``; token ids and masks come from
numpy with a fixed seed.  Both sides run on the CPU.
"""

import os

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from kfserving_tpu.models import create_model as jax_create_model
from kfserving_tpu.models import init_params
from kfserving_tpu_torch.models import create_model
from kfserving_tpu_torch.models import weights
from kfserving_tpu_torch.models.bert import BertConfig, as_torch_dtype

# fp32: both sides compute in float32; summation order differs.
FP32_ATOL = 1e-4
# bf16: both sides round activations to bf16 after every dense layer
# (8 mantissa bits), in different places across 4 layers; logits are
# O(1) and compared at a few bf16 ulps of that.
BF16_ATOL = 0.15


def _jax_variables(dtype: str, seed: int = 0):
    spec = jax_create_model("bert_tiny", dtype=dtype)
    return spec, jax.tree_util.tree_map(np.asarray, init_params(spec, seed))


@pytest.fixture(scope="module")
def fp32_variables():
    return _jax_variables("float32")[1]


def _inputs(B=3, L=32, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 1024, size=(B, L)).astype(np.int32)
    lengths = [L, 19, 7][:B]
    mask = (np.arange(L)[None, :] < np.asarray(lengths)[:, None])
    return ids, mask.astype(np.int32), lengths


def _port_model(variables, dtype: str):
    spec = create_model("bert_tiny", dtype=dtype)
    sd = weights.bert_params_from_flax(variables)
    return weights.materialize(spec.module, torch.device("cpu"),
                               state_dict=sd)


@pytest.mark.parametrize("dtype,atol", [("float32", FP32_ATOL),
                                        ("bfloat16", BF16_ATOL)])
def test_bert_tiny_logits_match_jax(fp32_variables, dtype, atol):
    # Flax keeps fp32 params for a bf16 compute dtype: one init serves both.
    variables = fp32_variables
    spec = jax_create_model("bert_tiny", dtype=dtype)
    ids, mask, lengths = _inputs()
    expect = np.asarray(jax.jit(spec.module.apply)(
        variables, input_ids=ids, attention_mask=mask))
    model = _port_model(variables, dtype)
    with torch.inference_mode():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert got.dtype == np.float32 and got.shape == expect.shape
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(got[b, :n], expect[b, :n], atol=atol,
                                   rtol=0)


def test_state_dict_covers_every_parameter(fp32_variables):
    variables = fp32_variables
    sd = weights.bert_params_from_flax(variables)
    module = create_model("bert_tiny").module
    assert set(sd) == set(module.state_dict())
    for name, tensor in module.state_dict().items():
        assert tuple(sd[name].shape) == tuple(tensor.shape), name
    # DenseGeneral [in, H, D] -> Linear weight [H*D, in]
    kernel = variables["params"]["layer_0"]["attention"]["query"]["kernel"]
    np.testing.assert_array_equal(
        sd["layers.0.attention.query.weight"],
        kernel.reshape(kernel.shape[0], -1).T)


def test_checkpoint_msgpack_round_trip(tmp_path, fp32_variables):
    variables = fp32_variables
    path = os.path.join(str(tmp_path), "checkpoint.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(variables))
    tree = weights.read_flax_msgpack(path)
    flat_expect = jax.tree_util.tree_leaves_with_path(variables)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert len(flat_got) == len(flat_expect)
    for key, leaf in flat_expect:
        np.testing.assert_array_equal(flat_got[key], leaf)


def test_checkpoint_reader_bf16_and_chunked_leaves(tmp_path, monkeypatch):
    """bfloat16 leaves widen exactly to float32 (no ml_dtypes), and
    leaves Flax splits into chunks come back whole."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    big = rng.normal(size=(64, 16)).astype(np.float32)
    half = np.asarray(jnp.asarray(rng.normal(size=(8,)), jnp.bfloat16))
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 1024)
    path = os.path.join(str(tmp_path), "checkpoint.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(
            {"params": {"big": big, "half": half}}))
    tree = weights.read_flax_msgpack(path)["params"]
    np.testing.assert_array_equal(tree["big"], big)
    assert tree["half"].dtype == np.float32
    np.testing.assert_array_equal(tree["half"], half.astype(np.float32))


def test_checkpoint_reader_without_msgpack(tmp_path, monkeypatch):
    """The reader needs no msgpack package: a Flax checkpoint reads, leaf
    for leaf, with the package's import blocked."""
    import sys

    from flax import serialization

    tree = {"params": {"dense": {
        "kernel": np.arange(6, dtype=np.float32).reshape(2, 3),
        "bias": np.ones(3, np.float32)}}}
    path = os.path.join(str(tmp_path), "checkpoint.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(tree))
    monkeypatch.setitem(sys.modules, "msgpack", None)
    got = weights.read_flax_msgpack(path)["params"]["dense"]
    for name, want in tree["params"]["dense"].items():
        assert got[name].dtype == want.dtype
        np.testing.assert_array_equal(got[name], want)


def test_seeded_init_is_deterministic():
    def make(seed):
        spec = create_model("bert_tiny", dtype="float32", num_layers=1)
        return weights.materialize(spec.module, torch.device("cpu"),
                                   seed=seed).state_dict()

    a, b, c = make(3), make(3), make(4)
    for name in a:
        assert torch.equal(a[name], b[name]), name
    assert not torch.equal(a["word_embeddings.weight"],
                           c["word_embeddings.weight"])
    assert torch.equal(a["layers.0.attention_norm.weight"],
                       torch.ones(128))


def test_config_dtype_names():
    assert BertConfig(dtype="float32").dtype == torch.float32
    assert as_torch_dtype(torch.bfloat16) is torch.bfloat16
    with pytest.raises(ValueError, match="unsupported dtype"):
        as_torch_dtype("int8")


def test_flops_counts_dense_and_attention():
    module = create_model("bert_tiny").module
    cfg = module.config
    one = module.flops(1, 32)
    assert module.flops(2, 32) == 2 * one
    attention = 4 * 32 * 32 * cfg.hidden_size * cfg.num_layers
    assert module.flops(1, 64) - 2 * one == 2 * attention
