"""The port's checkpoint converter (``kfserving_tpu_torch/tools/convert.py``)
and its Flax checkpoint codec (``models/weights.py``: ``read_flax_msgpack``,
``write_flax_msgpack``, no msgpack package) against the JAX package's, on
the CPU.

Seeded HF-layout state dicts (a bert_tiny-sized BertForMaskedLM and a
reduced ResNetForImageClassification, every tensor drawn from numpy) go
through both converters: the checkpoints are byte for byte the same, the
decoded leaves bit for bit, and JaxModel and the port's TorchModel serve
each converted directory to the same outputs (fp32, ``SERVE_ATOL``).
BERT's logits hold against transformers' own forward.
"""

import asyncio
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from kfserving_tpu.models import registry as jax_registry
from kfserving_tpu.models.resnet import ResNet as JaxResNet
from kfserving_tpu.predictors.jax_model import JaxModel
from kfserving_tpu.tools import convert as jax_convert
from kfserving_tpu_torch.models import registry as port_registry
from kfserving_tpu_torch.models import weights
from kfserving_tpu_torch.models.resnet import ResNet
from kfserving_tpu_torch.predictors.torch_model import TorchModel
from kfserving_tpu_torch.tools import convert

# transformers would otherwise import TensorFlow (~10 s here) for the
# torch model classes these tests build.
os.environ.setdefault("USE_TF", "0")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fp32 served outputs of the same weights, XLA's CPU kernels against
# torch's.
SERVE_ATOL = 1e-4
# Our BERT against transformers' on the same weights (tests/test_convert.py).
HF_RTOL, HF_ATOL = 1e-3, 2e-3
BERT_KWARGS = {"vocab_size": 512, "hidden_size": 64, "num_layers": 2,
               "num_heads": 4, "intermediate_size": 128, "max_position": 64,
               "dtype": "float32"}
REDUCED = dict(stage_sizes=[1, 1, 1, 1], num_filters=8, num_classes=7)
IMAGE = 32


def _hf_bert_config():
    from transformers import BertConfig

    return BertConfig(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=128,
                      max_position_embeddings=64, type_vocab_size=2,
                      hidden_act="gelu", layer_norm_eps=1e-12)


def _seeded(module, seed):
    """Every float tensor of ``module``'s state dict drawn from numpy
    (BatchNorm variances positive), loaded back so tied weights agree;
    the state dict as the module then holds it."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, t in module.state_dict().items():
        if not t.is_floating_point():
            sd[name] = t
        elif name.endswith("running_var"):
            sd[name] = torch.from_numpy(
                rng.uniform(0.5, 1.5, t.shape).astype(np.float32))
        else:
            scale = 1.0 / np.sqrt(t[0].numel()) if t.dim() > 1 else 0.1
            sd[name] = torch.from_numpy(
                rng.normal(0.0, scale, t.shape).astype(np.float32))
    module.load_state_dict(sd)
    return {k: v.clone() for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def hf_bert():
    from transformers import BertForMaskedLM

    model = BertForMaskedLM(_hf_bert_config()).eval()
    return model, _seeded(model, seed=11)


@pytest.fixture(scope="module")
def hf_resnet():
    from transformers import ResNetConfig, ResNetForImageClassification

    model = ResNetForImageClassification(ResNetConfig(
        embedding_size=8, hidden_sizes=[32, 64, 128, 256],
        depths=[1, 1, 1, 1], layer_type="bottleneck",
        num_labels=7)).eval()
    return model, _seeded(model, seed=12)


def _jax_factory(dtype="float32", torch_padding=False):
    return (JaxResNet(**REDUCED, dtype=getattr(jnp, dtype),
                      torch_padding=torch_padding),
            jnp.zeros((1, IMAGE, IMAGE, 3), jnp.float32))


def _port_factory(dtype="float32", torch_padding=False):
    with torch.device("meta"):
        module = ResNet(**REDUCED, dtype=dtype, torch_padding=torch_padding,
                        image_size=IMAGE)
    return module, np.zeros((1, IMAGE, IMAGE, 3), np.float32)


@pytest.fixture
def resnet_reduced(monkeypatch):
    """The reduced ResNet under one architecture name in both packages."""
    arch = "resnet_reduced"
    monkeypatch.setitem(jax_registry._REGISTRY, arch, _jax_factory)
    monkeypatch.setitem(port_registry._REGISTRY, arch, _port_factory)
    monkeypatch.setitem(weights.FLAX_CONVERTERS, arch,
                        weights.resnet_params_from_flax)
    return arch


def _convert_both(arch, sd, root, arch_kwargs, config_extra):
    """Each package's converter into a directory of its own."""
    return {kind: module.convert(arch, sd, os.path.join(root, kind),
                                 arch_kwargs=dict(arch_kwargs),
                                 config_extra=dict(config_extra))
            for kind, module in (("jax", jax_convert), ("torch", convert))}


BERT_EXTRA = {"seq_buckets": [16], "batch_buckets": [1, 4],
              "max_batch_size": 4, "max_latency_ms": 2, "warmup": False}
RESNET_EXTRA = {"architecture": "resnet_reduced", "batch_buckets": [1, 4],
                "max_batch_size": 4, "max_latency_ms": 2, "warmup": False}


def _leaves_equal(a, b, path=""):
    if isinstance(b, dict):
        assert isinstance(a, dict) and list(a) == list(b), path
        for key in b:
            _leaves_equal(a[key], b[key], f"{path}/{key}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path


@pytest.mark.parametrize("which", ["bert", "resnet"])
def test_checkpoints_equal_the_jax_converters(tmp_path, hf_bert, hf_resnet,
                                              resnet_reduced, which):
    if which == "bert":
        dirs = _convert_both("bert", hf_bert[1], str(tmp_path),
                             {k: v for k, v in BERT_KWARGS.items()},
                             BERT_EXTRA)
    else:
        dirs = _convert_both("resnet50", hf_resnet[1], str(tmp_path),
                             {"dtype": "float32"}, RESNET_EXTRA)
    files = {k: open(os.path.join(d, "checkpoint.msgpack"), "rb").read()
             for k, d in dirs.items()}
    assert files["torch"] == files["jax"]
    configs = {k: json.load(open(os.path.join(d, "config.json")))
               for k, d in dirs.items()}
    assert configs["torch"] == configs["jax"]
    flag = "gelu_approximate" if which == "bert" else "torch_padding"
    assert configs["torch"]["arch_kwargs"][flag] is (which != "bert")
    _leaves_equal(weights.read_flax_msgpack(
        os.path.join(dirs["torch"], "checkpoint.msgpack")),
        serialization.msgpack_restore(files["jax"]))


async def _predict_all(model, bodies):
    return [await model.predict(body) for body in bodies]


@pytest.mark.parametrize("which", ["bert", "resnet"])
def test_both_servers_serve_a_converted_dir_alike(tmp_path, hf_bert,
                                                  hf_resnet, resnet_reduced,
                                                  which):
    rng = np.random.default_rng(5)
    if which == "bert":
        model_dir = convert.convert("bert", hf_bert[1], str(tmp_path / "b"),
                                    arch_kwargs=dict(BERT_KWARGS),
                                    config_extra=BERT_EXTRA)
        ids = rng.integers(1, 512, (3, 11))
        bodies = [{"instances": ids[i:i + 1].tolist()} for i in (1, 2)] + [

            {"inputs": [{"name": "input_ids", "shape": [1, 11],
                         "datatype": "INT32", "data": ids[0].tolist()}]}]
    else:
        model_dir = convert.convert(
            "resnet50", hf_resnet[1], str(tmp_path / "r"),
            arch_kwargs={"dtype": "float32"}, config_extra=RESNET_EXTRA)
        images = rng.uniform(0, 1, (3, IMAGE, IMAGE, 3)).astype(np.float32)
        bodies = [{"instances": images[i:i + 1].tolist()} for i in range(3)]
    name = os.path.basename(model_dir)
    jax_model = JaxModel(name, model_dir)
    jax_model.load()
    try:
        want = asyncio.run(_predict_all(jax_model, bodies))
    finally:
        jax_model.unload()
    port_model = TorchModel(name, model_dir, device="cpu")
    port_model.load()
    try:
        got = asyncio.run(_predict_all(port_model, bodies))
    finally:
        port_model.unload()
    assert port_model.param_source == "checkpoint"
    for g, w in zip(got, want):
        if "predictions" in w:
            np.testing.assert_allclose(np.asarray(g["predictions"]),
                                       np.asarray(w["predictions"]),
                                       atol=SERVE_ATOL, rtol=0)
        else:
            (go,), (wo,) = g["outputs"], w["outputs"]
            assert (go["name"], go["shape"], go["datatype"]) == \
                (wo["name"], wo["shape"], wo["datatype"])
            np.testing.assert_allclose(go["data"], wo["data"],
                                       atol=SERVE_ATOL, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_bert_logits_hold_against_transformers(tmp_path, hf_bert, masked):
    hf, sd = hf_bert
    model_dir = convert.convert("bert", sd, str(tmp_path / "b"),
                                arch_kwargs=dict(BERT_KWARGS))
    tree = weights.read_flax_msgpack(
        os.path.join(model_dir, "checkpoint.msgpack"))
    spec = port_registry.create_model("bert", **json.load(open(
        os.path.join(model_dir, "config.json")))["arch_kwargs"])
    module = weights.materialize(spec.module, torch.device("cpu"),
                                 weights.bert_params_from_flax(tree))
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(1, 512, (2, 12)))
    mask = torch.ones(2, 12, dtype=torch.int64)
    if masked:
        mask[:, 8:] = 0
    with torch.no_grad():
        expected = hf(ids, attention_mask=mask).logits.numpy()
        got = module(ids, attention_mask=mask).float().numpy()
    keep = 8 if masked else 12      # HF still computes padded positions
    np.testing.assert_allclose(got[:, :keep], expected[:, :keep],
                               rtol=HF_RTOL, atol=HF_ATOL)


def _jax_tree(seed=3):
    """A JAX-written variable tree: the reduced ResNet's params and
    batch_stats, every leaf drawn from numpy."""
    module, example = _jax_factory()
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                example))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: rng.normal(size=s.shape).astype(
        np.float32), shapes)


@pytest.mark.parametrize("chunk_bytes", [2 ** 30, 4096])
def test_decoder_equals_msgpack_and_the_flax_hook(monkeypatch, chunk_bytes):
    """JAX-written checkpoints, with leaves above ``chunk_bytes`` in
    Flax's chunked form (the 4096-byte case chunks most kernels)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk_bytes)
    tree = dict(_jax_tree(), extra={"scalar": np.float32(2.5),
                                    "half": np.arange(5, dtype=np.float16),
                                    "count": 7, "name": "resnet"})
    data = serialization.to_bytes(tree)
    want = msgpack.unpackb(data, ext_hook=serialization._msgpack_ext_unpack,
                           raw=False)
    chunked = "__msgpack_chunked_array__" in \
        want["params"]["BottleneckBlock_3"]["Conv_1"]["kernel"]
    assert chunked == (chunk_bytes == 4096)
    want = serialization._unchunk_array_leaves_in_place(want)
    got = weights.decode_flax_msgpack(data)
    _leaves_equal(got, want)
    assert got["extra"]["count"] == 7 and got["extra"]["name"] == "resnet"
    # A leaf of an unchunked checkpoint is a view of the buffer, no copy.
    if not chunked:
        leaf = got["params"]["head"]["kernel"]
        assert not leaf.flags.owndata and not leaf.flags.writeable


@pytest.mark.parametrize("chunk_bytes", [2 ** 30, 4096])
def test_writer_round_trips_through_flax(tmp_path, monkeypatch, chunk_bytes):
    monkeypatch.setattr(weights, "CHUNK_BYTES", chunk_bytes)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk_bytes)
    tree = _jax_tree(seed=4)
    path = str(tmp_path / "checkpoint.msgpack")
    size = weights.write_flax_msgpack(path, tree)
    data = open(path, "rb").read()
    assert size == len(data)
    assert data == serialization.to_bytes(tree)
    template = jax.tree.map(lambda a: np.zeros_like(a), tree)
    _leaves_equal(serialization.from_bytes(template, data), tree)
    _leaves_equal(weights.read_flax_msgpack(path), tree)
    # Scalar leaves, as a training state's step or learning rate.
    scalars = {"step": 7, "neg": -(2 ** 40), "lr": 0.5, "name": "resnet",
               "flag": True, "none": None, "scale": np.float32(2.0)}
    weights.write_flax_msgpack(path, scalars)
    assert open(path, "rb").read() == serialization.to_bytes(scalars)


@pytest.mark.parametrize("damage", ["truncated", "trailing", "empty",
                                    "bad_ext", "short_array", "not_a_map"])
def test_a_malformed_checkpoint_raises_and_never_inits(tmp_path, damage):
    """The loader raises on a damaged checkpoint, directly and through a
    served model's load; it never hands back a seeded init."""
    tree = {"params": {"head": {"kernel": np.ones((3, 2), np.float32),
                                "bias": np.zeros(2, np.float32)}}}
    data = serialization.to_bytes(tree)
    kernel = data.index(b"\xc4\x18") + 2        # the kernel's 24 bytes
    data = {"truncated": data[:-3], "trailing": data + b"\xc0",
            "empty": b"",
            "bad_ext": b"\x81\xa6params\xd4\x09\x00",   # ext type 9
            "short_array": data[:kernel - 2] + b"\xc4\x14" + data[kernel:],
            "not_a_map": b"\x92\x01\x02"}[damage]
    model_dir = tmp_path / "m"
    model_dir.mkdir()
    (model_dir / "checkpoint.msgpack").write_bytes(data)
    (model_dir / "config.json").write_text(json.dumps({
        "architecture": "mlp",
        "arch_kwargs": {"input_dim": 3, "features": [], "num_classes": 2},
        "warmup": False}))
    with pytest.raises(ValueError, match="malformed Flax checkpoint"):
        weights.read_flax_msgpack(str(model_dir / "checkpoint.msgpack"))
    model = TorchModel("m", str(model_dir), device="cpu")
    with pytest.raises(Exception, match="malformed Flax checkpoint"):
        model.load()
    assert not model.ready and model.param_source != "init"


def test_cli_converts_and_serves_without_msgpack_flax_or_transformers(
        tmp_path, hf_bert):
    """``python -m kfserving_tpu_torch.tools.convert`` on a ``.bin`` state
    dict, then the directory's load, in a process where msgpack, flax and
    transformers cannot be imported."""
    bin_path = str(tmp_path / "pytorch_model.bin")
    torch.save(hf_bert[1], bin_path)
    out_dir = str(tmp_path / "conv")
    code = (
        "import json, sys\n"
        "for name in ('msgpack', 'flax', 'transformers', 'jax'):\n"
        "    sys.modules[name] = None\n"
        "from kfserving_tpu_torch.tools import convert\n"
        f"convert.main(['--arch', 'bert', '--torch_checkpoint', {bin_path!r},"
        f" '--out_dir', {out_dir!r}, '--arch_kwargs', "
        f"{json.dumps(json.dumps(BERT_KWARGS))}, '--config_extra', "
        f"{json.dumps(json.dumps(BERT_EXTRA))}])\n"
        "from kfserving_tpu_torch.predictors.torch_model import TorchModel\n"
        f"m = TorchModel('b', {out_dir!r}, device='cpu')\n"
        "m.load()\n"
        "print(json.dumps({'source': m.param_source}))\n")
    env = dict(os.environ, KFS_PARAM_CACHE=str(tmp_path / "params"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report, loaded = (json.loads(line) for line in
                      proc.stdout.strip().splitlines()[-2:])
    assert report["out_dir"] == out_dir
    assert report["checkpoint_bytes"] == os.path.getsize(
        os.path.join(out_dir, "checkpoint.msgpack"))
    assert report["read_ms"] > 0 and report["convert_ms"] > 0
    assert loaded == {"source": "checkpoint"}
    jax_dir = jax_convert.convert("bert", hf_bert[1], str(tmp_path / "jax"),
                                  arch_kwargs=dict(BERT_KWARGS),
                                  config_extra=dict(BERT_EXTRA))
    assert open(os.path.join(out_dir, "checkpoint.msgpack"), "rb").read() \
        == open(os.path.join(jax_dir, "checkpoint.msgpack"), "rb").read()
