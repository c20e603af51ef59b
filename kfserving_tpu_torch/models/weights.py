"""Model weights: the JAX package's Flax checkpoints, and a seeded init.

- ``read_flax_msgpack(path)`` reads a ``checkpoint.msgpack`` as written by
  ``flax.serialization.to_bytes`` (the artifact the JAX package restores
  in ``kfserving_tpu/engine/param_cache.py``) into a nested dict of numpy
  arrays, without flax.  It imports ``msgpack`` only when called.
- ``bert_params_from_flax``, ``decoder_params_from_flax``,
  ``resnet_params_from_flax``, ``vit_params_from_flax`` and
  ``mlp_params_from_flax`` map a Flax variable tree onto the port's
  ``state_dict`` names (``FLAX_CONVERTERS`` by architecture): HWIO conv
  kernels become OIHW weights, ``batch_stats`` mean and var become
  BatchNorm buffers, DenseGeneral ``[in, H, D]`` and ``[H, D, out]``
  kernels become Linear weights.
- ``materialize(module, device, state_dict=None, seed=0)`` turns a
  meta-device module into one on ``device`` holding either those weights
  or a seeded random init (``torch.Generator``; it does not reproduce the
  JAX package's PRNG, so parity tests share one numpy tree instead).
  4-d (conv) weights are stored channels-last, the layout the image
  models run in.  ``allocate(module, device)`` gives the same layout
  unfilled, for a caller that copies the weights in itself.
"""

import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from kfserving_tpu_torch.models.bert import LayerNorm
from kfserving_tpu_torch.models.resnet import BatchNorm, Conv2d

# Flax's msgpack extension type codes (flax/serialization.py).
_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


def _ndarray_from_bytes(msgpack, data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        # numpy has no bfloat16: widen the raw bits to float32 exactly.
        bits = np.frombuffer(buffer, dtype=np.uint16).astype(np.uint32)
        arr = (bits << 16).view(np.float32)
    else:
        arr = np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode()))
    return arr.reshape(shape)


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED):
        shape = tuple(tree["shape"][str(i)]
                      for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)]
                  for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_flax_msgpack(path: str) -> Dict[str, Any]:
    """Nested dict of numpy arrays from a Flax ``to_bytes`` checkpoint."""
    try:
        import msgpack
    except ImportError as e:
        raise RuntimeError(
            f"reading {path} needs the 'msgpack' package, which is not "
            "installed; install it or serve without a checkpoint "
            "(seeded random init)") from e

    def ext_hook(code: int, data: bytes):
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(msgpack, data)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_bytes(msgpack, data)[()]
        if code == _EXT_COMPLEX:
            real, imag = msgpack.unpackb(data)
            return complex(real, imag)
        return msgpack.ExtType(code, data)

    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False)
    return _unchunk(tree)


class _StateDict:
    """Collects numpy state-dict entries from Flax leaves."""

    def __init__(self):
        self.sd: Dict[str, np.ndarray] = {}

    def put(self, name: str, arr) -> None:
        self.sd[name] = np.array(arr, dtype=np.float32)   # owned, writable

    def dense(self, name: str, src) -> None:              # Dense [in, out]
        self.put(f"{name}.weight", np.asarray(src["kernel"]).T)
        self.put(f"{name}.bias", src["bias"])

    def dense_in(self, name: str, src) -> None:           # [in, H, D]
        kernel = np.asarray(src["kernel"])
        self.put(f"{name}.weight", kernel.reshape(kernel.shape[0], -1).T)
        self.put(f"{name}.bias", np.asarray(src["bias"]).reshape(-1))

    def dense_out(self, name: str, src) -> None:          # [H, D, out]
        kernel = np.asarray(src["kernel"])
        self.put(f"{name}.weight", kernel.reshape(-1, kernel.shape[-1]).T)
        self.put(f"{name}.bias", src["bias"])

    def norm(self, name: str, src) -> None:
        self.put(f"{name}.weight", src["scale"])
        self.put(f"{name}.bias", src["bias"])

    def embedding(self, name: str, src) -> None:
        self.put(f"{name}.weight", src["embedding"])

    def conv(self, name: str, src) -> None:                # HWIO -> OIHW
        self.put(f"{name}.weight",
                 np.asarray(src["kernel"]).transpose(3, 2, 0, 1))
        if "bias" in src:
            self.put(f"{name}.bias", src["bias"])

    def batch_norm(self, name: str, src, stats) -> None:
        self.norm(name, src)
        self.put(f"{name}.mean", stats["mean"])
        self.put(f"{name}.var", stats["var"])


def bert_params_from_flax(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The port's BERT ``state_dict`` (numpy) from the JAX package's
    variables (``{"params": ...}`` or the params dict itself)."""
    p = tree.get("params", tree)
    out = _StateDict()
    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        out.embedding(name, p[name])
    out.norm("embeddings_norm", p["embeddings_norm"])
    i = 0
    while f"layer_{i}" in p:
        src, dst = p[f"layer_{i}"], f"layers.{i}"
        for proj in ("query", "key", "value"):
            out.dense_in(f"{dst}.attention.{proj}", src["attention"][proj])
        out.dense_out(f"{dst}.attention.out", src["attention"]["out"])
        out.norm(f"{dst}.attention_norm", src["attention_norm"])
        out.dense(f"{dst}.intermediate", src["intermediate"])
        out.dense(f"{dst}.output", src["output"])
        out.norm(f"{dst}.output_norm", src["output_norm"])
        i += 1
    out.dense("mlm_transform", p["mlm_transform"])
    out.norm("mlm_norm", p["mlm_norm"])
    out.put("mlm_bias", p["mlm_bias"])
    return out.sd


def decoder_params_from_flax(tree: Dict[str, Any]
                             ) -> Dict[str, np.ndarray]:
    """The port's ``DecoderLM`` ``state_dict`` (numpy) from the JAX
    package's decoder variables: ``wte``/``wpe`` tables, per layer
    ``attn_norm``, DenseGeneral ``query``/``key``/``value`` [in, H, D] and
    ``out`` [H, D, out], ``mlp_norm``, ``mlp_in``, ``mlp_out``, then
    ``final_norm``.  The LM head is ``wte`` itself (tied)."""
    p = tree.get("params", tree)
    out = _StateDict()
    out.embedding("wte", p["wte"])
    out.embedding("wpe", p["wpe"])
    i = 0
    while f"layer_{i}" in p:
        src, dst = p[f"layer_{i}"], f"layers.{i}"
        out.norm(f"{dst}.attn_norm", src["attn_norm"])
        for proj in ("query", "key", "value"):
            out.dense_in(f"{dst}.{proj}", src[proj])
        out.dense_out(f"{dst}.out", src["out"])
        out.norm(f"{dst}.mlp_norm", src["mlp_norm"])
        out.dense(f"{dst}.mlp_in", src["mlp_in"])
        out.dense(f"{dst}.mlp_out", src["mlp_out"])
        i += 1
    out.norm("final_norm", p["final_norm"])
    return out.sd


def resnet_params_from_flax(tree: Dict[str, Any]
                            ) -> Dict[str, np.ndarray]:
    """The port's ``ResNet`` ``state_dict`` (numpy) from the JAX
    package's ResNet variables (``params`` and ``batch_stats``):
    ``conv_init``/``bn_init``, then per ``BottleneckBlock_{i}`` the
    ``Conv_{0,1,2}``/``BatchNorm_{0,1,2}`` triple and, where the block
    projects, ``conv_proj``/``norm_proj``; then ``head``."""
    p, stats = tree["params"], tree["batch_stats"]
    out = _StateDict()
    out.conv("conv_init", p["conv_init"])
    out.batch_norm("bn_init", p["bn_init"], stats["bn_init"])
    i = 0
    while f"BottleneckBlock_{i}" in p:
        name = f"BottleneckBlock_{i}"
        src, bs, dst = p[name], stats[name], f"blocks.{i}"
        for j in range(3):
            out.conv(f"{dst}.conv{j + 1}", src[f"Conv_{j}"])
            out.batch_norm(f"{dst}.bn{j + 1}", src[f"BatchNorm_{j}"],
                           bs[f"BatchNorm_{j}"])
        if "conv_proj" in src:
            out.conv(f"{dst}.conv_proj", src["conv_proj"])
            out.batch_norm(f"{dst}.norm_proj", src["norm_proj"],
                           bs["norm_proj"])
        i += 1
    out.dense("head", p["head"])
    return out.sd


def vit_params_from_flax(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The port's ``ViT`` ``state_dict`` (numpy) from the JAX package's
    ViT variables: ``patch_embed`` (a conv with bias), ``cls_token``,
    ``pos_embed``, per ``block_{i}`` the DenseGeneral ``query``/``key``/
    ``value`` [in, H, D] and ``out`` [H, D, out] with ``norm1``,
    ``norm2``, ``mlp_in`` and ``mlp_out``; then ``final_norm`` and
    ``head``."""
    p = tree.get("params", tree)
    out = _StateDict()
    out.conv("patch_embed", p["patch_embed"])
    out.put("cls_token", p["cls_token"])
    out.put("pos_embed", p["pos_embed"])
    i = 0
    while f"block_{i}" in p:
        src, dst = p[f"block_{i}"], f"blocks.{i}"
        out.norm(f"{dst}.norm1", src["norm1"])
        for proj in ("query", "key", "value"):
            out.dense_in(f"{dst}.{proj}", src[proj])
        out.dense_out(f"{dst}.out", src["out"])
        out.norm(f"{dst}.norm2", src["norm2"])
        out.dense(f"{dst}.mlp_in", src["mlp_in"])
        out.dense(f"{dst}.mlp_out", src["mlp_out"])
        i += 1
    out.norm("final_norm", p["final_norm"])
    out.dense("head", p["head"])
    return out.sd


def mlp_params_from_flax(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The port's ``MLP`` ``state_dict`` (numpy): ``dense_{i}`` and
    ``head``, named as in Flax."""
    p = tree.get("params", tree)
    out = _StateDict()
    for name, src in p.items():
        out.dense(name, src)
    return out.sd


# Flax param tree -> port state_dict, by architecture.
FLAX_CONVERTERS: Dict[str, Callable[[Dict[str, Any]], Dict[str, np.ndarray]]] = {
    "bert": bert_params_from_flax,
    "bert_tiny": bert_params_from_flax,
    "decoder": decoder_params_from_flax,
    "decoder_tiny": decoder_params_from_flax,
    "resnet50": resnet_params_from_flax,
    "vit_b16": vit_params_from_flax,
    "vit_tiny": vit_params_from_flax,
    "mlp": mlp_params_from_flax,
}


# BatchNorm running statistics and affine terms drawn by seeded_init: wide
# enough that a wrong channel, a missing mean or a zero scale shows in the
# output, narrow enough that 16 random bottleneck blocks stay finite in bf16.
BN_SCALE_RANGE = (0.5, 1.0)
BN_SHIFT_STD = 0.1
BN_VAR_RANGE = (0.5, 1.5)
# Flax's init of ViT's position table (normal(0.02)); the CLS token uses it
# too rather than Flax's zeros, so its path carries signal.
TOKEN_STD = 0.02


@torch.no_grad()
def seeded_init(module: nn.Module, seed: int = 0) -> None:
    """Random weights from one seeded generator on the module's device:
    Linear and conv kernels N(0, 1/fan_in), embeddings N(0, 1/width),
    biases 0, LayerNorm scales 1; BatchNorm scale, shift, running mean and
    variance drawn from the ranges above; ``cls_token`` and
    ``pos_embed`` N(0, 0.02).  Every parameter and buffer is written: one
    this function does not know raises, since ``materialize`` allocates
    with ``to_empty`` and would otherwise serve uninitialized memory."""
    device = next(module.parameters()).device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    done = set()
    for prefix, sub in module.named_modules():
        own = dict(sub.named_parameters(recurse=False))
        own.update(sub.named_buffers(recurse=False))
        if isinstance(sub, (nn.Linear, Conv2d)):
            fan_in = sub.weight[0].numel()
            sub.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)
            if sub.bias is not None:
                sub.bias.zero_()
        elif isinstance(sub, nn.Embedding):
            sub.weight.normal_(0.0, 1.0 / math.sqrt(sub.embedding_dim),
                               generator=gen)
        elif isinstance(sub, LayerNorm):
            sub.weight.fill_(1.0)
            sub.bias.zero_()
        elif isinstance(sub, BatchNorm):
            sub.weight.uniform_(*BN_SCALE_RANGE, generator=gen)
            sub.bias.normal_(0.0, BN_SHIFT_STD, generator=gen)
            sub.mean.normal_(0.0, BN_SHIFT_STD, generator=gen)
            sub.var.uniform_(*BN_VAR_RANGE, generator=gen)
        else:
            for name, tensor in own.items():
                if name == "mlm_bias":
                    tensor.zero_()
                elif name in ("cls_token", "pos_embed"):
                    tensor.normal_(0.0, TOKEN_STD, generator=gen)
                else:
                    continue
                done.add(f"{prefix}.{name}" if prefix else name)
            continue
        done.update(f"{prefix}.{name}" if prefix else name for name in own)
    missing = [name for name in module.state_dict() if name not in done]
    if missing:
        raise ValueError(f"seeded_init does not know how to initialize "
                         f"{missing[:5]}; load a checkpoint instead")


def materialize(module: nn.Module, device: torch.device,
                state_dict: Optional[Dict[str, Any]] = None,
                seed: int = 0) -> nn.Module:
    """Allocate ``module`` on ``device`` and fill it: the given state dict
    of numpy arrays or CPU tensors (every key must match) or a seeded
    init.  Returns it in eval mode."""
    module = module.to_empty(device=device)
    if state_dict is None:
        seeded_init(module, seed)
    else:
        module.load_state_dict(
            {k: torch.as_tensor(v) for k, v in state_dict.items()},
            strict=True)
    return module.to(memory_format=torch.channels_last).eval()


def allocate(module: nn.Module, device: torch.device) -> nn.Module:
    """``module`` on ``device`` in the serving layout (4-d weights
    channels-last), eval mode, its memory left uninitialized: for a
    caller that copies every parameter and buffer in next
    (``TorchEngine.restore``)."""
    return module.to_empty(device=device).to(
        memory_format=torch.channels_last).eval()
