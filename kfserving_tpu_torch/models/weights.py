"""Model weights: the JAX package's Flax checkpoints, and a seeded init.

- ``read_flax_msgpack(path)`` reads a ``checkpoint.msgpack`` as written by
  ``flax.serialization.to_bytes`` (the artifact the JAX package restores
  in ``kfserving_tpu/engine/param_cache.py``) into a nested dict of numpy
  arrays, without flax.  It imports ``msgpack`` only when called.
- ``bert_params_from_flax(tree)`` and ``decoder_params_from_flax(tree)``
  map a BERT or decoder Flax param tree onto the port's ``state_dict``
  names (``FLAX_CONVERTERS`` by architecture).
- ``materialize(module, device, state_dict=None, seed=0)`` turns a
  meta-device module into one on ``device`` holding either those weights
  or a seeded random init (``torch.Generator``; it does not reproduce the
  JAX package's PRNG, so parity tests share one numpy tree instead).
"""

import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

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


# Flax param tree -> port state_dict, by architecture.
FLAX_CONVERTERS: Dict[str, Callable[[Dict[str, Any]], Dict[str, np.ndarray]]] = {
    "bert": bert_params_from_flax,
    "bert_tiny": bert_params_from_flax,
    "decoder": decoder_params_from_flax,
    "decoder_tiny": decoder_params_from_flax,
}


@torch.no_grad()
def seeded_init(module: nn.Module, seed: int = 0) -> None:
    """Random weights from one seeded generator on the module's device:
    Linear kernels N(0, 1/fan_in), embeddings N(0, 1/width), biases 0,
    norm scales 1."""
    device = next(module.parameters()).device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for sub in module.modules():
        if isinstance(sub, nn.Linear):
            sub.weight.normal_(0.0, 1.0 / math.sqrt(sub.in_features),
                               generator=gen)
            if sub.bias is not None:
                sub.bias.zero_()
        elif isinstance(sub, nn.Embedding):
            sub.weight.normal_(0.0, 1.0 / math.sqrt(sub.embedding_dim),
                               generator=gen)
    for name, param in module.named_parameters(recurse=True):
        if name.endswith("norm.weight"):
            param.fill_(1.0)
        elif name.endswith("norm.bias") or name == "mlm_bias":
            param.zero_()


def materialize(module: nn.Module, device: torch.device,
                state_dict: Optional[Dict[str, np.ndarray]] = None,
                seed: int = 0) -> nn.Module:
    """Allocate ``module`` on ``device`` and fill it: the given state dict
    (every key must match) or a seeded init.  Returns it in eval mode."""
    module = module.to_empty(device=device)
    if state_dict is None:
        seeded_init(module, seed)
    else:
        module.load_state_dict(
            {k: torch.from_numpy(v) for k, v in state_dict.items()},
            strict=True)
    return module.eval()
