"""Model weights: the JAX package's Flax checkpoints, and a seeded init.

- ``read_flax_msgpack(path)`` reads a ``checkpoint.msgpack`` as written by
  ``flax.serialization.to_bytes`` (the artifact the JAX package restores
  in ``kfserving_tpu/engine/param_cache.py``) into a nested dict of numpy
  arrays, with neither flax nor the msgpack package: a decoder of the
  msgpack subset Flax writes maps the file and leaves each array a view
  of the mapping.  ``write_flax_msgpack(path, tree)`` writes the same
  bytes as ``to_bytes`` (``tools/convert.py``'s output).
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
import mmap
import os
import struct
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
# Flax splits an array leaf above this many bytes into flat chunks
# (flax.serialization.MAX_CHUNK_SIZE: msgpack caps one object at 2^31-1).
CHUNK_BYTES = 2 ** 30

# Fixed-size msgpack types: tag -> big-endian struct format.
_SCALARS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
            0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
# Length-prefixed types: tag -> (kind, length format).
_SIZED = {0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
          0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I"),
          0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
          0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
          0xde: ("map", ">H"), 0xdf: ("map", ">I")}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Decoder:
    """One msgpack object at a time from a buffer: the subset Flax's
    ``to_bytes`` writes (maps, arrays, str, bin, ints, floats, nil,
    bools and its three ext types).  An ndarray leaf is a numpy view of
    the buffer, not a copy; a malformed buffer raises ValueError."""

    def __init__(self, buf: memoryview, where: str):
        self.buf = buf
        self.pos = 0
        self.where = where

    def fail(self, what: str):
        raise ValueError(f"{self.where}: malformed Flax checkpoint at byte "
                         f"{self.pos}: {what}")

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            self.fail(f"{n} bytes needed, {len(self.buf) - self.pos} left")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def scalar(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        tag = self.take(1)[0]
        if tag <= 0x7f:
            return tag
        if tag >= 0xe0:
            return tag - 0x100
        if tag <= 0x8f:
            return self.map(tag & 0x0f)
        if tag <= 0x9f:
            return self.array(tag & 0x0f)
        if tag <= 0xbf:
            return self.str(tag & 0x1f)
        if tag in (0xc0, 0xc2, 0xc3):
            return {0xc0: None, 0xc2: False, 0xc3: True}[tag]
        if tag in _SCALARS:
            return self.scalar(_SCALARS[tag])
        if tag in _FIXEXT:
            code = self.scalar(">b")
            return self.ext(code, self.take(_FIXEXT[tag]))
        if tag not in _SIZED:
            self.fail(f"unknown msgpack type 0x{tag:02x}")
        kind, fmt = _SIZED[tag]
        n = self.scalar(fmt)
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "str":
            return self.str(n)
        if kind == "array":
            return self.array(n)
        if kind == "map":
            return self.map(n)
        code = self.scalar(">b")
        return self.ext(code, self.take(n))

    def str(self, n: int) -> str:
        try:
            return str(self.take(n), "utf-8")
        except UnicodeDecodeError as e:
            self.fail(f"bad UTF-8 in a string: {e}")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out

    def ext(self, code: int, data: memoryview) -> Any:
        inner, start = _Decoder(data, self.where), self.pos - len(data)
        try:
            if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
                arr = inner.ndarray()
                return arr[()] if code == _EXT_NPSCALAR else arr
            if code == _EXT_COMPLEX:
                real, imag = inner.obj()
                return complex(real, imag)
        except ValueError as e:
            raise ValueError(f"{e} (inside the ext object at byte "
                             f"{start})") from None
        self.fail(f"unknown ext type {code}")

    def ndarray(self) -> np.ndarray:
        """Flax's ndarray payload: the packed (shape, dtype name, bytes)
        triple, the bytes left where they lie."""
        if self.take(1)[0] != 0x93:
            self.fail("an ndarray payload is not a 3-element array")
        shape = self.obj()
        name = self.obj()
        tag = self.take(1)[0]
        if tag not in (0xc4, 0xc5, 0xc6) or not isinstance(name, str) \
                or not isinstance(shape, list):
            self.fail("an ndarray payload is not (shape, dtype, bin)")
        data = self.take(self.scalar(_SIZED[tag][1]))
        if self.pos != len(self.buf):
            self.fail("trailing bytes in an ndarray payload")
        bf16 = name == "bfloat16"
        try:
            dtype = np.dtype(np.uint16 if bf16 else name)
        except TypeError:
            self.fail(f"unknown dtype {name!r}")
        count = math.prod(shape)
        if len(data) != count * dtype.itemsize:
            self.fail(f"{len(data)} bytes for {shape} {name}")
        arr = np.frombuffer(data, dtype=dtype)
        if bf16:
            # numpy has no bfloat16: widen the raw bits to float32 exactly.
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
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


def decode_flax_msgpack(data, where: str = "checkpoint") -> Any:
    """The tree of a Flax ``to_bytes`` buffer (bytes, memoryview or
    mmap), chunked arrays joined; leaves are numpy views of ``data``."""
    decoder = _Decoder(memoryview(data).cast("B"), where)
    tree = decoder.obj()
    if decoder.pos != len(decoder.buf):
        decoder.fail("trailing bytes after the checkpoint's tree")
    return _unchunk(tree)


def read_flax_msgpack(path: str) -> Dict[str, Any]:
    """Nested dict of numpy arrays from a Flax ``to_bytes`` checkpoint.
    The file is mapped, not read: each leaf is a read-only view of the
    mapping (bfloat16 leaves and chunked arrays are copies)."""
    with open(path, "rb") as f:
        if os.fstat(f.fileno()).st_size == 0:
            raise ValueError(f"{path}: malformed Flax checkpoint: empty")
        mapped = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    tree = decode_flax_msgpack(mapped, path)
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: malformed Flax checkpoint: the top "
                         f"object is a {type(tree).__name__}, not a map")
    return tree


class _Encoder:
    """Writes msgpack as ``msgpack.packb(tree, default=<Flax's ext
    hook>, strict_types=True)`` does for a state dict (maps with string
    keys; arrays, numpy scalars, str, int, float, bool and None leaves),
    array bytes straight from each array's memory."""

    def __init__(self, out):
        self.out = out
        self.written = 0

    def put(self, data) -> None:
        self.out.write(data)
        self.written += memoryview(data).nbytes

    @staticmethod
    def head(n: int, fix: int, fix_max: int, tags) -> bytes:
        if n < fix_max:
            return bytes([fix | n])
        for tag, fmt in tags:
            if n < 1 << (8 * struct.calcsize(fmt)):
                return bytes([tag]) + struct.pack(fmt, n)
        raise ValueError(f"msgpack object of length {n} is too long")

    @staticmethod
    def sized(n: int, tags) -> bytes:
        return _Encoder.head(n, 0, 0, tags)

    @staticmethod
    def pack_int(v: int) -> bytes:
        if 0 <= v < 0x80 or -32 <= v < 0:
            return struct.pack(">b" if v < 0 else ">B", v)
        for tag, fmt, lo, hi in (
                (0xcc, ">B", 0, 1 << 8), (0xcd, ">H", 0, 1 << 16),
                (0xce, ">I", 0, 1 << 32), (0xcf, ">Q", 0, 1 << 64),
                (0xd0, ">b", -(1 << 7), 0), (0xd1, ">h", -(1 << 15), 0),
                (0xd2, ">i", -(1 << 31), 0), (0xd3, ">q", -(1 << 63), 0)):
            if lo <= v < hi:
                return bytes([tag]) + struct.pack(fmt, v)
        raise ValueError(f"integer {v} does not fit msgpack")

    @staticmethod
    def pack_str(s: str) -> bytes:
        data = s.encode("utf-8")
        return _Encoder.head(len(data), 0xa0, 32, (
            (0xd9, ">B"), (0xda, ">H"), (0xdb, ">I"))) + data

    @staticmethod
    def ndarray_head(arr: np.ndarray) -> bytes:
        """The ndarray payload up to its raw bytes: Flax's packed
        (shape, dtype name, bytes) triple."""
        shape = b"".join(_Encoder.pack_int(int(d)) for d in arr.shape)
        return (b"\x93" + _Encoder.head(len(arr.shape), 0x90, 16, (
            (0xdc, ">H"), (0xdd, ">I"))) + shape
            + _Encoder.pack_str(arr.dtype.name)
            + _Encoder.sized(arr.nbytes, (
                (0xc4, ">B"), (0xc5, ">H"), (0xc6, ">I"))))

    def ext_array(self, code: int, arr: np.ndarray) -> None:
        if arr.dtype.hasobject or arr.dtype.fields is not None:
            raise TypeError(f"cannot serialize a {arr.dtype} array")
        if not arr.flags.c_contiguous:
            arr = arr.copy(order="C")
        payload = self.ndarray_head(arr)
        n = len(payload) + arr.nbytes
        fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}.get(n)
        head = (bytes([fixed]) if fixed is not None else self.sized(
            n, ((0xc7, ">B"), (0xc8, ">H"), (0xc9, ">I"))))
        self.put(head + struct.pack(">b", code) + payload)
        if arr.nbytes:
            self.put(memoryview(arr.reshape(-1)).cast("B"))

    def obj(self, x: Any) -> None:
        if x is None:
            self.put(b"\xc0")
        elif type(x) is bool:
            self.put(b"\xc3" if x else b"\xc2")
        elif type(x) is int:
            self.put(self.pack_int(x))
        elif type(x) is float:
            self.put(b"\xcb" + struct.pack(">d", x))
        elif type(x) is str:
            self.put(self.pack_str(x))
        elif type(x) is dict:
            self.put(self.head(len(x), 0x80, 16, ((0xde, ">H"),
                                                  (0xdf, ">I"))))
            for key, value in x.items():
                self.obj(key)
                self.obj(value)
        elif isinstance(x, np.ndarray):
            self.ext_array(_EXT_NDARRAY, x)
        elif isinstance(x, np.generic):
            self.ext_array(_EXT_NPSCALAR, np.asarray(x))
        else:
            raise TypeError(f"cannot serialize {type(x).__name__} into a "
                            "Flax checkpoint")


def _chunk(arr: np.ndarray) -> Dict[str, Any]:
    """Flax's chunked form of an array above CHUNK_BYTES."""
    size = max(1, int(CHUNK_BYTES / arr.dtype.itemsize))
    flat = np.ascontiguousarray(arr).reshape(-1)
    return {_CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): flat[j:j + size] for i, j in
                       enumerate(range(0, flat.size, size))}}


def _state_dict(tree: Any) -> Any:
    """Flax's ``to_state_dict`` of plain containers: dict keys become
    strings, lists and tuples dicts keyed "0", "1", ...; then array
    leaves above CHUNK_BYTES are chunked."""
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        return {str(k): _state_dict(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.nbytes > CHUNK_BYTES:
        return _chunk(tree)
    return tree


def encode_flax_msgpack(tree: Any, out) -> int:
    """Write ``tree`` (nested dicts, lists and tuples of numpy arrays and
    Python scalars) to the binary file ``out`` byte for byte as Flax's
    ``to_bytes``;
    returns the bytes written."""
    encoder = _Encoder(out)
    encoder.obj(_state_dict(tree))
    return encoder.written


def write_flax_msgpack(path: str, tree: Any) -> int:
    """Write ``tree`` to ``path`` as ``flax.serialization.to_bytes``
    would (``from_bytes`` reads it back); returns the file's bytes."""
    with open(path, "wb") as f:
        return encode_flax_msgpack(tree, f)


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
