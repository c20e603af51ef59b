"""Checkpoint conversion: HF torch state dicts -> servable model dirs.

Port of ``kfserving_tpu/tools/convert.py``.  It maps HF-layout torch
state dicts tensor for tensor onto the model zoo's variable tree, and
writes that tree as a Flax ``checkpoint.msgpack`` with the port's own
writer (``models/weights.py::write_flax_msgpack``, the bytes
``flax.serialization.to_bytes`` writes), so one model dir serves on the
JAX package's ``JaxModel`` and on the port's ``TorchModel`` alike:

- BERT (HF BertForMaskedLM layout, `bert.*` / `cls.*` keys): q/k/v
  kernels fold to the DenseGeneral [H, heads, dH] layout, the MLM head
  keeps the tied-embedding decoder.  The emitted config sets
  gelu_approximate=false (HF "gelu" is erf-exact).
- ResNet-50 (HF ResNetForImageClassification layout, `resnet.*` /
  `classifier.*` keys): OIHW conv weights transpose to HWIO, BatchNorm
  running stats land in batch_stats.  The emitted config sets
  torch_padding=true (explicit pads, not SAME: a one-pixel shift
  otherwise).

CLI:
    python -m kfserving_tpu_torch.tools.convert --arch bert \
        --torch_checkpoint pytorch_model.bin --out_dir DIR \
        [--arch_kwargs JSON] [--config_extra JSON]

It prints one JSON line: the checkpoint's bytes and the milliseconds of
reading the state dict, mapping it and writing the directory.
"""

import argparse
import json
import os
import time
from typing import Any, Dict

import numpy as np
import torch

from kfserving_tpu_torch.engine.param_cache import CHECKPOINT_NAME
from kfserving_tpu_torch.models.weights import write_flax_msgpack


def _t(x) -> np.ndarray:
    """A state-dict entry (a torch tensor of any float dtype, or an
    array) -> float32 numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32)


# -- BERT ---------------------------------------------------------------------
def bert_params_from_torch(state_dict: Dict[str, Any],
                           num_heads: int) -> Dict[str, Any]:
    """HF BertForMaskedLM state dict -> models/bert.py variables."""
    sd = {k: _t(v) for k, v in state_dict.items()
          if not k.endswith("num_batches_tracked")}

    def ln(prefix):
        return {"scale": sd[f"{prefix}.weight"],
                "bias": sd[f"{prefix}.bias"]}

    hidden = sd["bert.embeddings.word_embeddings.weight"].shape[1]
    head_dim = hidden // num_heads
    params: Dict[str, Any] = {
        "word_embeddings": {
            "embedding": sd["bert.embeddings.word_embeddings.weight"]},
        "position_embeddings": {
            "embedding": sd["bert.embeddings.position_embeddings.weight"]},
        "token_type_embeddings": {
            "embedding": sd["bert.embeddings.token_type_embeddings.weight"]},
        "embeddings_norm": ln("bert.embeddings.LayerNorm"),
        "mlm_transform": {
            "kernel": sd["cls.predictions.transform.dense.weight"].T,
            "bias": sd["cls.predictions.transform.dense.bias"]},
        "mlm_norm": ln("cls.predictions.transform.LayerNorm"),
        "mlm_bias": sd["cls.predictions.bias"],
    }
    i = 0
    while f"bert.encoder.layer.{i}.attention.self.query.weight" in sd:
        p = f"bert.encoder.layer.{i}"
        att = {}
        for name in ("query", "key", "value"):
            w = sd[f"{p}.attention.self.{name}.weight"]  # [H, H] (out,in)
            b = sd[f"{p}.attention.self.{name}.bias"]
            att[name] = {
                "kernel": w.T.reshape(hidden, num_heads, head_dim),
                "bias": b.reshape(num_heads, head_dim)}
        wo = sd[f"{p}.attention.output.dense.weight"]    # [H, H]
        att["out"] = {
            "kernel": wo.T.reshape(num_heads, head_dim, hidden),
            "bias": sd[f"{p}.attention.output.dense.bias"]}
        params[f"layer_{i}"] = {
            "attention": att,
            "attention_norm": ln(f"{p}.attention.output.LayerNorm"),
            "intermediate": {
                "kernel": sd[f"{p}.intermediate.dense.weight"].T,
                "bias": sd[f"{p}.intermediate.dense.bias"]},
            "output": {
                "kernel": sd[f"{p}.output.dense.weight"].T,
                "bias": sd[f"{p}.output.dense.bias"]},
            "output_norm": ln(f"{p}.output.LayerNorm"),
        }
        i += 1
    if i == 0:
        raise ValueError(
            "no bert.encoder.layer.* keys found — is this an HF "
            "BertForMaskedLM state dict?")
    return {"params": params}


# -- ResNet-50 ----------------------------------------------------------------
def _conv(w: np.ndarray) -> np.ndarray:
    """OIHW -> HWIO."""
    return w.transpose(2, 3, 1, 0)


def resnet50_params_from_torch(state_dict: Dict[str, Any]
                               ) -> Dict[str, Any]:
    """HF ResNetForImageClassification state dict -> models/resnet.py
    variables (params + batch_stats)."""
    sd = {k: _t(v) for k, v in state_dict.items()
          if not k.endswith("num_batches_tracked")}

    def bn(prefix):
        return ({"scale": sd[f"{prefix}.weight"],
                 "bias": sd[f"{prefix}.bias"]},
                {"mean": sd[f"{prefix}.running_mean"],
                 "var": sd[f"{prefix}.running_var"]})

    emb = "resnet.embedder.embedder"
    if f"{emb}.convolution.weight" not in sd:
        raise ValueError(
            "no resnet.embedder.* keys found — is this an HF "
            "ResNetForImageClassification state dict?")
    bn_p, bn_s = bn(f"{emb}.normalization")
    params: Dict[str, Any] = {
        "conv_init": {"kernel": _conv(sd[f"{emb}.convolution.weight"])},
        "bn_init": bn_p,
        "head": {"kernel": sd["classifier.1.weight"].T,
                 "bias": sd["classifier.1.bias"]},
    }
    stats: Dict[str, Any] = {"bn_init": bn_s}

    block = 0
    stage = 0
    while f"resnet.encoder.stages.{stage}.layers.0.layer.0." \
          f"convolution.weight" in sd:
        layer = 0
        while (f"resnet.encoder.stages.{stage}.layers.{layer}.layer.0."
               f"convolution.weight") in sd:
            p = f"resnet.encoder.stages.{stage}.layers.{layer}"
            bp: Dict[str, Any] = {}
            bs: Dict[str, Any] = {}
            for c in range(3):
                bp[f"Conv_{c}"] = {"kernel": _conv(
                    sd[f"{p}.layer.{c}.convolution.weight"])}
                nb, ns = bn(f"{p}.layer.{c}.normalization")
                bp[f"BatchNorm_{c}"] = nb
                bs[f"BatchNorm_{c}"] = ns
            if f"{p}.shortcut.convolution.weight" in sd:
                bp["conv_proj"] = {"kernel": _conv(
                    sd[f"{p}.shortcut.convolution.weight"])}
                nb, ns = bn(f"{p}.shortcut.normalization")
                bp["norm_proj"] = nb
                bs["norm_proj"] = ns
            params[f"BottleneckBlock_{block}"] = bp
            stats[f"BottleneckBlock_{block}"] = bs
            block += 1
            layer += 1
        stage += 1
    return {"params": params, "batch_stats": stats}


# -- entry --------------------------------------------------------------------
CONVERTERS = {
    "bert": lambda sd, kw: bert_params_from_torch(
        sd, num_heads=kw.get("num_heads", 12)),
    "resnet50": lambda sd, kw: resnet50_params_from_torch(sd),
}


def convert(arch: str, state_dict: Dict[str, Any], out_dir: str,
            arch_kwargs: Dict[str, Any] = None,
            config_extra: Dict[str, Any] = None) -> str:
    """Write a servable model dir (config.json + checkpoint.msgpack)."""
    arch_kwargs = dict(arch_kwargs or {})
    if arch not in CONVERTERS:
        raise ValueError(
            f"no converter for {arch!r}; have {sorted(CONVERTERS)}")
    variables = CONVERTERS[arch](state_dict, arch_kwargs)
    # Geometry/activation flags that make the converted weights exact:
    if arch == "bert":
        arch_kwargs.setdefault("gelu_approximate", False)
    if arch == "resnet50":
        arch_kwargs.setdefault("torch_padding", True)
    os.makedirs(out_dir, exist_ok=True)
    cfg = {"architecture": arch, "arch_kwargs": arch_kwargs}
    cfg.update(config_extra or {})
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(cfg, f, indent=1)
    write_flax_msgpack(os.path.join(out_dir, CHECKPOINT_NAME), variables)
    return out_dir


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Convert a torch/HF checkpoint into a model dir "
                    "that the port's jaxserver serves")
    p.add_argument("--arch", required=True, choices=sorted(CONVERTERS))
    p.add_argument("--torch_checkpoint", required=True,
                   help="path to a torch state dict (torch.save)")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--arch_kwargs", default="{}", help="JSON dict")
    p.add_argument("--config_extra", default="{}",
                   help="JSON dict merged into config.json (batcher, "
                        "buckets, output mode, ...)")
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    state = torch.load(args.torch_checkpoint, map_location="cpu",
                       weights_only=True)
    t1 = time.perf_counter()
    convert(args.arch, state, args.out_dir,
            json.loads(args.arch_kwargs), json.loads(args.config_extra))
    t2 = time.perf_counter()
    print(json.dumps({
        "out_dir": args.out_dir,
        "checkpoint_bytes": os.path.getsize(
            os.path.join(args.out_dir, CHECKPOINT_NAME)),
        "read_ms": (t1 - t0) * 1e3, "convert_ms": (t2 - t1) * 1e3}),
        flush=True)


if __name__ == "__main__":
    main()
