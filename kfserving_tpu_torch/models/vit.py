"""ViT-B/16 — the transformer->predictor chain's image model.

Port of ``kfserving_tpu/models/vit.py`` (BASELINE.json config #5): a conv
patch embedding (stride = patch, VALID, with bias), a CLS token and a
learned position table of h*w + 1 rows, pre-norm encoder blocks
(LayerNorm epsilon 1e-6, as Flax's default; tanh-approximate GELU) and an
fp32 head on token 0.

Attention sees [B, L, H, D] tensors with no mask and goes through the
port's ``dot_product_attention``, so on the card every block launches the
flash kernel at L = (image / patch)^2 + 1 (197 for ViT-B/16 at 224 px).
``attn_fn`` replaces it, as in BERT.  The wire is NHWC, as for ResNet.
"""

from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kfserving_tpu_torch.models.bert import (
    LayerNorm,
    as_torch_dtype,
    row_parallel,
)
from kfserving_tpu_torch.models.resnet import Conv2d
from kfserving_tpu_torch.ops import dot_product_attention

# Flax nn.LayerNorm's default epsilon.
LAYER_NORM_EPS = 1e-6


class ViTConfig:
    def __init__(self, image_size=224, patch_size=16, hidden_size=768,
                 num_layers=12, num_heads=12, intermediate_size=3072,
                 num_classes=1000, dtype=torch.bfloat16, attn_fn=None):
        self.image_size = image_size
        self.patch_size = patch_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.num_classes = num_classes
        self.dtype = as_torch_dtype(dtype)
        # Pluggable attention (q, k, v, mask) -> out over [B, L, H, D];
        # mask is always None here.
        self.attn_fn = attn_fn
        # Set by parallel/sharding.py::shard_module under a tp mesh (the
        # out and mlp_out projections all-reduce over it).
        self.tp_group = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def seq_len(self) -> int:
        """Tokens per image: the patches and the CLS token."""
        return (self.image_size // self.patch_size) ** 2 + 1


class EncoderBlock(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        h, dt = cfg.hidden_size, cfg.dtype
        self.norm1 = LayerNorm(h, LAYER_NORM_EPS)
        self.query = nn.Linear(h, h, dtype=dt)
        self.key = nn.Linear(h, h, dtype=dt)
        self.value = nn.Linear(h, h, dtype=dt)
        self.out = nn.Linear(h, h, dtype=dt)
        self.norm2 = LayerNorm(h, LAYER_NORM_EPS)
        self.mlp_in = nn.Linear(h, cfg.intermediate_size, dtype=dt)
        self.mlp_out = nn.Linear(cfg.intermediate_size, h, dtype=dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, L, _ = x.shape
        heads = (B, L, -1, cfg.head_dim)            # this rank's heads
        y = self.norm1(x)
        q = self.query(y).view(heads)
        k = self.key(y).view(heads)
        v = self.value(y).view(heads)
        if cfg.attn_fn is not None:
            attn = cfg.attn_fn(q, k, v, None)
        else:
            attn = dot_product_attention(q, k, v)
        x = x + row_parallel(self.out, attn.reshape(B, L, -1), cfg.tp_group)
        y = F.gelu(self.mlp_in(self.norm2(x)), approximate="tanh")
        return x + row_parallel(self.mlp_out, y, cfg.tp_group)


class ViT(nn.Module):
    """Images [B, H, W, 3] -> class logits [B, num_classes] (fp32)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.config = cfg
        h = cfg.hidden_size
        self.patch_embed = Conv2d(3, h, cfg.patch_size, cfg.patch_size,
                                  "VALID", bias=True, dtype=cfg.dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, h))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.seq_len, h))
        self.blocks = nn.ModuleList(
            EncoderBlock(cfg) for _ in range(cfg.num_layers))
        self.final_norm = LayerNorm(h, LAYER_NORM_EPS)
        self.head = nn.Linear(h, cfg.num_classes, dtype=torch.float32)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        x = images.to(cfg.dtype).permute(0, 3, 1, 2)    # channels-last NCHW
        x = self.patch_embed(x)                           # [B, C, h, w]
        B = x.shape[0]
        x = x.flatten(2).transpose(1, 2)                  # [B, h*w, C]
        cls = self.cls_token.to(cfg.dtype).expand(B, -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(cfg.dtype)
        for block in self.blocks:
            x = block(x)
        x = self.final_norm(x)
        return self.head(x[:, 0].float())

    def flops(self, batch: int, seq=None) -> float:
        """Multiply-add operations (x2) of one forward; the sequence
        length is fixed by the config."""
        cfg = self.config
        h, i, L = cfg.hidden_size, cfg.intermediate_size, cfg.seq_len
        patches = (L - 1) * 3 * cfg.patch_size ** 2 * h
        per_token = cfg.num_layers * (4 * h * h + 2 * h * i)
        attention = cfg.num_layers * 2 * L * L * h
        macs = patches + L * per_token + attention + h * cfg.num_classes
        return float(2 * batch * macs)


def vit_b16(**overrides) -> ViTConfig:
    return ViTConfig(**overrides)


def vit_tiny(**overrides) -> ViTConfig:
    """2-layer/64-wide config (head dim 16) for hermetic CPU tests."""
    defaults = dict(image_size=32, patch_size=8, hidden_size=64,
                    num_layers=2, num_heads=4, intermediate_size=128,
                    num_classes=10)
    defaults.update(overrides)
    return ViTConfig(**defaults)


def create_vit(config: Optional[ViTConfig] = None):
    """Returns (module on the meta device, example input [1, H, W, 3])."""
    cfg = config or vit_b16()
    with torch.device("meta"):
        module = ViT(cfg)
    size = cfg.image_size
    return module, np.zeros((1, size, size, 3), np.float32)


def _create_vit_b16(**kw: Any):
    """Registry factory: 'vit_b16'."""
    return create_vit(vit_b16(**kw))


def _create_vit_tiny(**kw: Any):
    """Registry factory: 'vit_tiny'."""
    return create_vit(vit_tiny(**kw))
