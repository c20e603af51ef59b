"""ResNet v1.5 — the flagship image-classification predictor.

Port of ``kfserving_tpu/models/resnet.py`` (BASELINE.json config #2,
"jaxserver ResNet-50 image classify (dynamic batch)"): bottleneck blocks
with the stride on the 3x3, a projection shortcut where the shape changes,
BatchNorm on running averages (epsilon 1e-5), a global average pool and an
fp32 head.  Same kwargs: ``stage_sizes``, ``num_classes``, ``num_filters``,
``dtype`` and ``torch_padding``.

- The wire is NHWC.  ``permute(0, 3, 1, 2)`` of an NHWC tensor is an NCHW
  view in channels-last memory, and the conv weights are stored
  channels-last too (``models/weights.py``), so cuDNN runs every conv
  channels-last with no layout copy.  The JAX package left its convs to
  XLA, outside any Pallas kernel; here they go to cuDNN.
- Padding follows Flax.  ``"SAME"`` (the default) is TensorFlow's rule:
  at stride 2 on an even size the extra pixel goes bottom/right, which
  torch's symmetric ``padding=`` cannot express, so such convs pad
  explicitly (7x7/2 on 224: (2, 3); 3x3/2 on 56: (0, 1)) and the 3x3/2
  max pool pads with -inf.  ``torch_padding=True`` is the symmetric
  (3, 3)/(1, 1) geometry of torch-trained checkpoints with a padded max
  pool.
- Convs, BatchNorm and ReLU run in the compute dtype (bf16 by default;
  BatchNorm computes in fp32 from fp32 statistics and rounds, as Flax
  does); the pooled features are rounded to it before the fp32 head.
"""

import math
from typing import Any, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kfserving_tpu_torch.models.bert import as_torch_dtype


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TensorFlow "SAME" padding of one spatial axis: (before, after),
    the odd pixel after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Module):
    """A Flax ``nn.Conv`` over an NCHW (channels-last) tensor.

    padding: "SAME" (TensorFlow's rule, computed per input size), "VALID",
    or an int p for a symmetric (p, p) pad."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 stride: int = 1, padding: Any = "SAME", bias: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.kernel, self.stride, self.padding = kernel, stride, padding
        self.weight = nn.Parameter(torch.empty(
            (out_ch, in_ch, kernel, kernel), dtype=dtype))
        self.bias = (nn.Parameter(torch.zeros(out_ch, dtype=dtype))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = 0 if self.padding == "VALID" else self.padding
        if self.padding == "SAME":
            top, bottom = same_padding(x.shape[2], self.kernel, self.stride)
            left, right = same_padding(x.shape[3], self.kernel, self.stride)
            if (top, left) == (bottom, right):
                pad = (top, left)
            else:
                x = F.pad(x, (left, right, top, bottom))
                pad = 0
        return F.conv2d(x, self.weight, self.bias, self.stride, pad)


class BatchNorm(nn.Module):
    """Inference BatchNorm: scale (``weight``), ``bias`` and the running
    ``mean`` and ``var``, all fp32, epsilon 1e-5 (Flax's setting here).
    It keeps no ``num_batches_tracked``, so a state dict made from a Flax
    checkpoint loads strictly."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.mean, self.var, self.weight, self.bias,
                            False, 0.0, self.eps)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1, with a 1x1 projection shortcut where
    the shape changes."""

    def __init__(self, in_ch: int, filters: int, stride: int, pad3: Any,
                 dtype: torch.dtype):
        super().__init__()
        self.conv1 = Conv2d(in_ch, filters, 1, dtype=dtype)
        self.bn1 = BatchNorm(filters)
        self.conv2 = Conv2d(filters, filters, 3, stride, pad3, dtype=dtype)
        self.bn2 = BatchNorm(filters)
        self.conv3 = Conv2d(filters, filters * 4, 1, dtype=dtype)
        self.bn3 = BatchNorm(filters * 4)
        self.project = stride != 1 or in_ch != filters * 4
        if self.project:
            self.conv_proj = Conv2d(in_ch, filters * 4, 1, stride,
                                    dtype=dtype)
            self.norm_proj = BatchNorm(filters * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = self.norm_proj(self.conv_proj(x)) if self.project else x
        return F.relu(residual + y)


class ResNet(nn.Module):
    """Images [B, H, W, 3] -> logits [B, num_classes] (fp32).
    ``stage_sizes`` [3, 4, 6, 3] is ResNet-50."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 num_filters: int = 64, dtype: Any = torch.bfloat16,
                 torch_padding: bool = False, image_size: int = 224):
        super().__init__()
        self.dtype = as_torch_dtype(dtype)
        self.stage_sizes = list(stage_sizes)
        self.num_filters = num_filters
        self.torch_padding = torch_padding
        self.image_size = image_size    # flops() counts at this size
        pad7 = 3 if torch_padding else "SAME"
        pad3 = 1 if torch_padding else "SAME"
        self.conv_init = Conv2d(3, num_filters, 7, 2, pad7, dtype=self.dtype)
        self.bn_init = BatchNorm(num_filters)
        blocks, in_ch = [], num_filters
        for i, count in enumerate(self.stage_sizes):
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(BottleneckBlock(in_ch, num_filters * 2 ** i,
                                              stride, pad3, self.dtype))
                in_ch = num_filters * 2 ** i * 4
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(in_ch, num_classes, dtype=torch.float32)

    def _max_pool(self, x: torch.Tensor) -> torch.Tensor:
        if self.torch_padding:
            return F.max_pool2d(x, 3, 2, padding=1)
        top, bottom = same_padding(x.shape[2], 3, 2)
        left, right = same_padding(x.shape[3], 3, 2)
        x = F.pad(x, (left, right, top, bottom), value=-math.inf)
        return F.max_pool2d(x, 3, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)    # channels-last NCHW
        x = F.relu(self.bn_init(self.conv_init(x)))
        x = self._max_pool(x)
        for block in self.blocks:
            x = block(x)
        pooled = x.float().mean(dim=(2, 3)).to(self.dtype)
        return self.head(pooled.float())

    def flops(self, batch: int, seq=None) -> float:
        """Multiply-add operations (x2) of the convs and the head for
        ``batch`` images at ``image_size``; no sequence axis.  Every
        stride-s layer gives ceil(size / s) in both paddings."""
        size = -(-self.image_size // 2)
        macs = size * size * 3 * self.num_filters * 49
        size = -(-size // 2)                             # max pool
        for block in self.blocks:
            f = block.conv2.weight.shape[0]
            in_ch = block.conv1.weight.shape[1]
            macs += size * size * in_ch * f                  # conv1
            size = -(-size // block.conv2.stride)
            macs += size * size * (9 * f * f + 4 * f * f)    # conv2, conv3
            if block.project:
                macs += size * size * in_ch * 4 * f
        macs += self.head.in_features * self.head.out_features
        return float(2 * batch * macs)


def create_resnet50(num_classes: int = 1000, image_size: int = 224,
                    dtype: Any = torch.bfloat16,
                    torch_padding: bool = False):
    """Registry factory 'resnet50': (module on the meta device, example
    input [1, H, W, 3])."""
    with torch.device("meta"):
        module = ResNet([3, 4, 6, 3], num_classes=num_classes, dtype=dtype,
                        torch_padding=torch_padding, image_size=image_size)
    return module, np.zeros((1, image_size, image_size, 3), np.float32)
