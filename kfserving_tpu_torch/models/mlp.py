"""Small MLPs for multi-model serving.

Port of ``kfserving_tpu/models/mlp.py`` (BASELINE.json config #4,
"multi-model serving: 8 small Flax MLPs hot-swapped"): flatten each
instance, then ``Dense -> relu`` per hidden width in the compute dtype
(bf16 by default) and an fp32 head.  The state-dict names follow the Flax
modules (``dense_{i}``, ``head``) so ``models/weights.py`` maps a
checkpoint one to one.
"""

from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kfserving_tpu_torch.models.bert import as_torch_dtype


class MLP(nn.Module):
    """Inputs [B, ...] -> logits [B, num_classes] (fp32)."""

    def __init__(self, input_dim: int, features: Sequence[int],
                 num_classes: int = 10, dtype: Any = torch.bfloat16):
        super().__init__()
        self.dtype = as_torch_dtype(dtype)
        widths = [input_dim] + list(features)
        self.depth = len(features)
        for i in range(self.depth):
            self.add_module(f"dense_{i}", nn.Linear(
                widths[i], widths[i + 1], dtype=self.dtype))
        self.head = nn.Linear(widths[-1], num_classes, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).reshape(x.shape[0], -1)
        for i in range(self.depth):
            x = F.relu(getattr(self, f"dense_{i}")(x))
        return self.head(x.float())

    def flops(self, batch: int, seq=None) -> float:
        """Multiply-add operations (x2) of one forward; no sequence axis."""
        macs = sum(m.in_features * m.out_features
                   for m in self.modules() if isinstance(m, nn.Linear))
        return float(2 * batch * macs)


def create_mlp(input_dim: int = 64, features: Sequence[int] = (256, 256),
               num_classes: int = 10, dtype: Any = torch.bfloat16):
    """Registry factory 'mlp': (module on the meta device, example
    input [1, input_dim])."""
    with torch.device("meta"):
        module = MLP(input_dim, tuple(features), num_classes, dtype)
    return module, np.zeros((1, input_dim), np.float32)
