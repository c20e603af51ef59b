from kfserving_tpu_torch.ops.attention import dot_product_attention
from kfserving_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
)

__all__ = ["dot_product_attention", "flash_attention",
           "flash_attention_plain"]
