from kfserving_tpu_torch.batching.batcher import (
    BatchResult,
    BatchSizeMismatch,
    DynamicBatcher,
)

__all__ = ["BatchResult", "BatchSizeMismatch", "DynamicBatcher"]
