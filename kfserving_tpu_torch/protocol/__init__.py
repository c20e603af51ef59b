"""Inference protocols (V1 and V2 JSON)."""

from kfserving_tpu_torch.protocol.errors import (
    InferenceError,
    InvalidInput,
    ModelNotFound,
    ModelNotReady,
    ServingError,
)

__all__ = [
    "ServingError",
    "InvalidInput",
    "ModelNotFound",
    "ModelNotReady",
    "InferenceError",
]
