"""SDK client and CLI of the port (reference
python/kfserving/kfserving/api/kf_serving_client.py equivalent).

Port of ``kfserving_tpu/client``."""

from kfserving_tpu_torch.client.client import (
    ClientError,
    KFServingClient,
    isvc_spec,
)

__all__ = ["KFServingClient", "ClientError", "isvc_spec"]
