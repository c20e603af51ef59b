"""Model artifact storage of the port (``Storage.download``)."""

from kfserving_tpu_torch.storage.storage import Storage

__all__ = ["Storage"]
