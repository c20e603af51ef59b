from kfserving_tpu_torch.model.model import Model
from kfserving_tpu_torch.model.repository import ModelRepository

__all__ = ["Model", "ModelRepository"]
