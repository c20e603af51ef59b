from kfserving_tpu_torch.server.app import ModelServer

__all__ = ["ModelServer"]
