from kfserving_tpu_torch.predictors.torchserver.model import PyTorchModel

__all__ = ["PyTorchModel"]
