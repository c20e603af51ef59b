from kfserving_tpu_torch.predictors.pmmlserver.model import PMMLModel  # noqa: F401
