from kfserving_tpu_torch.predictors.lgbserver.model import LightGBMModel  # noqa: F401
