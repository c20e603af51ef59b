from kfserving_tpu_torch.predictors.xgbserver.model import XGBoostModel  # noqa: F401
